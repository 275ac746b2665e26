"""Pallas-Triton kernel: tiled integer (min,+) pairwise reduction.

The reference computes step 2 with n synchronous one-query-per-launch
kernels (/root/reference/main.cu:327-335, kernels.h:85-109). Here the
whole [S, S2] min-sum matrix is one launch over a 2-D grid of output
tiles:

  program (i, j) owns out[i*BM:(i+1)*BM, j*BN:(j+1)*BN] and walks every
  bin b inside the program, loading one [BM] row slice of the transposed
  counts and one [BN] slice of the transposed partner counts and adding
  min(a[:, None], c[None, :]) into a [BM, BN] register accumulator.

Each loaded element is reused BN (or BM) times, where XLA's reduction
fusion (ops/distance.min_sum_block) re-reads both operands for every
output. There is no tensor-core form of (min,+): the work is int32
min + add on the CUDA cores.

``triangle=True`` (symmetric all-pairs) skips the work of every program
whose tile lies strictly below the diagonal; the wrapper mirrors the
upper triangle.

Integer in, integer out: the float distance formula is applied downstream
by ops.distance.finish_distances for bit-exact parity (SURVEY.md §2.4.4).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

#: output tile rows / columns and bins unrolled per loop step; num_warps
#: and num_stages of the Triton launch (chosen by scripts/kernel_timings.py
#: on the card — see PERF.md).
BM = 64
BN = 128
BK = 16
NUM_WARPS = 4
NUM_STAGES = 3


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _min_sum_kernel(at_ref, ct_ref, out_ref, *, bm, bn, bk, triangle):
    i = pl.program_id(0)
    j = pl.program_id(1)
    rows = pl.ds(pl.multiple_of(i * bm, bm), bm)
    cols = pl.ds(pl.multiple_of(j * bn, bn), bn)
    n_chunks = at_ref.shape[0] // bk

    def compute():
        def chunk(c, acc):
            for u in range(bk):  # static unroll of bk bins
                b = c * bk + u
                a = plgpu.load(at_ref.at[b, rows])
                o = plgpu.load(ct_ref.at[b, cols])
                acc = acc + jnp.minimum(a[:, None], o[None, :])
            return acc

        acc = jax.lax.fori_loop(
            0, n_chunks, chunk, jnp.zeros((bm, bn), jnp.int32)
        )
        plgpu.store(out_ref.at[rows, cols], acc)

    if triangle:
        # The tile holds an entry on or above the diagonal iff its last
        # column reaches its first row; tiles wholly below it store zeros
        # (the wrapper overwrites them with the mirror).
        upper = (j + 1) * bn > i * bm
        pl.when(upper)(compute)

        @pl.when(jnp.logical_not(upper))
        def _():
            plgpu.store(out_ref.at[rows, cols], jnp.zeros((bm, bn), jnp.int32))

    else:
        compute()


@functools.partial(
    jax.jit,
    static_argnames=(
        "triangle", "interpret", "bm", "bn", "bk", "num_warps", "num_stages"
    ),
)
def _min_sum_call(
    counts, other, *, triangle, interpret, bm, bn, bk, num_warps, num_stages
):
    S, B = counts.shape
    S2 = other.shape[0]
    Sp = _round_up(max(S, 1), bm)
    S2p = _round_up(max(S2, 1), bn)
    Bp = _round_up(max(B, 1), bk)
    # Zero padding is exact: padded bins add min(., 0) = 0 (counts are
    # non-negative) and padded rows/columns are sliced off below.
    at = jnp.pad(counts.astype(jnp.int32), ((0, Sp - S), (0, Bp - B))).T
    ct = jnp.pad(other.astype(jnp.int32), ((0, S2p - S2), (0, Bp - B))).T
    out = pl.pallas_call(
        functools.partial(
            _min_sum_kernel, bm=bm, bn=bn, bk=bk, triangle=triangle
        ),
        out_shape=jax.ShapeDtypeStruct((Sp, S2p), jnp.int32),
        grid=(Sp // bm, S2p // bn),
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        backend="triton",
        interpret=interpret,
        name="min_sum_tiles",
    )(at, ct)
    out = out[:S, :S2]
    if triangle:
        # Tiles strictly below the diagonal hold zeros: mirror the upper
        # triangle (tiles crossing the diagonal are complete either way).
        r = jax.lax.broadcasted_iota(jnp.int32, out.shape, 0)
        c = jax.lax.broadcasted_iota(jnp.int32, out.shape, 1)
        out = jnp.where(r <= c, out, out.T)
    return out


def min_sum_matrix_pallas(
    counts: jax.Array,
    counts_other: jax.Array | None = None,
    interpret: bool = False,
    *,
    bm: int = BM,
    bn: int = BN,
    bk: int = BK,
    num_warps: int = NUM_WARPS,
    num_stages: int = NUM_STAGES,
) -> jax.Array:
    """[S, bins] x [S2, bins] -> [S, S2] int32 min-sum matrix.

    counts_other=None is the symmetric all-pairs case and computes only
    the upper-triangle tiles; passing a row panel as ``counts`` against
    the full matrix as ``counts_other`` yields one panel of the distance
    matrix (the streamed big-S path). Any integer dtype is widened to
    int32 on device. ``interpret=True`` runs the kernel in the Pallas
    interpreter (CPU tests only)."""
    triangle = counts_other is None
    other = counts if triangle else counts_other
    return _min_sum_call(
        counts, other, triangle=triangle, interpret=interpret,
        bm=bm, bn=bn, bk=bk, num_warps=num_warps, num_stages=num_stages,
    )
