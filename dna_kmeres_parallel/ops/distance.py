"""Pairwise k-mer distance: tiled (min,+) reduction over the counts matrix.

D(i,j) = 1 - sum_p min(cnt_i[p], cnt_j[p]) / (min(L_i, L_j) - k + 1), float32
(reference formula: /root/reference/main.cu:614, kernels.h:105).

The reference computes this with n synchronous kernel launches, one query row
per launch (/root/reference/main.cu:327-335). Here the whole matrix is one
fused XLA program: row-blocks of the [S, bins] counts matrix broadcast
against the full matrix and min-summed, assembled into the packed
strict-upper-triangle layout. The Pallas-Triton kernel in
ops/distance_pallas.py is the fast route on the GPU; this is the plain
reference it is checked against.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np



def min_sum_block(block: jax.Array, counts: jax.Array) -> jax.Array:
    """sum_p min(block[i,p], counts[j,p]) for all i in block, j in counts.

    block: [TS, bins] int32; counts: [S, bins] int32 -> [TS, S] int32.
    """
    return jnp.sum(
        jnp.minimum(block[:, None, :], counts[None, :, :]), axis=-1
    )


@functools.partial(jax.jit, static_argnames=("row_block",))
def min_sum_matrix(
    counts: jax.Array, row_block: int = 128, counts_other: jax.Array | None = None
) -> jax.Array:
    """[S, S2] int32 matrix of sum_p min(counts[i,p], counts_other[j,p]).

    counts_other defaults to counts (the symmetric all-pairs case). Row-blocked
    so peak memory is row_block x S2 x bins. Integer throughout — the result
    is exact regardless of tiling/device, so the float distance formula
    applied to it downstream is bit-reproducible. The sharded distance engine
    passes its local row block as ``counts`` and the all-gathered full matrix
    as ``counts_other``.
    """
    other = counts if counts_other is None else counts_other
    S = counts.shape[0]
    pad = (-S) % row_block
    counts_p = jnp.pad(counts, ((0, pad), (0, 0)))
    nblocks = counts_p.shape[0] // row_block
    blocks = counts_p.reshape(nblocks, row_block, -1)

    def body(_, blk):
        return None, min_sum_block(blk, other)

    _, sums = jax.lax.scan(body, None, blocks)  # [nblocks, row_block, S2]
    return sums.reshape(nblocks * row_block, -1)[:S]


#: hard cap on the int8 threshold route's unroll: one int8 matmul per
#: threshold — past ~64 terms compile time and the per-term floor erase
#: the win over the (min,+) routes everywhere.
#: KMER_INT8_CMAX overrides (and skips the cost comparison below —
#: an explicit override is trusted).
INT8_CMAX_DEFAULT = 64

#: Per-pair time models of the dense min-sum routes, fitted on one NVIDIA
#: H100 80GB HBM3 at a 700 W power limit (scripts/kernel_timings.py,
#: PERF.md "Findings"; pairs = S(S-1)/2):
#: - int8 threshold chain: 2.05 ms at S=2048 x 64K bins x cmax=4 and
#:   1.10 ms at S=8192 x 64 bins x cmax=4 -> 2.78e14 MAC/s plus a
#:   8.0e-12 s per-pair-per-threshold floor;
#: - Pallas (min,+) kernel (triangle grid): 44.8 ms at S=2048 x 64K bins
#:   and 0.97 ms at S=8192 x 64 bins -> 3.06e12 bin-pair terms/s plus a
#:   8.1e-12 s per-pair floor;
#: - XLA (min,+): 2.30 s at S=2048 x 64K bins -> 5.97e10 bin-pair terms/s.
#: `kmers calibrate` replaces them with the host's own measurements.
INT8_MACS_PER_SEC = 2.78e14
INT8_PAIR_THRESH_OVERHEAD_S = 8.0e-12
TRI_BIN_PAIRS_PER_SEC = 3.06e12
TRI_PAIR_OVERHEAD_S = 8.1e-12
DENSE_BIN_PAIRS_PER_SEC = 5.97e10


def _cal_rate(key: str, frozen: float) -> float:
    """Measured backend rate when a calibration exists
    (ops/calibrate: `kmers calibrate` persists per-backend pair rates
    beside the compile cache), the built-in H100 constant otherwise."""
    from dna_kmeres_parallel.ops import calibrate

    return float(calibrate.get_calibration().get(key, frozen))


def int8_time_per_pair(bins: int, cmax: int) -> float:
    """Predicted s/pair for min_sum_matrix_int8 at these bins/cmax."""
    macs = _cal_rate("int8_macs_per_sec", INT8_MACS_PER_SEC)
    return cmax * (bins / macs + INT8_PAIR_THRESH_OVERHEAD_S)


def tri_time_per_pair(bins: int) -> float:
    """Predicted s/pair for the Pallas (min,+) kernel (triangle grid)."""
    rate = _cal_rate("tri_bin_pairs_per_sec", TRI_BIN_PAIRS_PER_SEC)
    return bins / rate + TRI_PAIR_OVERHEAD_S


def jnp_time_per_pair(bins: int) -> float:
    """Predicted s/pair for XLA's (min,+) (min_sum_matrix)."""
    return bins / _cal_rate(
        "dense_bin_pairs_per_sec", DENSE_BIN_PAIRS_PER_SEC
    )


@functools.partial(jax.jit, static_argnames=("cmax",))
def min_sum_matrix_int8(
    counts: jax.Array,
    cmax: int,
    counts_other: jax.Array | None = None,
) -> jax.Array:
    """(min,+) on the tensor cores via thresholding:

        sum_p min(a_p, b_p) = sum_{t=1..cmax} [a_p >= t] * [b_p >= t]

    i.e. cmax boolean matmuls [S, bins] @ [bins, S2] — the matrix-unit
    reformulation of the reference's per-pair min loop
    (/root/reference/kernels.h:102-104) for the low-multiplicity regime.
    int8 planes with int32 accumulation: EXACT whenever every count <=
    cmax and min-sums stay below 2^31 (they are bounded by the window
    count — always, in practice; callers gate). The t-loop is a static
    unroll, so XLA can pipeline the chain of matmuls.
    """
    other = counts if counts_other is None else counts_other
    # Thresholds compare the INPUT dtype directly: t = cmax must be
    # representable or (counts >= t) silently wraps (int8 t=128 becomes
    # >= -128 = all-True). Callers gate; this guard turns a silent
    # corruption into an error (advisor r4).
    if jnp.issubdtype(counts.dtype, jnp.integer) and cmax > int(
        jnp.iinfo(counts.dtype).max
    ):
        raise ValueError(
            f"cmax={cmax} not representable in {counts.dtype}; widen the "
            "counts (int32) before the int8 threshold route"
        )
    acc = None
    for t in range(1, cmax + 1):
        a = (counts >= t).astype(jnp.int8)
        b = a if counts_other is None else (other >= t).astype(jnp.int8)
        term = jax.lax.dot_general(
            a,
            b,
            (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        acc = term if acc is None else acc + term
    return acc


def finish_distances(
    min_sums: np.ndarray, lengths: np.ndarray, k: int
) -> np.ndarray:
    """Host-side float32 finish: D = 1 - s / (min(L_i,L_j) - k + 1).

    Applied on host with NumPy's IEEE-correctly-rounded f32 division because
    XLA's f32 divide is 1 ulp off IEEE on some backends, and the parity
    contract against the reference (x86 divss / CUDA prec-div, both correctly
    rounded — main.cu:614, kernels.h:105) is bitwise. The heavy (min,+) work
    stays on device; this is a trivial elementwise pass over [S, S].
    """
    min_sums = np.asarray(min_sums)
    lengths = np.asarray(lengths, dtype=np.int64)
    min_len = np.minimum(lengths[:, None], lengths[None, :])
    denom = (min_len - k + 1).astype(np.float32)
    return np.float32(1.0) - min_sums.astype(np.float32) / denom


def finish_distances_panel(
    min_sums: np.ndarray, lengths_rows: np.ndarray, lengths_all: np.ndarray, k: int
) -> np.ndarray:
    """Panel variant of finish_distances: rows vs all. [R, S] float32."""
    min_sums = np.asarray(min_sums)
    lr = np.asarray(lengths_rows, dtype=np.int64)[:, None]
    la = np.asarray(lengths_all, dtype=np.int64)[None, :]
    denom = (np.minimum(lr, la) - k + 1).astype(np.float32)
    return np.float32(1.0) - min_sums.astype(np.float32) / denom


@functools.partial(jax.jit, static_argnames=("k", "row_block"))
def distance_matrix_square(
    counts: jax.Array, lengths: jax.Array, k: int, row_block: int = 128
) -> jax.Array:
    """All-device [S, S] float32 distance matrix (throughput path; may differ
    from the bit-exact host finish by 1 ulp in the division — use
    min_sum_matrix + finish_distances when bitwise parity matters)."""
    sums = min_sum_matrix(counts, row_block)
    min_len = jnp.minimum(lengths[:, None], lengths[None, :])
    denom = (min_len - k + 1).astype(jnp.float32)
    return jnp.float32(1.0) - sums.astype(jnp.float32) / denom


def distance_matrix_packed(
    counts: jax.Array, lengths: jax.Array, k: int, row_block: int = 128
) -> np.ndarray:
    """Packed strict-upper-triangle float32 distances (reference layout,
    SURVEY.md §2.4.5), bit-exact: device (min,+) + host float finish."""
    S = counts.shape[0]
    sums = np.asarray(min_sum_matrix(counts, row_block))
    square = finish_distances(sums, np.asarray(lengths), k)
    rows, cols = np.triu_indices(S, k=1)
    return square[rows, cols]
