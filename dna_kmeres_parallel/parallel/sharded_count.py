"""Data-parallel counting and distances over a device mesh.

The multi-device replacement for the reference's single-GPU launches
(/root/reference/main.cu:290,327-335): the flat base stream is sharded across
the ``data`` mesh axis, each device counts its shard with the same rolling-code
program as the single-card path, and per-device partial histograms merge with
an integer ``psum`` — exact (integer adds are associative), so the
merged histogram is bit-identical to the single-device count (SURVEY.md §4
determinism requirement).

Halos: windows spanning shard boundaries must be counted exactly once. Two
mechanisms are provided:

- host-side halo: the feeder lays out [D, T + k-1] shards whose tails
  overlap the next shard's head (models/pipeline.py);
- device-side halo via ``jax.lax.ppermute``: each device sends its first
  k-1 bases to its left neighbor (``halo_exchange``) — no host
  involvement, used by the streaming pipeline.

Each shard then counts windows *starting* in its own [0, T) range.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from dna_kmeres_parallel.ops import distance as dist_ops
from dna_kmeres_parallel.ops import encode as encode_ops
from dna_kmeres_parallel.ops import histogram as hist_ops
from dna_kmeres_parallel.parallel.mesh import DATA_AXIS


def _count_shard(bases: jax.Array, n_own, k: int, bins: int, canonical: bool):
    """Count windows starting at positions < n_own of one shard. [T]->[bins]
    (the single-card program, models/engine._count_batch)."""
    codes, valid = encode_ops.rolling_codes(bases, k)
    n = codes.shape[0]
    own = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1) < n_own
    valid = valid & own
    if canonical:
        codes = encode_ops.canonicalize(codes, k)
    return hist_ops.histogram(codes, valid, bins)


def halo_exchange(bases_sharded: jax.Array, k: int, axis: str = DATA_AXIS):
    """Append the next shard's first k-1 bases to each shard.

    bases_sharded: [T] per-device view (inside shard_map). Returns
    [T + k - 1] with the halo filled from the right neighbor via ppermute;
    the last device's halo is INVALID padding (stream end).
    """
    n_dev = jax.lax.axis_size(axis)
    halo = bases_sharded[: k - 1]
    # Send my head to my LEFT neighbor: perm[i] = (src=i, dst=i-1).
    perm = [(i, i - 1) for i in range(1, n_dev)]
    recv = jax.lax.ppermute(halo, axis, perm)
    # Device n_dev-1 receives nothing: fill with INVALID sentinel.
    idx = jax.lax.axis_index(axis)
    recv = jnp.where(idx == n_dev - 1, jnp.full_like(recv, encode_ops.INVALID), recv)
    return jnp.concatenate([bases_sharded, recv], axis=0)


@functools.partial(
    jax.jit, static_argnames=("k", "bins", "canonical", "mesh", "axis")
)
def count_sharded(
    bases: jax.Array,
    k: int,
    bins: int,
    canonical: bool,
    mesh: jax.sharding.Mesh,
    axis: str = DATA_AXIS,
    n_own=None,
    acc=None,
) -> jax.Array:
    """Flat base stream [D*T] -> merged dense histogram [bins] (replicated).

    The stream is split evenly across the ``axis`` devices; halos travel
    via ppermute; partial histograms merge with an integer psum.

    n_own (optional, traced): count only windows whose GLOBAL start index is
    < n_own — the streaming pipeline's batch-overlap rule (the k-1 tail
    bases complete the last owned windows but start none; those windows
    belong to the next batch). None counts the whole stream.
    acc (optional, traced): running histogram added INSIDE this program
    (no separate add dispatch; see models/engine._count_batch_acc).
    """
    n_dev = mesh.shape[axis]
    T = bases.shape[0]
    if T % n_dev:
        raise ValueError(f"stream length {T} not divisible by mesh axis {n_dev}")
    shard_len = T // n_dev

    def shard_fn(b, limit):
        b = b.reshape(-1)  # [T/D] local shard
        own = jnp.int32(b.shape[0])
        if limit is not None:
            start = jax.lax.axis_index(axis).astype(jnp.int32) * shard_len
            own = jnp.minimum(own, jnp.maximum(limit.reshape(()) - start, 0))
        with_halo = halo_exchange(b, k, axis)
        h = _count_shard(with_halo, own, k, bins, canonical)
        return jax.lax.psum(h, axis)

    if n_own is None:
        fn = shard_map(
            lambda b: shard_fn(b, None),
            mesh=mesh,
            in_specs=P(axis),
            out_specs=P(),
            check_vma=False,
        )
        h = fn(bases)
    else:
        fn = shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(axis), P()),
            out_specs=P(),
            check_vma=False,
        )
        h = fn(bases, jnp.asarray(n_own, jnp.int32))
    return h if acc is None else acc + h


@functools.partial(
    jax.jit, static_argnames=("mesh", "axis", "row_block", "pallas")
)
def min_sum_matrix_sharded(
    counts: jax.Array,
    mesh: jax.sharding.Mesh,
    axis: str = DATA_AXIS,
    row_block: int = 128,
    pallas: str | None = None,
) -> jax.Array:
    """Row-sharded (min,+) matrix: device d computes rows of its block
    against the all-gathered counts matrix. [S, bins] -> [S, S] int32.

    S must be divisible by the mesh axis; pad rows upstream.
    pallas='compiled'/'interpret' runs the same Pallas (min,+) kernel as
    the single-card engine on every shard; None keeps XLA's (min,+).
    Integer results are identical either way.
    """
    from dna_kmeres_parallel.ops import distance_pallas

    S = counts.shape[0]
    n_dev = mesh.shape[axis]
    if S % n_dev:
        raise ValueError(f"S={S} not divisible by mesh axis {n_dev}")

    def shard_fn(rows_local):
        full = jax.lax.all_gather(rows_local, axis, tiled=True)  # [S, bins]
        if pallas is not None:
            return distance_pallas.min_sum_matrix_pallas(
                rows_local, full, interpret=(pallas == "interpret")
            )
        return dist_ops.min_sum_matrix(
            rows_local, row_block=min(row_block, rows_local.shape[0]), counts_other=full
        )

    fn = shard_map(
        shard_fn, mesh=mesh, in_specs=P(axis, None), out_specs=P(axis, None),
        check_vma=False,
    )
    return fn(counts)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "axis", "pallas", "row_block", "int8_cmax"),
)
def min_sum_panel_sharded(
    panel: jax.Array,
    other: jax.Array,
    mesh: jax.sharding.Mesh,
    axis: str = DATA_AXIS,
    pallas: str | None = None,
    row_block: int = 128,
    int8_cmax: int | None = None,
) -> jax.Array:
    """PARTNER-sharded (min,+) panel: [Pr, bins] x [S2, bins] -> [Pr, S2].

    The multi-card production distance program: the row panel is
    replicated, the partner matrix is row-sharded over the mesh axis, and
    device d computes panel x its own S2/D partner rows with the SAME
    kernel as the single-card path (Pallas when routed, XLA otherwise) —
    no collectives at all, and the output concatenates along columns.
    Column sharding keeps the streamed path's triangle trim (callers pass
    only partner rows >= the panel start), so devices never redo the
    rectangle the single-card stream already avoids, and the work per
    device is balanced by construction. S2 must divide by the mesh axis;
    pad with zero-count rows upstream (their min-sums are 0, sliced off
    by the caller).
    """
    from dna_kmeres_parallel.ops import distance_pallas

    n_dev = mesh.shape[axis]
    if other.shape[0] % n_dev:
        raise ValueError(
            f"S2={other.shape[0]} not divisible by mesh axis {n_dev}"
        )

    def shard_fn(p, o):
        if int8_cmax is not None:
            # int8 threshold route per shard (ops/distance): callers
            # gate on counts <= cmax and window totals < 2^31.
            return dist_ops.min_sum_matrix_int8(p, int8_cmax, o)
        if pallas is not None:
            return distance_pallas.min_sum_matrix_pallas(
                p, o, interpret=(pallas == "interpret")
            )
        return dist_ops.min_sum_matrix(
            p, row_block=min(row_block, p.shape[0]), counts_other=o
        )

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(axis, None)),
        out_specs=P(None, axis),
        check_vma=False,
    )
    return fn(panel, other)


def device_put_sharded_stream(
    flat: np.ndarray, mesh: jax.sharding.Mesh, axis: str = DATA_AXIS
) -> jax.Array:
    """Pad a host stream to a multiple of the axis size and place it sharded."""
    n_dev = mesh.shape[axis]
    pad = (-flat.shape[0]) % n_dev
    if pad:
        flat = np.concatenate(
            [flat, np.full(pad, encode_ops.INVALID, dtype=np.uint8)]
        )
    sharding = NamedSharding(mesh, P(axis))
    return jax.device_put(flat, sharding)
