"""Data-parallel SPARSE counting: per-chip row-sorted shards, host merge.

The k=21 multi-chip configuration (BASELINE config 4) when the distinct
table fits host memory: each device encodes + row-sorts its own stream
shard (halo-carrying, like the dense DP path), the host compacts each
device's rows with the native loser-tree merge and tree-merges the
per-device tables — pure integer merges, so the result is bit-identical
to a single-device count at any device count (SURVEY.md §4 determinism).

This is the collective-free DP alternative to parallel/bucketed.py (which
routes codes to owner chips over all_to_all so no single host ever holds
the whole table): DP-sparse moves D2H volume ~ windows, bucketed moves
interconnect volume ~ distinct codes. For a single host with 4 cards,
DP-sparse is the simpler plan; for k=31 tables too large for one host,
bucketed.

Reference contrast: the CUDA program is single-GPU (SURVEY.md §2.5); this
subsumes its step-1 counting across chips.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from dna_kmeres_parallel.ops import sparse as sparse_ops
from dna_kmeres_parallel.parallel.mesh import DATA_AXIS


@functools.partial(
    jax.jit,
    static_argnames=("k", "canonical", "mesh", "axis", "row_len"),
)
def sort_words_rows_sharded(
    bases: jax.Array,
    n_own_per_shard: jax.Array,
    k: int,
    canonical: bool,
    mesh: jax.sharding.Mesh,
    axis: str = DATA_AXIS,
    row_len: int = 2048,
):
    """[D, T + k - 1] halo-carrying stream shards -> per-device row-sorted
    word planes [D, rows, row_len] (see ops/sparse.sort_words_rows).

    Each device sorts only its own shard — no collectives; the exact merge
    happens on host (count_sparse_sharded). Shards carry their k-1 halo and
    n_own_per_shard[d] owned windows, so every window is counted exactly
    once (halo rule, SURVEY.md §5).
    """

    def shard_fn(b, n_own):
        # The per-shard program IS the single-device row-sorted program —
        # one implementation, so the DP-sparse table stays bit-identical to
        # a single-device count at any device count.
        words = sparse_ops._encode_words(
            b.reshape(-1), n_own.reshape(()), k, canonical
        )
        out = sparse_ops._sort_words_as_rows(words, row_len)
        return tuple(o[None] for o in out)

    n_words = 1 if k <= sparse_ops.MAX_SINGLE_WORD_K else 2
    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis)),
        out_specs=tuple(P(axis, None, None) for _ in range(n_words)),
        check_vma=False,
    )
    return fn(bases, n_own_per_shard)


@functools.partial(
    jax.jit,
    static_argnames=("k", "canonical", "mesh", "axis"),
)
def encode_words_sharded(
    bases: jax.Array,
    n_own_per_shard: jax.Array,
    k: int,
    canonical: bool,
    mesh: jax.sharding.Mesh,
    axis: str = DATA_AXIS,
):
    """[D, T + k - 1] halo-carrying stream shards -> per-device UNSORTED
    word planes [D, T] — the no-device-sort DP variant: each device runs
    the encode alone and the host radix compactor
    (sparse_engine.compact_unsorted) absorbs each plane. See
    KmerConfig.device_sort."""

    def shard_fn(b, n_own):
        out = sparse_ops._encode_words(
            b.reshape(-1), n_own.reshape(()), k, canonical
        )
        return tuple(o[None] for o in out)

    n_words = 1 if k <= sparse_ops.MAX_SINGLE_WORD_K else 2
    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis)),
        out_specs=tuple(P(axis, None) for _ in range(n_words)),
        check_vma=False,
    )
    return fn(bases, n_own_per_shard)


def count_sparse_sharded(
    flat: np.ndarray,
    k: int,
    canonical: bool,
    mesh: jax.sharding.Mesh,
    axis: str = DATA_AXIS,
    row_len: int = 2048,
    total_own=None,
    device_sort: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Flat encoded stream -> exact sorted (codes_u64, counts_i64) table,
    counted data-parallel across the mesh (one shard per device).
    total_own: see shard_stream_with_halo (streaming batch-overlap rule).
    device_sort=False runs encode-only shards + the host radix compactor."""
    from dna_kmeres_parallel.models.sparse_engine import (
        compact_table,
        compact_unsorted,
        fetch_words,
        merge_sparse_tables,
    )
    from dna_kmeres_parallel.parallel.bucketed import shard_stream_with_halo

    shards, n_own = shard_stream_with_halo(flat, k, mesh, axis, total_own)
    # Straight from numpy to one shard per device (jnp.asarray would
    # commit the whole array to the first device, then reshard).
    shards = jax.device_put(shards, NamedSharding(mesh, P(axis, None)))
    n_own = jax.device_put(n_own, NamedSharding(mesh, P(axis)))
    if device_sort:
        words = sort_words_rows_sharded(
            shards, n_own, k, canonical, mesh, axis, row_len
        )
    else:
        words = encode_words_sharded(shards, n_own, k, canonical, mesh, axis)
    words = fetch_words(words)
    D = words[-1].shape[0]
    tables = [
        compact_table(tuple(w[d] for w in words))
        if device_sort
        else compact_unsorted(tuple(w[d] for w in words), k)
        for d in range(D)
    ]
    return merge_sparse_tables(tables)
