"""Sharded counting/distance tests on the virtual 8-device CPU mesh.

Validates SURVEY.md §4's collective-merge contract: sharded-count(stream
split N ways) == single-device count(whole stream), bit-identical, and the
row-sharded (min,+) matrix equals the single-device one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from dna_kmeres_parallel.models import oracle
from dna_kmeres_parallel.ops import distance as dist_ops
from dna_kmeres_parallel.parallel import sharded_count as sc
from dna_kmeres_parallel.parallel.mesh import DATA_AXIS, make_mesh
from dna_kmeres_parallel.utils import codec


def _flat_stream(seqs):
    parts = []
    for i, s in enumerate(seqs):
        if i:
            parts.append(np.array([codec.INVALID_BASE], dtype=np.uint8))
        parts.append(codec.encode_bases(s))
    return np.concatenate(parts)


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


@pytest.mark.parametrize("k", [3, 5, 11])
def test_sharded_count_equals_oracle(make_dna, mesh8, k):
    seqs = [make_dna(211 + 37 * i, invalid_frac=0.02) for i in range(7)]
    flat = _flat_stream(seqs)
    stream = sc.device_put_sharded_stream(flat, mesh8)
    hist = sc.count_sharded(stream, k, codec.num_bins(k), False, mesh8)
    want = sum(
        (oracle.count_vector(s, k) for s in seqs),
        np.zeros(codec.num_bins(k), dtype=np.int64),
    )
    assert np.array_equal(np.asarray(hist, dtype=np.int64), want)


def test_sharded_count_canonical(make_dna, mesh8):
    k = 5
    seqs = [make_dna(300) for _ in range(4)]
    flat = _flat_stream(seqs)
    stream = sc.device_put_sharded_stream(flat, mesh8)
    hist = sc.count_sharded(stream, k, codec.num_bins(k), True, mesh8)
    want = sum(
        (oracle.count_vector(s, k, canonical=True) for s in seqs),
        np.zeros(codec.num_bins(k), dtype=np.int64),
    )
    assert np.array_equal(np.asarray(hist, dtype=np.int64), want)


def test_shard_boundary_windows_counted_once(mesh8):
    # A single long homopolymer: every boundary window must be counted via
    # the ppermute halo, exactly once. 8 devices * 32 bases each.
    k = 7
    s = "A" * 256
    stream = sc.device_put_sharded_stream(codec.encode_bases(s), mesh8)
    hist = np.asarray(
        sc.count_sharded(stream, k, codec.num_bins(k), False, mesh8),
        dtype=np.int64,
    )
    assert hist[0] == 256 - k + 1
    assert hist.sum() == 256 - k + 1


def test_determinism_across_shardings(make_dna, mesh8):
    # Same stream, 1 vs 8 devices -> bit-identical histogram (integer adds).
    k = 4
    seqs = [make_dna(513) for _ in range(3)]
    flat = _flat_stream(seqs)
    stream8 = sc.device_put_sharded_stream(flat, mesh8)
    h8 = np.asarray(sc.count_sharded(stream8, k, 256, False, mesh8))
    mesh1 = make_mesh(1)
    stream1 = sc.device_put_sharded_stream(flat, mesh1)
    h1 = np.asarray(sc.count_sharded(stream1, k, 256, False, mesh1))
    assert np.array_equal(h1, h8)


def test_min_sum_matrix_sharded(make_dna, mesh8):
    k = 3
    S = 16
    seqs = [make_dna(60 + 5 * i) for i in range(S)]
    counts = oracle.counts_matrix(seqs, k).astype(np.int32)
    counts_dev = jax.device_put(
        jnp.asarray(counts), NamedSharding(mesh8, P(DATA_AXIS, None))
    )
    got = np.asarray(sc.min_sum_matrix_sharded(counts_dev, mesh8, row_block=2))
    want = np.asarray(dist_ops.min_sum_matrix(jnp.asarray(counts), row_block=8))
    assert np.array_equal(got, want)


def test_stream_not_divisible_is_padded(make_dna, mesh8):
    # device_put_sharded_stream pads with INVALID, which never counts.
    k = 3
    s = make_dna(101)  # 101 not divisible by 8
    stream = sc.device_put_sharded_stream(codec.encode_bases(s), mesh8)
    assert stream.shape[0] % 8 == 0
    hist = np.asarray(sc.count_sharded(stream, k, 64, False, mesh8))
    assert hist.sum() == 101 - k + 1


@pytest.mark.parametrize("k,canonical", [(13, False), (21, False), (21, True), (31, False)])
def test_count_sparse_sharded_matches_oracle(make_dna, k, canonical):
    # DP-sparse (config 4 shape): per-chip row-sorted shards, host merge.
    from dna_kmeres_parallel.models.oracle import count_table_any_k
    from dna_kmeres_parallel.parallel import sharded_sparse
    from dna_kmeres_parallel.parallel.mesh import make_mesh
    from dna_kmeres_parallel.utils import codec

    seqs = [make_dna(130 + 31 * i, invalid_frac=0.02) for i in range(5)]
    parts = []
    for i, s in enumerate(seqs):
        if i:
            parts.append(np.array([codec.INVALID_BASE], dtype=np.uint8))
        parts.append(codec.encode_bases(s))
    flat = np.concatenate(parts)
    mesh = make_mesh(8)
    codes, counts = sharded_sparse.count_sparse_sharded(
        flat, k, canonical, mesh, row_len=64
    )
    want = count_table_any_k(seqs, k, canonical)
    got = {codec.code_to_kmer(int(c), k): int(n) for c, n in zip(codes, counts)}
    assert got == want


@pytest.mark.parametrize("k", [13, 21])
def test_count_sparse_sharded_nosort_matches_sorted(make_dna, k):
    # The no-device-sort DP route (encode-only shards + host radix
    # compactor) is bit-identical to the row-sorted route.
    from dna_kmeres_parallel.parallel import sharded_sparse
    from dna_kmeres_parallel.parallel.mesh import make_mesh
    from dna_kmeres_parallel.utils import codec

    flat = codec.encode_bases(make_dna(900, invalid_frac=0.02))
    mesh = make_mesh(8)
    a = sharded_sparse.count_sparse_sharded(
        flat, k, False, mesh, row_len=64, device_sort=True
    )
    b = sharded_sparse.count_sparse_sharded(
        flat, k, False, mesh, device_sort=False
    )
    assert np.array_equal(a[0], b[0])
    assert np.array_equal(a[1], b[1])


def test_streaming_mesh_nosort_matches_oracle(make_dna, tmp_path):
    # StreamingCounter on the virtual mesh with device_sort=False.
    from dna_kmeres_parallel.models.oracle import count_table_any_k
    from dna_kmeres_parallel.models.pipeline import StreamingCounter
    from dna_kmeres_parallel.utils import codec, fasta
    from dna_kmeres_parallel.utils.config import KmerConfig

    records = [(f">r{i}", make_dna(200 + 17 * i)) for i in range(3)]
    path = tmp_path / "m.fasta"
    fasta.write_fasta(path, records)
    cfg = KmerConfig(
        k=21, batch_bases=256, mesh_shape=(8,), device_sort=False
    )
    res = StreamingCounter(cfg).run(str(path))
    want = count_table_any_k([s for _, s in records], 21)
    got = {
        codec.code_to_kmer(int(c), 21): int(n)
        for c, n in zip(res.codes, res.counts)
    }
    assert got == want


def test_count_sparse_sharded_device_count_invariant(make_dna):
    # Bit-identical table at 1, 2, 8 devices (integer merges only).
    from dna_kmeres_parallel.parallel import sharded_sparse
    from dna_kmeres_parallel.parallel.mesh import make_mesh
    from dna_kmeres_parallel.utils import codec

    flat = codec.encode_bases(make_dna(700, invalid_frac=0.01))
    results = [
        sharded_sparse.count_sparse_sharded(flat, 21, False, make_mesh(d), row_len=128)
        for d in (1, 2, 8)
    ]
    for c, n in results[1:]:
        assert np.array_equal(c, results[0][0])
        assert np.array_equal(n, results[0][1])


def test_sharded_counters_empty_stream(make_dna):
    """An empty stream must return an empty table from every sharded
    counter, not crash the encoder's window math (review regression)."""
    from dna_kmeres_parallel.parallel import bucketed, sharded_sparse
    from dna_kmeres_parallel.parallel.mesh import make_mesh

    mesh = make_mesh(8)
    flat = np.zeros(0, np.uint8)
    c, n = sharded_sparse.count_sparse_sharded(flat, 21, False, mesh, row_len=64)
    assert c.size == 0 and n.size == 0
    c, n = sharded_sparse.count_sparse_sharded(flat, 21, False, mesh, device_sort=False)
    assert c.size == 0
    c, n = bucketed.count_bucket_sharded_raw(flat, 21, False, mesh)
    assert c.size == 0


def test_min_sum_panel_sharded_matches_single(make_dna, mesh8):
    # The partner-sharded panel program (r4 multi-chip distances): same
    # integer sums as the single-device reduction, jnp and Pallas routes.
    k = 3
    panel = oracle.counts_matrix(
        [make_dna(50 + 3 * i) for i in range(6)], k
    ).astype(np.int32)
    other = oracle.counts_matrix(
        [make_dna(40 + 5 * i) for i in range(24)], k
    ).astype(np.int32)
    want = np.asarray(
        dist_ops.min_sum_matrix(
            jnp.asarray(panel), counts_other=jnp.asarray(other)
        )
    )
    got = np.asarray(
        sc.min_sum_panel_sharded(
            jnp.asarray(panel), jnp.asarray(other), mesh8
        )
    )
    assert np.array_equal(got, want)
    got_pl = np.asarray(
        sc.min_sum_panel_sharded(
            jnp.asarray(panel), jnp.asarray(other), mesh8, pallas="interpret"
        )
    )
    assert np.array_equal(got_pl, want)


def test_min_sum_matrix_sharded_pallas(make_dna, mesh8):
    # The row-sharded library entry with the Pallas kernel per shard.
    k = 3
    S = 16
    counts = oracle.counts_matrix(
        [make_dna(60 + 5 * i) for i in range(S)], k
    ).astype(np.int32)
    counts_dev = jax.device_put(
        jnp.asarray(counts), NamedSharding(mesh8, P(DATA_AXIS, None))
    )
    got = np.asarray(
        sc.min_sum_matrix_sharded(counts_dev, mesh8, pallas="interpret")
    )
    want = np.asarray(
        dist_ops.min_sum_matrix(jnp.asarray(counts), row_block=8)
    )
    assert np.array_equal(got, want)
