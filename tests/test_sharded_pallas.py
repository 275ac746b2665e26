"""The multi-device count programs on the virtual 8-device CPU mesh.

Every multi-device path runs the same device program as the single-card
path on each device (one implementation, so tables stay bit-identical at
any device count). These tests assert exact oracle equality and
bit-identity between the exchanges and routes.
"""

import jax
import numpy as np
import pytest

from dna_kmeres_parallel.models import oracle
from dna_kmeres_parallel.models.oracle import count_table_any_k
from dna_kmeres_parallel.parallel import bucketed, sharded_count as sc, sharded_sparse
from dna_kmeres_parallel.parallel.mesh import make_mesh
from dna_kmeres_parallel.utils import codec


def _flat_stream(seqs):
    parts = []
    for i, s in enumerate(seqs):
        if i:
            parts.append(np.array([codec.INVALID_BASE], dtype=np.uint8))
        parts.append(codec.encode_bases(s))
    return np.concatenate(parts)


def _table(codes, counts, k):
    return {codec.code_to_kmer(int(c), k): int(n) for c, n in zip(codes, counts)}


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8
    return make_mesh(8)


@pytest.mark.parametrize("k,canonical", [(3, False), (5, True)])
def test_dense_sharded_matches_oracle(make_dna, mesh8, k, canonical):
    seqs = [make_dna(211 + 37 * i, invalid_frac=0.02) for i in range(5)]
    flat = _flat_stream(seqs)
    stream = sc.device_put_sharded_stream(flat, mesh8)
    hist = sc.count_sharded(stream, k, codec.num_bins(k), canonical, mesh8)
    want = sum(
        (oracle.count_vector(s, k, canonical=canonical) for s in seqs),
        np.zeros(codec.num_bins(k), dtype=np.int64),
    )
    assert np.array_equal(np.asarray(hist, dtype=np.int64), want)


@pytest.mark.parametrize(
    "k,canonical,device_sort",
    [(13, False, False), (21, False, False), (21, True, True), (17, False, True)],
)
def test_dp_sparse_sharded_matches_oracle(make_dna, k, canonical, device_sort):
    seqs = [make_dna(130 + 31 * i, invalid_frac=0.02) for i in range(5)]
    flat = _flat_stream(seqs)
    codes, counts = sharded_sparse.count_sparse_sharded(
        flat, k, canonical, make_mesh(8), row_len=64, device_sort=device_sort
    )
    assert _table(codes, counts, k) == count_table_any_k(seqs, k, canonical)


@pytest.mark.parametrize("owner_mode", ["prefix", "minimizer"])
@pytest.mark.parametrize("k,canonical", [(21, False), (21, True), (13, False)])
def test_bucketed_agg_matches_oracle(make_dna, mesh8, owner_mode, k, canonical):
    seqs = [make_dna(150 + 11 * i, invalid_frac=0.02) for i in range(4)]
    flat = _flat_stream(seqs)
    shards, n_own = bucketed.shard_stream_with_halo(flat, k, mesh8)
    hi, lo, counts, starts, overflow = bucketed.count_bucket_sharded(
        jax.numpy.asarray(shards), jax.numpy.asarray(n_own), k, canonical,
        mesh8, owner_mode=owner_mode,
    )
    assert not bool(overflow)
    codes, cnts = bucketed.gather_table(hi, lo, counts, starts)
    assert _table(codes, cnts, k) == count_table_any_k(seqs, k, canonical)


@pytest.mark.parametrize("k", [13, 16, 21, 31])
def test_bucketed_raw_matches_oracle(make_dna, k):
    # k=16 exercises the u16-hi band (native-width planes through the
    # exchange); 13 the single-word band; 31 the u32-hi band.
    seqs = [make_dna(140 + 13 * i, invalid_frac=0.02) for i in range(4)]
    flat = _flat_stream(seqs)
    codes, cnts = bucketed.count_bucket_sharded_raw(flat, k, False, make_mesh(8))
    assert _table(codes, cnts, k) == count_table_any_k(seqs, k, False)


def test_bucketed_raw_bitidentical_to_agg(make_dna):
    flat = codec.encode_bases(make_dna(1200, invalid_frac=0.02))
    mesh = make_mesh(8)
    a = bucketed.count_bucket_sharded_raw(flat, 21, True, mesh)
    b = bucketed.count_bucket_auto(flat, 21, True, mesh, exchange="agg")
    assert np.array_equal(a[0], b[0])
    assert np.array_equal(a[1], b[1])


def test_dp_sparse_no_sort_bitidentical_to_sorted(make_dna):
    flat = codec.encode_bases(make_dna(900, invalid_frac=0.02))
    mesh = make_mesh(8)
    a = sharded_sparse.count_sparse_sharded(
        flat, 21, False, mesh, device_sort=False
    )
    b = sharded_sparse.count_sparse_sharded(
        flat, 21, False, mesh, device_sort=True, row_len=64
    )
    assert np.array_equal(a[0], b[0])
    assert np.array_equal(a[1], b[1])


def test_dp_sparse_odd_shard_width_matches_oracle(make_dna, mesh8):
    # A stream whose shard width is not a multiple of any tile, with
    # invalid bases: the encode-only DP route == oracle.
    seqs = [make_dna(171 + 13 * i, invalid_frac=0.03) for i in range(5)]
    flat = _flat_stream(seqs)
    codes, counts = sharded_sparse.count_sparse_sharded(
        flat, 21, False, mesh8, device_sort=False
    )
    assert _table(codes, counts, 21) == count_table_any_k(seqs, 21)


def test_dp_sparse_routes_agree_k17(make_dna, mesh8):
    seqs = [make_dna(140 + 11 * i) for i in range(4)]
    flat = _flat_stream(seqs)
    on = sharded_sparse.count_sparse_sharded(
        flat, 17, False, mesh8, device_sort=False
    )
    off = sharded_sparse.count_sparse_sharded(
        flat, 17, False, mesh8, device_sort=True, row_len=64
    )
    assert np.array_equal(on[0], off[0]) and np.array_equal(on[1], off[1])


@pytest.mark.parametrize("k", [13, 21, 31])
def test_bucketed_raw_minimizer_matches_oracle(make_dna, k):
    # Minimizer owner routing across all key-word bands.
    seqs = [make_dna(150 + 13 * i, invalid_frac=0.02) for i in range(4)]
    flat = _flat_stream(seqs)
    codes, cnts = bucketed.count_bucket_sharded_raw(
        flat, k, False, make_mesh(8), owner_mode="minimizer"
    )
    assert _table(codes, cnts, k) == count_table_any_k(seqs, k, False)


@pytest.mark.parametrize("owner_mode", ["prefix", "minimizer"])
def test_bucketed_agg_driver_matches_oracle(make_dna, owner_mode):
    # The aggregated exchange through the policy driver
    # (count_bucket_auto exchange='agg'), canonical folding included.
    k = 21
    seqs = [make_dna(160 + 11 * i, invalid_frac=0.02) for i in range(4)]
    flat = _flat_stream(seqs)
    codes, cnts = bucketed.count_bucket_auto(
        flat, k, True, make_mesh(8), owner_mode=owner_mode, exchange="agg"
    )
    assert _table(codes, cnts, k) == count_table_any_k(seqs, k, True)


def test_bucketed_minimizer_bitidentical_to_prefix(make_dna):
    # Same table whichever owner function routes the windows.
    flat = codec.encode_bases(make_dna(1400, invalid_frac=0.02))
    mesh = make_mesh(8)
    a = bucketed.count_bucket_sharded_raw(
        flat, 21, False, mesh, owner_mode="minimizer"
    )
    b = bucketed.count_bucket_sharded_raw(flat, 21, False, mesh)
    assert np.array_equal(a[0], b[0])
    assert np.array_equal(a[1], b[1])
