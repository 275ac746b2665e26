"""Bucket-sharded (all_to_all) sparse counting on the virtual 8-device mesh."""

import jax
import jax.extend.core
import jax.numpy as jnp
import numpy as np
import pytest

from dna_kmeres_parallel.models import oracle
from dna_kmeres_parallel.parallel import bucketed
from dna_kmeres_parallel.parallel.mesh import make_mesh
from dna_kmeres_parallel.utils import codec


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8
    return make_mesh(8)


def _flat(seqs):
    parts = []
    for i, s in enumerate(seqs):
        if i:
            parts.append(np.array([codec.INVALID_BASE], dtype=np.uint8))
        parts.append(codec.encode_bases(s))
    return np.concatenate(parts)


def _run(seqs, k, mesh, canonical=False):
    flat = _flat(seqs)
    shards, n_own = bucketed.shard_stream_with_halo(flat, k, mesh)
    hi, lo, counts, starts, overflow = bucketed.count_bucket_sharded(
        jnp.asarray(shards), jnp.asarray(n_own), k, canonical, mesh
    )
    assert not bool(overflow), "send bucket overflowed capacity"
    return bucketed.gather_table(hi, lo, counts, starts)


@pytest.mark.parametrize("k", [16, 17, 21, 31])
def test_bucketed_matches_naive(make_dna, mesh8, k):
    seqs = [make_dna(300 + 17 * i, invalid_frac=0.02) for i in range(4)]
    codes, counts = _run(seqs, k, mesh8)
    want = oracle.count_table_any_k(seqs, k)
    got = {
        codec.code_to_kmer(int(c), k): int(n) for c, n in zip(codes, counts)
    }
    assert got == want


def test_bucketed_canonical(make_dna, mesh8):
    k = 21
    seqs = [make_dna(500)]
    codes, counts = _run(seqs, k, mesh8, canonical=True)
    want = oracle.count_table_any_k(seqs, k, canonical=True)
    got = {codec.code_to_kmer(int(c), k): int(n) for c, n in zip(codes, counts)}
    assert got == want


def test_bucketed_globally_sorted(make_dna, mesh8):
    # Owner = top code bits, so concatenated per-device tables are globally
    # sorted — the invariant the merge layer relies on.
    seqs = [make_dna(800)]
    codes, _ = _run(seqs, 21, mesh8)
    assert np.all(np.diff(codes.astype(np.uint64).view(np.int64)) > 0)


def test_bucketed_shard_boundary_halo(mesh8):
    # Homopolymer spanning every shard boundary: total count must be exact.
    k = 17
    s = "A" * 1000
    codes, counts = _run([s], k, mesh8)
    assert codes.shape == (1,)
    assert int(counts[0]) == 1000 - k + 1


def test_bucketed_matches_single_host_sparse(make_dna, mesh8):
    # Cross-check against the single-device sparse engine.
    from dna_kmeres_parallel.models.sparse_engine import SparseKmerEngine
    from dna_kmeres_parallel.utils.config import KmerConfig

    k = 21
    seqs = [make_dna(400) for _ in range(3)]
    codes, counts = _run(seqs, k, mesh8)
    single = SparseKmerEngine(KmerConfig(k=k)).count_sequences(seqs)
    assert np.array_equal(codes, single.codes)
    assert np.array_equal(counts, single.counts)


def test_window_minimizers_property(make_dna):
    # minimizer = min m-mer code over the window, computed independently.
    s = make_dna(200)
    k, m = 21, 7
    bases = jnp.asarray(codec.encode_bases(s))
    mini = np.asarray(bucketed.window_minimizers(bases, k, m))
    for i in range(0, len(s) - k + 1, 13):
        window = s[i : i + k]
        want = min(
            codec.kmer_to_code(window[j : j + m]) for j in range(k - m + 1)
        )
        assert mini[i] == want


@pytest.mark.parametrize("k", [17, 21, 31])
def test_bucketed_minimizer_matches_naive(make_dna, mesh8, k):
    seqs = [make_dna(300 + 11 * i, invalid_frac=0.02) for i in range(4)]
    flat = _flat(seqs)
    shards, n_own = bucketed.shard_stream_with_halo(flat, k, mesh8)
    hi, lo, counts, starts, overflow = bucketed.count_bucket_sharded(
        jnp.asarray(shards), jnp.asarray(n_own), k, False, mesh8,
        owner_mode="minimizer",
    )
    assert not bool(overflow)
    codes, cnts = bucketed.gather_table(hi, lo, counts, starts)
    want = oracle.count_table_any_k(seqs, k)
    got = {codec.code_to_kmer(int(c), k): int(n) for c, n in zip(codes, cnts)}
    assert got == want


def test_bucketed_minimizer_skewed_input(mesh8):
    # Homopolymer: all windows share one minimizer -> one owner, but the
    # local RLE collapses them to a single pair, so no overflow.
    k = 21
    s = "A" * 2000
    flat = _flat([s])
    shards, n_own = bucketed.shard_stream_with_halo(flat, k, mesh8)
    hi, lo, counts, starts, overflow = bucketed.count_bucket_sharded(
        jnp.asarray(shards), jnp.asarray(n_own), k, False, mesh8,
        owner_mode="minimizer",
    )
    assert not bool(overflow)
    codes, cnts = bucketed.gather_table(hi, lo, counts, starts)
    assert codes.shape == (1,)
    assert int(cnts[0]) == 2000 - k + 1


@pytest.mark.parametrize("n_dev,k", [(6, 21), (5, 24)])
def test_bucketed_non_pow2_devices(make_dna, n_dev, k):
    # Non-power-of-two D: the top d_bits can exceed D-1 and must clamp to
    # the last owner (unclamped owners routed codes to nonexistent devices
    # and dropped them silently).
    from dna_kmeres_parallel.models.oracle import count_table_any_k
    from dna_kmeres_parallel.parallel import bucketed
    from dna_kmeres_parallel.parallel.mesh import make_mesh
    from dna_kmeres_parallel.utils import codec

    s = make_dna(900, invalid_frac=0.02)
    flat = codec.encode_bases(s)
    mesh = make_mesh(n_dev)
    shards, n_own = bucketed.shard_stream_with_halo(flat, k, mesh)
    hi, lo, counts, starts, overflow = bucketed.count_bucket_sharded(
        jnp.asarray(shards), jnp.asarray(n_own), k, False, mesh
    )
    assert not bool(overflow)
    codes_u64, counts_np = bucketed.gather_table(hi, lo, counts, starts)
    got = {
        codec.code_to_kmer(int(c), k): int(n)
        for c, n in zip(codes_u64, counts_np)
    }
    assert got == count_table_any_k([s], k)


def test_bucketed_k16_lo_owner_path(make_dna):
    # k=16: hi has zero bits, owners come from lo (use_hi=False) — the
    # general 3-key sort path.
    from dna_kmeres_parallel.models.oracle import count_table_any_k
    from dna_kmeres_parallel.parallel import bucketed
    from dna_kmeres_parallel.parallel.mesh import make_mesh
    from dna_kmeres_parallel.utils import codec

    s = make_dna(600, invalid_frac=0.02)
    flat = codec.encode_bases(s)
    mesh = make_mesh(8)
    shards, n_own = bucketed.shard_stream_with_halo(flat, 16, mesh)
    hi, lo, counts, starts, overflow = bucketed.count_bucket_sharded(
        jnp.asarray(shards), jnp.asarray(n_own), 16, False, mesh
    )
    assert not bool(overflow)
    codes_u64, counts_np = bucketed.gather_table(hi, lo, counts, starts)
    got = {
        codec.code_to_kmer(int(c), 16): int(n)
        for c, n in zip(codes_u64, counts_np)
    }
    assert got == count_table_any_k([s], 16)


def test_bucketed_non_pow2_no_overflow_at_scale(make_dna):
    # Regression (reviewed finding): the clamped bit-shift owner routed up
    # to (2^d_bits - D + 1)x the uniform share to the last owner; at D=5,
    # k=24, 20k bases the send bucket deterministically overflowed. The
    # balanced multiply-shift partition must not.
    from dna_kmeres_parallel.models.oracle import count_table_any_k
    from dna_kmeres_parallel.parallel import bucketed
    from dna_kmeres_parallel.parallel.mesh import make_mesh
    from dna_kmeres_parallel.utils import codec

    s = make_dna(20000)
    flat = codec.encode_bases(s)
    mesh = make_mesh(5)
    shards, n_own = bucketed.shard_stream_with_halo(flat, 24, mesh)
    hi, lo, counts, starts, overflow = bucketed.count_bucket_sharded(
        jnp.asarray(shards), jnp.asarray(n_own), 24, False, mesh
    )
    assert not bool(overflow)
    codes_u64, counts_np = bucketed.gather_table(hi, lo, counts, starts)
    want = count_table_any_k([s], 24)
    got = {
        codec.code_to_kmer(int(c), 24): int(n)
        for c, n in zip(codes_u64, counts_np)
    }
    assert got == want


@pytest.mark.parametrize("k,canonical,owner_mode", [
    (13, False, "prefix"),
    (21, False, "prefix"),
    (21, True, "prefix"),
    (21, False, "minimizer"),
    (31, False, "prefix"),
    (31, False, "minimizer"),
])
def test_bucket_raw_exchange_matches_oracle(make_dna, k, canonical, owner_mode):
    """RAW-exchange variant (one owner-key sort + host radix per owner
    shard) is exact vs the oracle across key layouts and owner modes."""
    from dna_kmeres_parallel.models.oracle import count_table_any_k
    from dna_kmeres_parallel.parallel import bucketed
    from dna_kmeres_parallel.parallel.mesh import make_mesh
    from dna_kmeres_parallel.utils import codec

    seqs = [make_dna(140 + 29 * i, invalid_frac=0.02) for i in range(4)]
    flat = codec.concat_with_sentinels(seqs)
    mesh = make_mesh(8)
    codes, counts = bucketed.count_bucket_sharded_raw(
        flat, k, canonical, mesh, owner_mode=owner_mode
    )
    want = count_table_any_k(seqs, k, canonical)
    got = {codec.code_to_kmer(int(c), k): int(n) for c, n in zip(codes, counts)}
    assert got == want


def test_bucket_raw_matches_aggregated(make_dna):
    """Raw and aggregated exchanges produce bit-identical tables."""
    from dna_kmeres_parallel.parallel import bucketed
    from dna_kmeres_parallel.parallel.mesh import make_mesh
    from dna_kmeres_parallel.utils import codec

    import jax.numpy as jnp

    flat = codec.concat_with_sentinels([make_dna(600, invalid_frac=0.01)])
    mesh = make_mesh(8)
    k = 21
    raw = bucketed.count_bucket_sharded_raw(flat, k, False, mesh)
    shards, n_own = bucketed.shard_stream_with_halo(flat, k, mesh)
    hi, lo, counts, starts, ov = bucketed.count_bucket_sharded(
        jnp.asarray(shards), jnp.asarray(n_own), k, False, mesh
    )
    assert not bool(ov)
    agg = bucketed.gather_table(hi, lo, counts, starts)
    assert np.array_equal(raw[0], agg[0])
    assert np.array_equal(raw[1], agg[1])


def test_bucket_raw_overflow_on_skew(make_dna):
    """A homopolymer routes every window to one owner: the raw exchange's
    window-denominated capacity must overflow DETECTABLY, not corrupt."""
    from dna_kmeres_parallel.parallel import bucketed
    from dna_kmeres_parallel.parallel.mesh import make_mesh
    from dna_kmeres_parallel.utils import codec

    flat = codec.encode_bases("A" * 4000)
    mesh = make_mesh(8)
    with pytest.raises(OverflowError):
        bucketed.count_bucket_sharded_raw(flat, 21, False, mesh)


# ---------------------------------------------------------------------------
# Super-k-mer (minimizer-run) compressed exchange


@pytest.mark.parametrize(
    "k,m,canonical",
    [(16, 9, False), (21, 7, False), (21, 11, True), (31, 7, False), (31, 15, True)],
)
def test_superkmer_matches_oracle(make_dna, mesh8, k, m, canonical):
    seqs = [make_dna(250 + 19 * i, invalid_frac=0.03) for i in range(4)]
    codes, counts = bucketed.count_bucket_sharded_super(
        _flat(seqs), k, canonical, mesh8, minimizer_m=m
    )
    want = oracle.count_table_any_k(seqs, k, canonical=canonical)
    got = {codec.code_to_kmer(int(c), k): int(n) for c, n in zip(codes, counts)}
    assert got == want


def test_superkmer_matches_aggregated(make_dna, mesh8):
    # The compressed exchange and the aggregated exchange must build
    # bit-identical tables from the same stream.
    k = 21
    flat = _flat([make_dna(700, invalid_frac=0.01)])
    sup = bucketed.count_bucket_sharded_super(flat, k, False, mesh8)
    shards, n_own = bucketed.shard_stream_with_halo(flat, k, mesh8)
    hi, lo, counts, starts, overflow = bucketed.count_bucket_sharded(
        jnp.asarray(shards), jnp.asarray(n_own), k, False, mesh8
    )
    assert not bool(overflow)
    agg = bucketed.gather_table(hi, lo, counts, starts)
    assert np.array_equal(sup[0], agg[0])
    assert np.array_equal(sup[1], agg[1])


def test_superkmer_run_structure(make_dna):
    # Leftmost-tie argmin positions are non-decreasing and runs (maximal
    # same-position stretches of valid windows) never exceed k-m+1 windows
    # — the bound the fixed-size record format relies on.
    k, m = 21, 7
    s = make_dna(400, invalid_frac=0.02)
    bases = jnp.asarray(codec.encode_bases(s))
    mini, pos, vwin = bucketed.window_minimizers_pos(bases, k, m)
    pos, vwin = np.asarray(pos), np.asarray(vwin)
    run = 1
    for i in range(1, pos.size):
        if vwin[i] and vwin[i - 1]:
            assert pos[i] >= pos[i - 1]
            run = run + 1 if pos[i] == pos[i - 1] else 1
            assert run <= k - m + 1
        else:
            run = 1


def test_superkmer_expand_roundtrip(make_dna):
    # expand_superkmers is the exact inverse of the device packing: count
    # the expanded stream and compare against a direct count.
    k, m = 21, 7
    mesh1 = make_mesh(1)
    seqs = [make_dna(300), make_dna(150, invalid_frac=0.05)]
    flat = _flat(seqs)
    shards, n_own = bucketed.shard_stream_with_halo(flat, k, mesh1)
    planes, meta, ov = bucketed.exchange_superkmers_bucket_sharded(
        jnp.asarray(shards), jnp.asarray(n_own), k, mesh1, minimizer_m=m
    )
    assert not bool(ov)
    stream = bucketed.expand_superkmers(
        [np.asarray(p)[0] for p in planes], np.asarray(meta)[0], k, m
    )
    codes, valid = codec.kmer_codes(stream, k)
    total = int(valid.sum())
    want = sum(oracle.count_table_any_k(seqs, k).values())
    assert total == want


def test_superkmer_overflow_on_pathological_runs(mesh8):
    # A homopolymer routes every record to ONE owner; unlike the aggregated
    # path there is no pre-RLE, so the single owner's record share blows the
    # fixed capacity and the overflow must surface as an error.
    k = 21
    flat = _flat(["A" * 60000])
    with pytest.raises(OverflowError):
        bucketed.count_bucket_sharded_super(flat, k, False, mesh8)


def test_superkmer_compression_ratio(make_dna, mesh8):
    # The design target (SURVEY.md §5 / STATUS roadmap): >= 2.5x less ICI
    # volume than the raw word exchange on random sequence (analytically
    # ~5.4x at k=31/m=7; slack for run-density variance on small shards).
    k, m = 31, 7
    flat = _flat([make_dna(8000)])
    shards, n_own = bucketed.shard_stream_with_halo(flat, k, mesh8)
    planes, meta, ov = bucketed.exchange_superkmers_bucket_sharded(
        jnp.asarray(shards), jnp.asarray(n_own), k, mesh8, minimizer_m=m
    )
    assert not bool(ov)
    n_records = int((np.asarray(meta) > 0).sum())
    n_windows = int(np.asarray(n_own).sum())
    skmax, W = bucketed.superkmer_geometry(k, m)
    bytes_super = n_records * (W + 1) * 4
    bytes_raw = n_windows * 8  # (u32, u32) split words at k=31
    assert bytes_super * 2.5 < bytes_raw, (bytes_super, bytes_raw)


def test_superkmer_all_invalid_and_empty(mesh8):
    # All-N input: no valid windows, empty table (no crash on zero records).
    k = 21
    flat = np.full(300, codec.INVALID_BASE, np.uint8)
    codes, counts = bucketed.count_bucket_sharded_super(flat, k, False, mesh8)
    assert codes.size == 0 and counts.size == 0


@pytest.mark.parametrize("exchange", ["auto", "raw", "agg", "super"])
def test_bucket_auto_matches_oracle(make_dna, mesh8, exchange):
    from dna_kmeres_parallel.models.oracle import count_table_any_k

    k = 21
    seqs = [make_dna(160 + 13 * i, invalid_frac=0.02) for i in range(4)]
    flat = _flat(seqs)
    codes, cnts = bucketed.count_bucket_auto(
        flat, k, False, mesh8, exchange=exchange
    )
    want = count_table_any_k(seqs, k, False)
    got = {codec.code_to_kmer(int(c), k): int(n) for c, n in zip(codes, cnts)}
    assert got == want


def test_bucket_auto_falls_back_on_skew(mesh8):
    # A homopolymer overflows the raw exchange's window-denominated send
    # capacity (every window shares one owner); 'auto' must fall back to
    # the RLE-aggregated exchange and still produce the exact table.
    k = 21
    flat = codec.encode_bases("A" * 4096)
    with pytest.raises(OverflowError):
        bucketed.count_bucket_sharded_raw(flat, k, False, mesh8)
    codes, cnts = bucketed.count_bucket_auto(flat, k, False, mesh8)
    assert codes.tolist() == [0]
    assert cnts.tolist() == [4096 - k + 1]


@pytest.mark.parametrize("k", [8, 13, 21, 31])
def test_raw_exchange_prefix_fast_matches_engine(make_dna, k):
    # The prefix-fast raw exchange (r4: routing-word sort, no owner
    # operand — including the single-word band where owners come from
    # lo's top bits) must produce the exact single-chip engine table.
    # 80 Kbase streams also cover all-T windows (lo == 0xFFFFFFFF at
    # k >= 16, which must still sort strictly before the hi sentinel).
    from dna_kmeres_parallel.models.sparse_engine import (
        SparseKmerEngine,
    )
    from dna_kmeres_parallel.utils.config import KmerConfig

    s = make_dna(80_000, invalid_frac=0.01) + "T" * 40
    flat = codec.encode_bases(s)
    mesh = make_mesh(8)
    codes, counts = bucketed.count_bucket_sharded_raw(
        flat, k, False, mesh
    )
    want = SparseKmerEngine(KmerConfig(k=k)).count_stream(
        flat, flat.shape[0], 1
    )
    assert np.array_equal(codes, want.codes)
    assert np.array_equal(counts, want.counts)


@pytest.mark.parametrize("k,canonical,owner_mode", [
    (13, False, "prefix"),   # single-word band (owner bits in lo)
    (21, False, "prefix"),   # u16 hi band
    (21, True, "prefix"),
    (31, False, "prefix"),   # u32 hi band — config 5
    (21, False, "minimizer"),  # owner carried as the sort key
    (31, False, "minimizer"),
])
def test_bucket_raw_row_partition_matches_default(make_dna, k, canonical,
                                                  owner_mode):
    """The raw exchange (owner grouping + host radix per owner) must
    produce the bit-identical table to the aggregated exchange (local
    RLE + two multi-key sorts) in every key-word band and owner mode."""
    from dna_kmeres_parallel.models.oracle import count_table_any_k
    from dna_kmeres_parallel.parallel import bucketed
    from dna_kmeres_parallel.parallel.mesh import make_mesh
    from dna_kmeres_parallel.utils import codec

    seqs = [make_dna(150 + 31 * i, invalid_frac=0.02) for i in range(4)]
    flat = codec.concat_with_sentinels(seqs)
    mesh = make_mesh(8)
    base = bucketed.count_bucket_auto(
        flat, k, canonical, mesh, owner_mode=owner_mode, exchange="agg"
    )
    got = bucketed.count_bucket_sharded_raw(
        flat, k, canonical, mesh, owner_mode=owner_mode
    )
    assert np.array_equal(base[0], got[0])
    assert np.array_equal(base[1], got[1])
    want = count_table_any_k(seqs, k, canonical)
    table = {
        codec.code_to_kmer(int(c), k): int(n)
        for c, n in zip(got[0], got[1])
    }
    assert table == want


def test_bucket_raw_positional_runs_survive_row_route(make_dna,
                                                      monkeypatch):
    """A positional same-owner run (homopolymer inside random data) within
    the per-owner slack of the send capacity (2x the uniform share + 64)
    goes through the raw exchange: one exchange call, no overflow, exact
    table."""
    from dna_kmeres_parallel.models.oracle import count_table_any_k
    from dna_kmeres_parallel.parallel import bucketed
    from dna_kmeres_parallel.parallel.mesh import make_mesh
    from dna_kmeres_parallel.utils import codec

    seqs = [make_dna(700), "A" * 100, make_dna(700)]
    flat = codec.concat_with_sentinels(seqs)
    mesh = make_mesh(8)
    calls = []
    real = bucketed.exchange_words_bucket_sharded

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(bucketed, "exchange_words_bucket_sharded", spy)
    codes, counts = bucketed.count_bucket_sharded_raw(
        flat, 21, False, mesh
    )
    assert calls == [1], calls
    want = count_table_any_k(seqs, 21)
    got = {
        codec.code_to_kmer(int(c), 21): int(n)
        for c, n in zip(codes, counts)
    }
    assert got == want


def test_bucket_raw_row_overflow_retries_global_then_raises(make_dna,
                                                            monkeypatch):
    """Value skew past the send capacity (one owner holding ~half of all
    windows): the raw driver runs the exchange once and raises the
    overflow error (count_bucket_auto then takes the aggregated one)."""
    from dna_kmeres_parallel.parallel import bucketed
    from dna_kmeres_parallel.parallel.mesh import make_mesh
    from dna_kmeres_parallel.utils import codec

    seqs = [make_dna(2000), "A" * 40000, make_dna(2000)]
    flat = codec.concat_with_sentinels(seqs)
    mesh = make_mesh(8)
    calls = []
    real = bucketed.exchange_words_bucket_sharded

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(bucketed, "exchange_words_bucket_sharded", spy)
    with pytest.raises(OverflowError):
        bucketed.count_bucket_sharded_raw(flat, 21, False, mesh)
    assert calls == [1], calls


def _cumulative_ops_on_constants(closed_jaxpr) -> list[str]:
    """Cumulative ops (cumsum, cummin, ...) whose operand is a constant of
    the program (derived from literals alone)."""
    found = []

    def walk(jaxpr, const_in=()):
        const = set(const_in)
        for eqn in jaxpr.eqns:
            ins = [
                v for v in eqn.invars if not isinstance(v, jax.extend.core.Literal)
            ]
            if eqn.primitive.name.startswith("cum") and all(
                v in const for v in ins
            ):
                found.append(eqn.primitive.name)
            if all(v in const for v in ins) and not eqn.params.get("jaxpr"):
                const.update(eqn.outvars)
            for p in eqn.params.values():
                inner = getattr(p, "jaxpr", p)
                if hasattr(inner, "eqns"):
                    walk(
                        inner,
                        [
                            iv
                            for iv, ov in zip(inner.invars, eqn.invars)
                            if not isinstance(ov, jax.extend.core.Literal)
                            and ov in const
                        ],
                    )

    walk(closed_jaxpr.jaxpr)
    return found


def test_exchange_has_no_prefix_sum_over_constants(mesh8):
    """XLA's GPU compiler constant-folds a cumsum whose operand is a
    constant as an O(n^2) reduce-window — at millions of windows per
    shard the aggregated exchange then never finishes compiling. The
    exchange must derive unit run lengths from run boundaries instead."""
    shards = jnp.zeros((8, 4096 + 30), jnp.uint8)
    n_own = jnp.full((8,), 4096, jnp.int32)
    jaxpr = jax.make_jaxpr(
        lambda s, n: bucketed.count_bucket_sharded(s, n, 31, False, mesh8)
    )(shards, n_own)
    assert _cumulative_ops_on_constants(jaxpr) == []
    # The detector itself sees a prefix sum of constant ones.
    bad = jax.make_jaxpr(lambda x: jnp.cumsum(jnp.ones(8, jnp.int32)) + x)(1)
    assert _cumulative_ops_on_constants(bad) == ["cumsum"]
