"""Union-indexed dense distance route.

The k >= 12 distance regime has no dense [S, 4^k] matrix, but the
pairwise min-sum only touches codes that OCCUR: re-indexing the
per-sequence sparse tables against the sorted union of distinct codes
yields a [S, D] matrix the existing device (min,+) routes serve
(sparse_engine.union_dense_plan / union_dense_min_sums). These tests pin
exactness against the host two-pointer / oracle on every sub-route, the
routing gates, and the CLI report.
"""

import json

import numpy as np
import pytest

from dna_kmeres_parallel.models import oracle, sparse_engine


def _reads(rng, genome: str, n_reads: int, read_len: int) -> list[str]:
    """High-sharing fixture: reads sliced from one genome string — the
    distinct-code union stays near len(genome), far below S * read_len."""
    starts = rng.integers(0, len(genome) - read_len + 1, size=n_reads)
    return [genome[s : s + read_len] for s in starts]


@pytest.fixture
def shared_reads(rng, make_dna):
    genome = make_dna(2000)
    return _reads(rng, genome, 12, 150)


@pytest.mark.parametrize("impl", ["jnp", "int8", "pallas"])
def test_union_route_exact_k21(shared_reads, monkeypatch, impl):
    monkeypatch.setenv("KMER_DIST_UNION", "1")
    monkeypatch.setenv("KMER_UNION_IMPL", impl)
    if impl == "pallas":
        monkeypatch.setenv("KMER_PALLAS_INTERPRET", "1")
    info = {}
    got = sparse_engine.distance_sparse_packed(
        shared_reads, 21, info=info
    )
    assert info["route"] == f"union/{impl}"
    want = oracle.distance_matrix_packed_sparse(shared_reads, 21)
    assert got.dtype == np.float32
    assert np.array_equal(got, want)


def test_union_route_exact_canonical(shared_reads, monkeypatch):
    monkeypatch.setenv("KMER_DIST_UNION", "1")
    info = {}
    got = sparse_engine.distance_sparse_packed(
        shared_reads, 19, canonical=True, info=info
    )
    assert info["route"].startswith("union/")
    want = oracle.distance_matrix_packed_sparse(
        shared_reads, 19, canonical=True
    )
    assert np.array_equal(got, want)


def test_union_route_exact_midk(shared_reads, monkeypatch):
    # k=13 lives in the sparse regime (dense never feasible); the union
    # route must reproduce the sparse oracle bit-for-bit there too.
    monkeypatch.setenv("KMER_DIST_UNION", "1")
    got = sparse_engine.distance_sparse_packed(shared_reads, 13)
    want = oracle.distance_matrix_packed_sparse(shared_reads, 13)
    assert np.array_equal(got, want)


def test_union_route_with_invalid_bases_and_varied_lengths(
    rng, make_dna, monkeypatch
):
    # Sequences with N runs (dropped windows) and unequal lengths: the
    # union matrix rows carry different totals; finish uses min(L)-k+1.
    monkeypatch.setenv("KMER_DIST_UNION", "1")
    genome = make_dna(1500, invalid_frac=0.03)
    seqs = [
        genome[s : s + 120 + 17 * i]
        for i, s in enumerate(
            rng.integers(0, 800, size=8)
        )
    ]
    got = sparse_engine.distance_sparse_packed(seqs, 17)
    want = oracle.distance_matrix_packed_sparse(seqs, 17)
    assert np.array_equal(got, want)


def test_union_route_with_short_sequences(rng, make_dna, monkeypatch):
    # A sequence shorter than k has an EMPTY table (zero windows): the
    # union matrix row is all zeros and its distances match the host
    # path bit-for-bit (including the shared <=0-denominator finish).
    monkeypatch.setenv("KMER_DIST_UNION", "1")
    genome = make_dna(1200)
    seqs = _reads(rng, genome, 6, 130) + ["ACGTACGT"]  # < k=17
    info = {}
    got = sparse_engine.distance_sparse_packed(seqs, 17, info=info)
    assert info["route"].startswith("union/")
    monkeypatch.setenv("KMER_DIST_UNION", "0")
    want = sparse_engine.distance_sparse_packed(seqs, 17)
    assert np.array_equal(got, want)


def test_union_plan_gates(rng, make_dna, monkeypatch):
    from dna_kmeres_parallel import native

    genome = make_dna(2000)
    seqs = _reads(rng, genome, 10, 150)
    codes, cnts, offs = sparse_engine.build_pair_tables(seqs, 21)

    # Auto mode on a CPU host with the native two-pointer: stays host.
    monkeypatch.delenv("KMER_DIST_UNION", raising=False)
    if native.available():
        assert sparse_engine.union_dense_plan(codes, cnts, offs) is None

    # Forced: plan exists; low-multiplicity read tables pick the int8
    # threshold sub-route (cmax is tiny, one int8 matmul per threshold).
    monkeypatch.setenv("KMER_DIST_UNION", "1")
    plan = sparse_engine.union_dense_plan(codes, cnts, offs)
    assert plan is not None
    assert plan["impl"] == "int8"
    assert plan["D"] == np.unique(codes).shape[0]
    # Bucketed shapes: powers of two, >= the real extents.
    assert plan["Dp"] >= plan["D"] and plan["Dp"] & (plan["Dp"] - 1) == 0
    assert plan["Sp"] >= len(seqs) and plan["Sp"] & (plan["Sp"] - 1) == 0
    # cmax buckets to a power of two >= the true max count.
    assert plan["cmax"] >= int(cnts.max())

    # Disabled wins over forced-consideration defaults.
    monkeypatch.setenv("KMER_DIST_UNION", "0")
    assert sparse_engine.union_dense_plan(codes, cnts, offs) is None

    # The memory budget is a hard ceiling even when forced.
    monkeypatch.setenv("KMER_DIST_UNION", "1")
    assert (
        sparse_engine.union_dense_plan(
            codes, cnts, offs, budget_bytes=1024
        )
        is None
    )

    # int32 exactness gate: a per-sequence window total >= 2^31 refuses.
    big_cnts = cnts.copy()
    big_cnts[0] = 1 << 31
    assert (
        sparse_engine.union_dense_plan(codes, big_cnts, offs) is None
    )

    # cmax past the int8 unroll ceiling drops the int8 candidate.
    big_cnts = cnts.copy()
    big_cnts[:] = np.maximum(big_cnts, 1)
    big_cnts[0] = 1000
    plan = sparse_engine.union_dense_plan(codes, big_cnts, offs)
    assert plan is not None and plan["impl"] != "int8"

    # The engine's int8 env knobs reach the union sub-route selection:
    # DIST_INT8=0 disables the matmul chain, INT8_CMAX caps its unroll.
    monkeypatch.setenv("KMER_DIST_INT8", "0")
    plan = sparse_engine.union_dense_plan(codes, cnts, offs)
    assert plan is not None and plan["impl"] != "int8"
    monkeypatch.delenv("KMER_DIST_INT8", raising=False)
    cap_cnts = cnts.copy()
    cap_cnts[0] = 8
    monkeypatch.setenv("KMER_INT8_CMAX", "4")
    plan = sparse_engine.union_dense_plan(codes, cap_cnts, offs)
    assert plan is not None and plan["impl"] != "int8"
    monkeypatch.delenv("KMER_INT8_CMAX", raising=False)


def test_union_auto_prefers_device_on_accelerator_for_shared_reads(
    rng, make_dna, monkeypatch, tmp_path
):
    # On an accelerator, auto routing must take the union route for a big
    # high-sharing job and keep a tiny job on the host (the fixed dispatch
    # overhead dominates there). The host side of the cost model — thread
    # count and per-thread rate — and the link are injected, so the
    # decision does not depend on the machine running the test.
    import json as _json

    from dna_kmeres_parallel.ops import calibrate, runtime

    cal = tmp_path / "cal.json"
    cal.write_text(
        _json.dumps(
            {
                "h2d_bps": 2e10,
                "d2h_bps": 2e10,
                "roundtrip_s": 1e-4,
                "sparse_entry_pairs_per_sec_per_thread": 3.6e8,
            }
        )
    )
    monkeypatch.setenv("KMER_CALIBRATION_FILE", str(cal))
    calibrate.reset()
    monkeypatch.delenv("KMER_DIST_UNION", raising=False)
    monkeypatch.setattr(
        runtime,
        "backend",
        lambda: runtime.Backend("gpu", "test accelerator", "compiled"),
    )
    genome = make_dna(2000)
    seqs = _reads(rng, genome, 10, 150)
    codes, cnts, offs = sparse_engine.build_pair_tables(seqs, 21)
    # Tiny job (45 pairs): host.
    assert (
        sparse_engine.union_dense_plan(codes, cnts, offs, host_threads=16)
        is None
    )
    # Same tables replicated to S=1280 (819K pairs): device. Codes are
    # per-sequence sorted within each segment, as build_pair_tables
    # produces them.
    reps = 128
    big_offs = np.concatenate(
        [offs[:-1] + i * codes.shape[0] for i in range(reps)]
        + [np.array([reps * codes.shape[0]], dtype=np.int64)]
    )
    big_codes = np.tile(codes, reps)
    big_cnts = np.tile(cnts, reps)
    plan = sparse_engine.union_dense_plan(
        big_codes, big_cnts, big_offs, host_threads=16
    )
    assert plan is not None
    calibrate.reset()


def test_cli_distance_union_route(tmp_path, rng, make_dna, monkeypatch, capsys):
    from dna_kmeres_parallel import cli
    from dna_kmeres_parallel.utils import io as io_mod

    monkeypatch.setenv("KMER_DIST_UNION", "1")
    genome = make_dna(1800)
    seqs = _reads(rng, genome, 9, 140)
    fa = tmp_path / "u.fasta"
    fa.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(seqs)))
    out = tmp_path / "d21.csv"
    rc = cli.main(
        ["distance", str(fa), "--k", "21", "-o", str(out)]
    )
    assert rc == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["engine"].startswith("union/")
    want = oracle.distance_matrix_packed_sparse(seqs, 21)
    ref = tmp_path / "ref.csv"
    io_mod.write_distances_csv(ref, want)
    assert out.read_bytes() == ref.read_bytes()
