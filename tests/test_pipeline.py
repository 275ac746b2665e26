"""Streaming counter: metrics, checkpoint/resume, crash recovery."""

import numpy as np
import pytest

from dna_kmeres_parallel.models import oracle
from dna_kmeres_parallel.models.pipeline import StreamingCounter
from dna_kmeres_parallel.utils import checkpoint as ckpt_mod
from dna_kmeres_parallel.utils import fasta
from dna_kmeres_parallel.utils.config import KmerConfig


@pytest.fixture
def fasta_file(tmp_path, make_dna):
    records = [(f">r{i}", make_dna(400 + 31 * i, invalid_frac=0.02)) for i in range(6)]
    path = tmp_path / "in.fasta"
    fasta.write_fasta(path, records)
    return str(path), [s for _, s in records]


def test_dense_run_matches_oracle(fasta_file):
    path, seqs = fasta_file
    result = StreamingCounter(KmerConfig(k=5, batch_bases=512)).run(path)
    want = sum(
        (oracle.count_vector(s, 5) for s in seqs), np.zeros(4**5, np.int64)
    )
    assert np.array_equal(result.hist, want)


def test_sparse_run_matches_oracle(fasta_file):
    path, seqs = fasta_file
    result = StreamingCounter(KmerConfig(k=21, batch_bases=512)).run(path)
    assert result.table() == oracle.count_table_any_k(seqs, 21)


def test_metrics_populated(fasta_file):
    path, seqs = fasta_file
    sc = StreamingCounter(KmerConfig(k=4, batch_bases=256))
    sc.run(path)
    rep = sc.metrics.report()
    assert rep["counters"]["bases"] >= sum(len(s) for s in seqs)
    assert rep["counters"]["batches"] > 1
    assert rep["phase_seconds"]["device"] > 0
    assert rep["phase_seconds"]["parse"] > 0
    assert "bases_per_sec_device" in rep


def test_checkpoint_roundtrip(tmp_path):
    ck = ckpt_mod.CountCheckpoint(
        k=5, canonical=True, cursor=1234, total_bases=999,
        hist=np.arange(4**5, dtype=np.int64),
    )
    path = str(tmp_path / "c.npz")
    ckpt_mod.save_checkpoint(path, ck)
    back = ckpt_mod.load_checkpoint(path)
    assert back.k == 5 and back.canonical and back.cursor == 1234
    assert np.array_equal(back.hist, ck.hist)

    sck = ckpt_mod.CountCheckpoint(
        k=21, canonical=False, cursor=7, total_bases=99,
        sparse_codes=np.array([3, 9], np.uint64),
        sparse_counts=np.array([4, 5], np.int64),
    )
    ckpt_mod.save_checkpoint(path, sck)
    back = ckpt_mod.load_checkpoint(path)
    assert not back.dense
    assert back.sparse_codes.tolist() == [3, 9]


def test_crash_resume_dense(fasta_file, tmp_path):
    path, seqs = fasta_file
    cfg = KmerConfig(k=5, batch_bases=256)
    ckpt = str(tmp_path / "resume.npz")

    # "Crash" after 3 batches (progress checkpointed at the stop boundary).
    sc1 = StreamingCounter(cfg, checkpoint_path=ckpt, max_batches=3)
    sc1.run(path)
    saved = ckpt_mod.load_checkpoint(ckpt)
    assert saved.cursor == 3 * 256

    # Resume with a fresh counter: result must equal the uninterrupted run.
    sc2 = StreamingCounter(cfg, checkpoint_path=ckpt, checkpoint_every_bases=1 << 40)
    result = sc2.run(path)
    assert sc2.metrics.counters.get("resumed_from_base") == saved.cursor
    want = sum(
        (oracle.count_vector(s, 5) for s in seqs), np.zeros(4**5, np.int64)
    )
    assert np.array_equal(result.hist, want)


def test_crash_resume_sparse(fasta_file, tmp_path):
    path, seqs = fasta_file
    cfg = KmerConfig(k=21, batch_bases=256)
    ckpt = str(tmp_path / "resume_sparse.npz")

    sc1 = StreamingCounter(cfg, checkpoint_path=ckpt, max_batches=2)
    sc1.run(path)
    saved = ckpt_mod.load_checkpoint(ckpt)
    assert saved.cursor == 2 * 256

    sc2 = StreamingCounter(cfg, checkpoint_path=ckpt, checkpoint_every_bases=1 << 40)
    result = sc2.run(path)
    assert sc2.metrics.counters.get("resumed_from_base") == saved.cursor
    assert result.table() == oracle.count_table_any_k(seqs, 21)


def test_mismatched_checkpoint_ignored(fasta_file, tmp_path):
    path, seqs = fasta_file
    ckpt = str(tmp_path / "wrongk.npz")
    ckpt_mod.save_checkpoint(
        ckpt,
        ckpt_mod.CountCheckpoint(
            k=7, canonical=False, cursor=50, total_bases=10,
            hist=np.zeros(4**7, np.int64),
        ),
    )
    sc = StreamingCounter(KmerConfig(k=5), checkpoint_path=ckpt)
    result = sc.run(path)  # k mismatch -> fresh count, then overwrites ckpt
    want = sum(
        (oracle.count_vector(s, 5) for s in seqs), np.zeros(4**5, np.int64)
    )
    assert np.array_equal(result.hist, want)
    assert "resumed_from_base" not in sc.metrics.counters


def test_stream_medium_dense_k9_routes_sparse(tmp_path, make_dna):
    # k=9..12 (bins > 2^16) in the streaming counter goes through the
    # sparse row-sorted path and materializes dense at the end — result
    # must equal the oracle dense histogram exactly.
    from dna_kmeres_parallel.models.pipeline import StreamingCounter
    from dna_kmeres_parallel.models import oracle
    from dna_kmeres_parallel.utils import fasta

    records = [(f">r{i}", make_dna(400, invalid_frac=0.02)) for i in range(4)]
    path = tmp_path / "m.fasta"
    fasta.write_fasta(path, records)
    sc = StreamingCounter(KmerConfig(k=9, batch_bases=512))
    result = sc.run(str(path))
    assert result.hist.shape == (1 << 18,)
    want = sum(
        (oracle.count_vector(s, 9) for _, s in records),
        np.zeros(1 << 18, np.int64),
    )
    assert np.array_equal(result.hist, want)
    # sparse-path phases ran (device sort + host compact), not the dense path
    assert "compact" in sc.metrics.phase_seconds


@pytest.mark.parametrize("k", [5, 9, 21])
def test_stream_mesh_dp_matches_single(tmp_path, make_dna, k):
    # KmerConfig.mesh_shape: the streaming counter runs each batch
    # data-parallel over the mesh (dense: ppermute halos + psum; sparse:
    # per-chip row sort + host merge). Results must be bit-identical to
    # the single-device stream.
    from dna_kmeres_parallel.models.pipeline import StreamingCounter
    from dna_kmeres_parallel.utils import fasta

    records = [(f">r{i}", make_dna(300 + 41 * i, invalid_frac=0.02)) for i in range(4)]
    path = tmp_path / "mesh.fasta"
    fasta.write_fasta(path, records)
    single = StreamingCounter(KmerConfig(k=k, batch_bases=512)).run(str(path))
    dp = StreamingCounter(
        KmerConfig(k=k, batch_bases=512, mesh_shape=(8,))
    ).run(str(path))
    if hasattr(single, "hist"):
        assert np.array_equal(single.hist, dp.hist)
    else:
        assert np.array_equal(single.codes, dp.codes)
        assert np.array_equal(single.counts, dp.counts)


@pytest.mark.parametrize("compact", ["host", "device"])
def test_sparse_compact_modes_match_oracle(fasta_file, compact):
    path, seqs = fasta_file
    pytest.importorskip("dna_kmeres_parallel.native")
    from dna_kmeres_parallel import native

    if compact == "host" and not native.available():
        pytest.skip("native engine unavailable")
    result = StreamingCounter(
        KmerConfig(k=21, batch_bases=512, compact=compact)
    ).run(path)
    assert result.table() == oracle.count_table_any_k(seqs, 21)


def test_sparse_compact_auto_races_and_decides(fasta_file):
    """'auto' must host-count exactly one probe batch, record a decision,
    and stay exact (the decided mode is host- and load-dependent)."""
    from dna_kmeres_parallel import native

    if not native.available():
        pytest.skip("native engine unavailable")
    path, seqs = fasta_file
    sc = StreamingCounter(KmerConfig(k=21, batch_bases=256, compact="auto"))
    result = sc.run(path)
    assert result.table() == oracle.count_table_any_k(seqs, 21)
    rep = sc.metrics.report()
    assert rep["counters"]["batches"] >= 5
    assert "compact_host_selected" in rep["counters"]
    assert rep["phase_seconds"].get("host_count", 0) > 0


def test_sparse_compact_auto_switches_to_host_when_device_slow(
    fasta_file, monkeypatch
):
    """Force the race verdict: a delayed fetch_words makes the device route
    lose, so every post-decision batch must go through host_count and the
    table must stay exact."""
    import time as _time

    from dna_kmeres_parallel import native
    from dna_kmeres_parallel.models import sparse_engine

    if not native.available():
        pytest.skip("native engine unavailable")
    real_fetch = sparse_engine.fetch_words

    def slow_fetch(words):
        _time.sleep(0.05)
        return real_fetch(words)

    monkeypatch.setattr(sparse_engine, "fetch_words", slow_fetch)
    path, seqs = fasta_file
    sc = StreamingCounter(KmerConfig(k=21, batch_bases=128, compact="auto"))
    result = sc.run(path)
    assert result.table() == oracle.count_table_any_k(seqs, 21)
    rep = sc.metrics.report()
    assert rep["counters"]["compact_host_selected"] == 1


def test_sparse_compact_auto_flips_when_route_degrades_midstream(
    fasta_file, monkeypatch
):
    """r3 adaptivity contract (VERDICT item 6): the 'auto' decision is
    re-evaluated for the rest of the stream, so a probe-window verdict
    cannot lock a long run into the wrong mode. The host route wins the
    initial race (CPU interpret-mode device is slow), then degrades 100x
    from its 3rd call on — the periodic loser-probe must flip the mode,
    and the table must stay exact across the flip."""
    import time as _time

    from dna_kmeres_parallel import native
    from dna_kmeres_parallel.models import pipeline as pl

    if not native.available():
        pytest.skip("native engine unavailable")
    real = native.count_sparse_host_native
    calls = {"n": 0}

    def degrading(seg, k, canonical):
        calls["n"] += 1
        if calls["n"] >= 3:
            _time.sleep(0.3)
        return real(seg, k, canonical)

    monkeypatch.setattr(native, "count_sparse_host_native", degrading)
    # Frequent probes so the flip happens within the test's batch budget.
    monkeypatch.setattr(pl, "_COMPACT_RECHECK", 4)

    path, seqs = fasta_file
    sc = StreamingCounter(KmerConfig(k=21, batch_bases=128, compact="auto"))
    result = sc.run(path)
    assert result.table() == oracle.count_table_any_k(seqs, 21)
    rep = sc.metrics.report()
    if rep["counters"].get("compact_host_selected") == 1:
        # Host won the initial race; the degradation must flip it.
        assert rep["counters"].get("compact_mode_flips", 0) >= 1


def test_sparse_compact_auto_exact_on_coverage_data(tmp_path, make_dna):
    """30x-coverage synthetic reads through 'auto': exact, with the EWMA
    probe race deciding the route (r5: the duplication-sample RLE
    pre-selection is gone — the hardware A/B showed device-rle losing at
    warm steady state even on the data it was designed for, so 'auto'
    always measures instead of guessing; VERDICT r4 weak #5)."""
    from dna_kmeres_parallel import native
    from dna_kmeres_parallel.utils import fasta as fasta_mod

    if not native.available():
        pytest.skip("native engine unavailable")
    genome = make_dna(300)
    reads = []
    rng = np.random.default_rng(7)
    for i in range(60):  # ~30x coverage of 150-base reads
        s = int(rng.integers(0, len(genome) - 150))
        reads.append((f">r{i}", genome[s : s + 150]))
    path = tmp_path / "cov.fasta"
    fasta_mod.write_fasta(path, reads)
    sc = StreamingCounter(KmerConfig(k=21, batch_bases=2048, compact="auto"))
    result = sc.run(str(path))
    rep = sc.metrics.report()
    assert "compact_rle_selected" not in rep["counters"]
    want = oracle.count_table_any_k([s for _, s in reads], 21)
    assert result.table() == want


def test_sparse_compact_auto_probes_super_subroute(fasta_file, monkeypatch):
    """r4: once the auto race picks the device arm, the super-k-mer D2H
    sub-route gets probed (first batch warms its compile, later ones
    rate it) and the table stays exact whatever the EWMA decides."""
    import time as _time

    from dna_kmeres_parallel import native
    from dna_kmeres_parallel.models import pipeline as pl

    if not native.available():
        pytest.skip("native engine unavailable")
    real = native.count_sparse_host_native
    state = {"calls": 0}

    def slow_host(seg, k, canonical):
        # Slow the HOST-mode probe batch so the device arm wins, but keep
        # the super drain's expand+count path fast (it passes larger
        # sentinel-separated streams, distinguished by the call order).
        state["calls"] += 1
        if state["calls"] <= 2:
            _time.sleep(0.2)
        return real(seg, k, canonical)

    monkeypatch.setattr(native, "count_sparse_host_native", slow_host)
    monkeypatch.setattr(pl, "_COMPACT_RECHECK", 100)  # no host re-probes
    path, seqs = fasta_file
    sc = StreamingCounter(KmerConfig(k=21, batch_bases=128, compact="auto"))
    result = sc.run(path)
    assert result.table() == oracle.count_table_any_k(seqs, 21)
    rep = sc.metrics.report()
    assert rep["counters"].get("compact_host_selected") == 0
    assert rep["counters"].get("compact_super_batches", 0) >= 1


def test_sparse_compact_auto_super_steady_state_with_words_reprobe(
    fasta_file, monkeypatch
):
    """Regression (r4 review): once device_route flips to 'super', the
    periodic WORDS re-probe must restage the words format (a stage_default
    that returns raw again crashed the stream). Force the flip by slowing
    both the host probe and the words drain."""
    import time as _time

    from dna_kmeres_parallel import native
    from dna_kmeres_parallel.models import pipeline as pl
    from dna_kmeres_parallel.models import sparse_engine

    if not native.available():
        pytest.skip("native engine unavailable")
    real_host = native.count_sparse_host_native
    real_compact = sparse_engine.compact_unsorted

    def slow_host(seg, k, canonical):
        # Called by the host-mode probe batch AND by the super drains'
        # expand+count. The probe's seg is one raw 128-base batch
        # (+halo); super's expanded record streams are larger — slow
        # only the probe so the race lands: host slowest, then words,
        # super fastest.
        if seg.shape[0] < 300:
            _time.sleep(0.5)
        return real_host(seg, k, canonical)

    def slow_words_compact(words, k):
        _time.sleep(0.2)  # make the words sub-route the EWMA loser
        return real_compact(words, k)

    monkeypatch.setattr(native, "count_sparse_host_native", slow_host)
    monkeypatch.setattr(
        sparse_engine, "compact_unsorted", slow_words_compact
    )
    monkeypatch.setattr(pl, "_COMPACT_RECHECK", 4)
    path, seqs = fasta_file
    sc = StreamingCounter(KmerConfig(k=21, batch_bases=128, compact="auto"))
    result = sc.run(path)
    assert result.table() == oracle.count_table_any_k(seqs, 21)
    rep = sc.metrics.report()
    assert rep["counters"].get("compact_super_batches", 0) >= 2


def test_distance_checkpoint_refuses_wrong_input_and_short_csv(
    tmp_path, make_dna
):
    """Regression (r4 review): resuming against a different same-shape
    dataset or a damaged (short) CSV must refuse, not corrupt."""
    from dna_kmeres_parallel.models.engine import KmerEngine

    seqs_a = [make_dna(60 + 3 * i) for i in range(12)]
    seqs_b = [make_dna(60 + 3 * i, invalid_frac=0.1) for i in range(12)]
    eng = KmerEngine(KmerConfig(k=3))
    out, ck = tmp_path / "d.csv", tmp_path / "d.ckpt"
    eng.distance_stream_to_csv(
        seqs_a, out, panel_rows=4, checkpoint_path=ck, max_panels=1
    )
    with pytest.raises(ValueError, match="does not match"):
        eng.distance_stream_to_csv(
            seqs_b, out, panel_rows=4, checkpoint_path=ck
        )
    # Damaged CSV (shorter than the durable offset) refuses too.
    data = out.read_bytes()
    out.write_bytes(data[: max(len(data) - 5, 0)])
    with pytest.raises(ValueError, match="shorter than"):
        eng.distance_stream_to_csv(
            seqs_a, out, panel_rows=4, checkpoint_path=ck
        )


def test_compact_device_super_rejects_small_k():
    with pytest.raises(ValueError, match="device-super"):
        KmerConfig(k=3, compact="device-super")
