"""Self-calibrating routing constants.

The gates must consume a persisted per-backend calibration — link rates
and route pair rates — with the built-in constants as fallback, and a
test-injected fake calibration must flip the union-distance gate in BOTH
directions with no env overrides.
"""

import json

import numpy as np
import pytest

from dna_kmeres_parallel.models import sparse_engine
from dna_kmeres_parallel.ops import calibrate, distance as dist_ops


@pytest.fixture(autouse=True)
def _fresh_cal(monkeypatch, tmp_path):
    # Each test gets an isolated calibration directory (the calibration
    # lives beside the compile cache) and a clean process cache.
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cal"))
    monkeypatch.delenv("KMER_CALIBRATION_FILE", raising=False)
    calibrate.reset()
    yield
    calibrate.reset()


def _write_cal(tmp_path, monkeypatch, cal: dict) -> None:
    path = tmp_path / "fake_cal.json"
    path.write_text(json.dumps(cal))
    monkeypatch.setenv("KMER_CALIBRATION_FILE", str(path))
    calibrate.reset()


def test_no_calibration_means_frozen_constants():
    # No file and no measurement: the built-in constants.
    assert calibrate.get_calibration() == {}
    assert dist_ops.jnp_time_per_pair(1000) == pytest.approx(
        1000 / dist_ops.DENSE_BIN_PAIRS_PER_SEC
    )


def test_measure_link_cpu(monkeypatch):
    monkeypatch.setenv("KMER_CALIBRATE", "1")
    cal = calibrate.measure_link(size_bytes=1 << 20, reps=1)
    assert cal["roundtrip_s"] > 0
    # CPU "transfers" are memcpy: rates exist and are positive when the
    # differential is clean (jitter may drop a key; both present is the
    # common case).
    for key in ("h2d_bps", "d2h_bps"):
        if key in cal:
            assert cal[key] > 0


def test_get_calibration_measures_and_persists(monkeypatch, tmp_path):
    monkeypatch.setenv("KMER_CALIBRATE", "1")
    cal = calibrate.get_calibration()
    assert "roundtrip_s" in cal
    # Second read loads the persisted file (no re-measure): force
    # measurement off and clear the cache; values must persist.
    monkeypatch.setenv("KMER_CALIBRATE", "0")
    calibrate.reset()
    again = calibrate.get_calibration()
    assert again == cal


def test_time_models_consume_calibrated_rates(tmp_path, monkeypatch):
    base = dist_ops.int8_time_per_pair(4096, 4)
    _write_cal(
        tmp_path,
        monkeypatch,
        {
            "int8_macs_per_sec": dist_ops.INT8_MACS_PER_SEC * 2,
            "dense_bin_pairs_per_sec": dist_ops.DENSE_BIN_PAIRS_PER_SEC
            * 4,
            "tri_bin_pairs_per_sec": dist_ops.TRI_BIN_PAIRS_PER_SEC * 8,
        },
    )
    assert dist_ops.int8_time_per_pair(4096, 4) < base
    assert dist_ops.jnp_time_per_pair(4096) == pytest.approx(
        4096 / (dist_ops.DENSE_BIN_PAIRS_PER_SEC * 4)
    )
    assert dist_ops.tri_time_per_pair(4096) == pytest.approx(
        4096 / (dist_ops.TRI_BIN_PAIRS_PER_SEC * 8)
        + dist_ops.TRI_PAIR_OVERHEAD_S
    )


def _union_fixture(rng, make_dna, n=24):
    genome = make_dna(1200)
    starts = rng.integers(0, len(genome) - 100 + 1, size=n)
    seqs = [genome[s : s + 100] for s in starts]
    return sparse_engine.build_pair_tables(seqs, 21)


def test_union_gate_flips_on_link_calibration(
    rng, make_dna, tmp_path, monkeypatch
):
    """The r4 failure mode, closed: with NO env overrides the union gate
    must follow the MEASURED link — a slow-link calibration keeps the job
    on host, a fast-PCIe calibration sends it to the device."""
    monkeypatch.delenv("KMER_DIST_UNION", raising=False)
    monkeypatch.delenv("KMER_H2D_BPS", raising=False)
    from dna_kmeres_parallel import native

    # Native absent -> the plan gate reaches the cost comparison on CPU
    # (with native present and no accelerator it short-circuits to host).
    monkeypatch.setattr(native, "available", lambda: False)
    codes, cnts, offs = _union_fixture(rng, make_dna)

    _write_cal(
        tmp_path,
        monkeypatch,
        {"h2d_bps": 1e4, "d2h_bps": 1e4, "roundtrip_s": 10.0},
    )
    assert sparse_engine.union_dense_plan(codes, cnts, offs) is None

    _write_cal(
        tmp_path,
        monkeypatch,
        {"h2d_bps": 1e12, "d2h_bps": 1e12, "roundtrip_s": 1e-5},
    )
    plan = sparse_engine.union_dense_plan(codes, cnts, offs)
    assert plan is not None
    # And the env override still wins over the calibration.
    monkeypatch.setenv("KMER_H2D_BPS", "1e4")
    assert sparse_engine.union_dense_plan(codes, cnts, offs) is None


def test_measure_compute_cpu(monkeypatch):
    # The explicit compute calibration runs on CPU too (tiny shapes):
    # rates must be positive and consumable by the models.
    cal = calibrate.measure_compute()
    assert cal["int8_macs_per_sec"] > 0
    assert cal["dense_bin_pairs_per_sec"] > 0
    if "sparse_entry_pairs_per_sec_per_thread" in cal:
        assert cal["sparse_entry_pairs_per_sec_per_thread"] > 0


def test_cli_calibrate_link_only(monkeypatch, tmp_path, capsys):
    from dna_kmeres_parallel import cli

    monkeypatch.setenv("KMER_CALIBRATE", "1")
    rc = cli.main(["calibrate", "--link-only"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "calibration_file" in out and "roundtrip_s" in out
    import os

    assert os.path.exists(out["calibration_file"])
