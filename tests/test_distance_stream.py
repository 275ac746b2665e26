"""Streamed/resumable SPARSE-regime distances (r5, VERDICT missing #1).

The k >= 12 regime gets the same stream/checkpoint/mesh machinery as the
dense regime: panels of packed rows append to the CSV through the shared
writer (models/distance_stream.py); resume after a kill is byte-identical
to a single-shot run; the union-indexed device route rides the virtual
mesh. Every check is a byte-compare against the in-memory
distance_sparse_packed / oracle output.
"""

import json
import os

import numpy as np
import pytest

from dna_kmeres_parallel.models import distance_stream, oracle, sparse_engine
from dna_kmeres_parallel.utils import io as io_mod


@pytest.fixture
def seqs(make_dna):
    return [make_dna(60 + 7 * i, invalid_frac=0.02) for i in range(13)]


def _ref_csv(tmp_path, seqs, k, canonical=False):
    ref = tmp_path / "ref.csv"
    packed = oracle.distance_matrix_packed_sparse(seqs, k, canonical)
    io_mod.write_distances_csv(ref, packed)
    return ref.read_bytes()


def test_sparse_stream_matches_oracle(tmp_path, seqs):
    out = tmp_path / "d.csv"
    r = sparse_engine.distance_sparse_stream_to_csv(
        seqs, 21, out, panel_rows=4
    )
    assert r["completed"] and not r["resumed"]
    assert r["n_pairs"] == 13 * 12 // 2
    assert out.read_bytes() == _ref_csv(tmp_path, seqs, 21)


def test_sparse_stream_kill_and_resume_byte_identical(tmp_path, seqs):
    want = _ref_csv(tmp_path, seqs, 21)
    out, ck = tmp_path / "d.csv", tmp_path / "d.ckpt"
    r1 = sparse_engine.distance_sparse_stream_to_csv(
        seqs, 21, out, panel_rows=3, checkpoint_path=ck, max_panels=2
    )
    assert not r1["completed"]
    # Simulate a kill mid-panel: garbage appended after the durable
    # offset must be truncated away on resume.
    with open(out, "ab") as f:
        f.write(b"0.12")
    r2 = sparse_engine.distance_sparse_stream_to_csv(
        seqs, 21, out, panel_rows=3, checkpoint_path=ck
    )
    assert r2["completed"] and r2["resumed"]
    assert out.read_bytes() == want


def test_sparse_stream_checkpoint_mismatch_refused(tmp_path, seqs):
    out, ck = tmp_path / "d.csv", tmp_path / "d.ckpt"
    sparse_engine.distance_sparse_stream_to_csv(
        seqs, 21, out, panel_rows=3, checkpoint_path=ck, max_panels=1
    )
    other = list(seqs)
    other[-1] = other[-1][:-1] + ("A" if other[-1][-1] != "A" else "C")
    with pytest.raises(ValueError, match="input_sha"):
        sparse_engine.distance_sparse_stream_to_csv(
            other, 21, out, panel_rows=3, checkpoint_path=ck
        )


@pytest.mark.parametrize("impl", ["jnp", "int8", "pallas"])
def test_sparse_stream_union_route_exact(tmp_path, rng, make_dna,
                                         monkeypatch, impl):
    genome = make_dna(1500)
    starts = rng.integers(0, len(genome) - 120 + 1, size=11)
    reads = [genome[s : s + 120] for s in starts]
    monkeypatch.setenv("KMER_DIST_UNION", "1")
    monkeypatch.setenv("KMER_UNION_IMPL", impl)
    if impl == "pallas":
        monkeypatch.setenv("KMER_PALLAS_INTERPRET", "1")
    info = {}
    out = tmp_path / "d.csv"
    r = sparse_engine.distance_sparse_stream_to_csv(
        reads, 21, out, panel_rows=4, info=info
    )
    assert info["route"] == f"union/{impl}"
    assert r["completed"]
    assert out.read_bytes() == _ref_csv(tmp_path, reads, 21)


def test_sparse_stream_union_mesh_byte_identical(tmp_path, rng, make_dna,
                                                 monkeypatch):
    from dna_kmeres_parallel.parallel.mesh import make_mesh

    genome = make_dna(1500)
    starts = rng.integers(0, len(genome) - 120 + 1, size=10)
    reads = [genome[s : s + 120] for s in starts]
    monkeypatch.setenv("KMER_DIST_UNION", "1")
    monkeypatch.setenv("KMER_UNION_IMPL", "int8")
    out = tmp_path / "d.csv"
    info = {}
    sparse_engine.distance_sparse_stream_to_csv(
        reads, 21, out, panel_rows=4, mesh=make_mesh(8), info=info
    )
    assert info["route"] == "union/int8"
    assert out.read_bytes() == _ref_csv(tmp_path, reads, 21)


def test_sparse_stream_row_shards_concat_exact(tmp_path, seqs):
    # Multi-host row sharding: contiguous row blocks streamed to shard
    # files concatenate (in rank order) to the single-shot byte stream.
    want = _ref_csv(tmp_path, seqs, 21)
    S = len(seqs)
    splits = distance_stream.balanced_row_splits(S, 3)
    assert splits[0][0] == 0 and splits[-1][1] == S - 1
    blob = b""
    for p, (lo, hi) in enumerate(splits):
        shard = tmp_path / f"d.part{p}"
        sparse_engine.distance_sparse_stream_to_csv(
            seqs, 21, shard, panel_rows=3, row_lo=lo, row_hi=hi
        )
        blob += shard.read_bytes()
    assert blob == want


def test_balanced_row_splits_properties():
    for S in (2, 3, 7, 100, 5001):
        for P in (1, 2, 3, 8):
            splits = distance_stream.balanced_row_splits(S, P)
            assert splits[0][0] == 0
            assert splits[-1][1] == S - 1
            for (a1, b1), (a2, b2) in zip(splits[:-1], splits[1:]):
                assert b1 == a2
            if S > 200 and P > 1:
                pairs = [
                    sum(S - 1 - i for i in range(a, b)) for a, b in splits
                ]
                total = S * (S - 1) / 2
                for c in pairs:
                    assert c < 1.5 * total / P


def test_cli_sparse_stream_checkpointed(tmp_path, seqs):
    from dna_kmeres_parallel import cli
    from dna_kmeres_parallel.utils import fasta

    path = tmp_path / "in.fasta"
    fasta.write_fasta(path, [(f">s{i}", s) for i, s in enumerate(seqs)])
    out, ck = tmp_path / "d.csv", tmp_path / "d.ckpt"
    rc = cli.main(
        [
            "distance",
            "--k",
            "21",
            str(path),
            "-o",
            str(out),
            "--stream-panel",
            "4",
            "--checkpoint",
            str(ck),
        ]
    )
    assert rc == 0
    assert os.path.exists(ck)
    assert out.read_bytes() == _ref_csv(tmp_path, seqs, 21)


def test_sparse_stream_union_mesh_non_pow2(tmp_path, rng, make_dna,
                                           monkeypatch):
    # Non-power-of-two mesh: the union matrix's power-of-two row count
    # does not divide the axis — the panel path must pad partner rows
    # (zero rows are exact) instead of crashing.
    from dna_kmeres_parallel.parallel.mesh import make_mesh

    genome = make_dna(1200)
    starts = rng.integers(0, len(genome) - 110 + 1, size=9)
    reads = [genome[s : s + 110] for s in starts]
    monkeypatch.setenv("KMER_DIST_UNION", "1")
    monkeypatch.setenv("KMER_UNION_IMPL", "int8")
    out = tmp_path / "d.csv"
    info = {}
    sparse_engine.distance_sparse_stream_to_csv(
        reads, 21, out, panel_rows=4, mesh=make_mesh(6), info=info
    )
    assert info["route"] == "union/int8"
    assert out.read_bytes() == _ref_csv(tmp_path, reads, 21)
