"""Multi-host ingestion: record-aligned byte ranges + single-process global path."""

import numpy as np
import pytest

from dna_kmeres_parallel.models import oracle
from dna_kmeres_parallel.parallel import multihost
from dna_kmeres_parallel.parallel.mesh import make_mesh
from dna_kmeres_parallel.utils import fasta
from dna_kmeres_parallel.utils.config import KmerConfig


@pytest.fixture
def big_fasta(tmp_path, make_dna):
    records = [(f">r{i} h", make_dna(200 + (i * 91) % 400)) for i in range(40)]
    path = tmp_path / "multi.fasta"
    fasta.write_fasta(path, records, width=73)
    return str(path), [s for _, s in records]


@pytest.mark.parametrize("n_parts", [1, 2, 3, 5, 8])
def test_ranges_partition_file(big_fasta, n_parts):
    path, seqs = big_fasta
    import os

    ranges = multihost.split_fasta_byte_ranges(path, n_parts)
    assert ranges[0][0] == 0
    assert ranges[-1][1] == os.path.getsize(path)
    for (a1, b1), (a2, b2) in zip(ranges[:-1], ranges[1:]):
        assert b1 == a2  # contiguous, disjoint


@pytest.mark.parametrize("n_parts", [2, 4, 7])
def test_ranges_preserve_all_records(big_fasta, n_parts):
    path, seqs = big_fasta
    ranges = multihost.split_fasta_byte_ranges(path, n_parts)
    gathered = []
    for a, b in ranges:
        gathered.extend(multihost.read_range_records(path, a, b))
    whole = fasta.parse_fasta(path)
    assert [(r.id, r.seq) for r in gathered] == [(r.id, r.seq) for r in whole]


def test_ranges_start_at_headers(big_fasta):
    path, _ = big_fasta
    with open(path, "rb") as f:
        data = f.read()
    for a, _ in multihost.split_fasta_byte_ranges(path, 5)[1:]:
        assert data[a : a + 1] == b">"
        assert data[a - 1 : a] == b"\n"


def test_range_counts_sum_to_whole(big_fasta):
    # Counting each range independently and summing == counting the file:
    # the distributed-ingest exactness contract.
    path, seqs = big_fasta
    k = 5
    total = np.zeros(4**k, np.int64)
    for a, b in multihost.split_fasta_byte_ranges(path, 4):
        recs = multihost.read_range_records(path, a, b)
        for r in recs:
            total += oracle.count_vector(r.seq, k)
    want = sum((oracle.count_vector(s, k) for s in seqs), np.zeros(4**k, np.int64))
    assert np.array_equal(total, want)


def test_count_file_multihost_single_process(big_fasta):
    # process_count()==1 path over the virtual 8-device mesh.
    path, seqs = big_fasta
    cfg = KmerConfig(k=4)
    mesh = make_mesh(8)
    hist, total_bases, n_seqs = multihost.count_file_multihost(path, cfg, mesh)
    want = sum(
        (oracle.count_vector(s, 4) for s in seqs), np.zeros(256, np.int64)
    )
    assert np.array_equal(hist, want)
    assert n_seqs == len(seqs)
    assert total_bases == sum(len(s) for s in seqs)


def test_tiny_file_more_parts_than_records(tmp_path):
    path = tmp_path / "tiny.fasta"
    fasta.write_fasta(path, [(">a", "ACGTACGT")])
    ranges = multihost.split_fasta_byte_ranges(str(path), 8)
    recs = []
    for a, b in ranges:
        recs.extend(multihost.read_range_records(str(path), a, b))
    assert [(r.id, r.seq) for r in recs] == [(">a", "ACGTACGT")]


def test_count_file_multihost_two_processes(tmp_path, make_dna):
    # TRUE multi-process run (SURVEY §4 "distributed without a cluster"):
    # two subprocesses under jax.distributed (gloo CPU collectives), each
    # parsing its record-aligned byte range and psum-merging over the
    # 2-device global mesh. The replicated histogram on EVERY process must
    # equal the whole-file oracle count.
    import os
    import socket
    import subprocess
    import sys

    from dna_kmeres_parallel.models import oracle
    from dna_kmeres_parallel.utils import fasta as fasta_mod

    records = [(f">r{i}", make_dna(120 + 31 * i)) for i in range(7)]
    path = tmp_path / "mp.fasta"
    fasta_mod.write_fasta(path, records)
    k = 6

    with socket.socket() as s:  # free port for the coordinator
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    worker = os.path.join(os.path.dirname(__file__), "mp_worker.py")
    outs = [str(tmp_path / f"out{i}.npz") for i in range(2)]
    env = {
        kk: v
        for kk, v in os.environ.items()
        if kk not in ("XLA_FLAGS",)  # no forced 8-device host count
    }
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", str(port), str(path), str(k), outs[i]],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process workers timed out")
        logs.append(out)
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{logs[i][-2000:]}"

    want = sum(
        (oracle.count_vector(s, k) for _, s in records),
        np.zeros(1 << (2 * k), np.int64),
    )
    for o in outs:
        got = np.load(o)
        assert 1 <= int(got["n_seqs"]) <= 7  # this process's range share
        assert np.array_equal(got["hist"].astype(np.int64), want)


def test_bucketed_all_to_all_two_processes(tmp_path, make_dna):
    # Config-5 path truly distributed: the fixed-capacity all_to_all code
    # exchange runs over a 2-process gloo mesh; merged per-device tables
    # must equal the whole-file oracle table at k=21.
    import os
    import socket
    import subprocess
    import sys

    from dna_kmeres_parallel.models.oracle import count_table_any_k
    from dna_kmeres_parallel.utils import codec
    from dna_kmeres_parallel.utils import fasta as fasta_mod

    records = [(f">r{i}", make_dna(150 + 41 * i)) for i in range(4)]
    path = tmp_path / "mpb.fasta"
    fasta_mod.write_fasta(path, records)
    k = 21

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = os.path.join(os.path.dirname(__file__), "mp_worker.py")
    outs = [str(tmp_path / f"bout{i}.npz") for i in range(2)]
    env = {kk: v for kk, v in os.environ.items() if kk not in ("XLA_FLAGS",)}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", str(port), str(path), str(k),
             outs[i], "bucketed"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("bucketed multi-process workers timed out")
        logs.append(out)
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{logs[i][-2000:]}"

    want = count_table_any_k([s for _, s in records], k)
    for o in outs:
        got = np.load(o)
        table = {
            codec.code_to_kmer(int(c), k): int(n)
            for c, n in zip(got["codes"], got["counts"])
        }
        assert table == want


def test_bucketed_raw_exchange_two_processes(tmp_path, make_dna):
    # The RAW exchange truly distributed: unsorted word planes cross the
    # 2-process gloo all_to_all; each process radix-compacts its own
    # device's plane, and the per-process sub-tables merged here must
    # equal the whole-file oracle table at k=21.
    import os
    import socket
    import subprocess
    import sys

    from dna_kmeres_parallel.models.oracle import count_table_any_k
    from dna_kmeres_parallel.models.sparse_engine import merge_sparse_tables
    from dna_kmeres_parallel.utils import codec
    from dna_kmeres_parallel.utils import fasta as fasta_mod

    records = [(f">r{i}", make_dna(150 + 41 * i)) for i in range(4)]
    path = tmp_path / "mpr.fasta"
    fasta_mod.write_fasta(path, records)
    k = 21

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = os.path.join(os.path.dirname(__file__), "mp_worker.py")
    outs = [str(tmp_path / f"rout{i}.npz") for i in range(2)]
    env = {kk: v for kk, v in os.environ.items() if kk not in ("XLA_FLAGS",)}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", str(port), str(path), str(k),
             outs[i], "bucketed_raw"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("bucketed raw multi-process workers timed out")
        logs.append(out)
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{logs[i][-2000:]}"

    tables = []
    for o in outs:
        got = np.load(o)
        tables.append(
            (got["codes"].astype(np.uint64), got["counts"].astype(np.int64))
        )
    codes, counts = merge_sparse_tables(tables)
    want = count_table_any_k([s for _, s in records], k)
    table = {
        codec.code_to_kmer(int(c), k): int(n) for c, n in zip(codes, counts)
    }
    assert table == want


def test_make_global_stream_sub_mesh(make_dna):
    """A mesh smaller than the local device count must still shard
    (review regression: pad divisor was the local device count)."""
    from dna_kmeres_parallel.parallel import multihost
    from dna_kmeres_parallel.parallel.mesh import make_mesh
    from dna_kmeres_parallel.utils import codec

    mesh = make_mesh(3)
    flat = codec.encode_bases(make_dna(10))
    g = multihost.make_global_stream(flat, mesh)
    assert g.shape[0] % 3 == 0


def test_multihost_resumable_single_process(big_fasta, tmp_path):
    """Batched checkpointed dense count: stop after 2 steps, resume, and
    the final histogram must equal both the oracle and a no-checkpoint
    run (integer merges are bit-exact at any step split)."""
    path, seqs = big_fasta
    cfg = KmerConfig(k=4)
    mesh = make_mesh(8)
    ckpt = str(tmp_path / "mh_ck")
    batch = 2048

    hist1, _, _, steps_done, n_steps = multihost.count_file_multihost_resumable(
        path, cfg, mesh, checkpoint_path=ckpt, batch_bases=batch, max_steps=2
    )
    assert steps_done == 2 and n_steps > 2

    hist2, total_bases, n_seqs, steps_done2, _ = (
        multihost.count_file_multihost_resumable(
            path, cfg, mesh, checkpoint_path=ckpt, batch_bases=batch
        )
    )
    assert steps_done2 == n_steps
    want = sum(
        (oracle.count_vector(s, 4) for s in seqs), np.zeros(256, np.int64)
    )
    assert np.array_equal(hist2, want)
    assert n_seqs == len(seqs)

    hist3, *_ = multihost.count_file_multihost_resumable(
        path, cfg, mesh, batch_bases=batch
    )
    assert np.array_equal(hist3, want)


def test_multihost_resumable_rejects_stale_checkpoint(big_fasta, tmp_path):
    """A checkpoint from a different k or an incompatible batch size must
    be ignored, not silently resumed into a wrong histogram."""
    path, seqs = big_fasta
    mesh = make_mesh(8)
    ckpt = str(tmp_path / "mh_ck2")
    multihost.count_file_multihost_resumable(
        path, KmerConfig(k=4), mesh, checkpoint_path=ckpt,
        batch_bases=2048, max_steps=2,
    )
    # different k: stale files ignored, full recount, exact
    hist, *_ = multihost.count_file_multihost_resumable(
        path, KmerConfig(k=5), mesh, checkpoint_path=ckpt, batch_bases=2048
    )
    want = sum(
        (oracle.count_vector(s, 5) for s in seqs), np.zeros(4**5, np.int64)
    )
    assert np.array_equal(hist, want)
    # incompatible batch (saved cursor not divisible): ignored, exact
    hist2, *_ = multihost.count_file_multihost_resumable(
        path, KmerConfig(k=4), mesh, checkpoint_path=ckpt, batch_bases=1500
    )
    want4 = sum(
        (oracle.count_vector(s, 4) for s in seqs), np.zeros(256, np.int64)
    )
    assert np.array_equal(hist2, want4)


def test_multihost_resumable_two_processes_kill_and_resume(tmp_path, make_dna):
    """The VERDICT item-6 contract: a 2-process gloo run killed after 2
    steps, then restarted, must resume from the common checkpoint and
    produce the identical whole-file histogram on every process."""
    import os
    import socket
    import subprocess
    import sys

    from dna_kmeres_parallel.utils import fasta as fasta_mod

    records = [(f">r{i}", make_dna(400 + 61 * i)) for i in range(8)]
    path = tmp_path / "mres.fasta"
    fasta_mod.write_fasta(path, records)
    k = 5
    ckpt = str(tmp_path / "mh2p_ck")
    worker = os.path.join(os.path.dirname(__file__), "mp_worker.py")
    env = {kk: v for kk, v in os.environ.items() if kk not in ("XLA_FLAGS",)}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def run(mode, outs):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [
            subprocess.Popen(
                [sys.executable, worker, str(i), "2", str(port), str(path),
                 str(k), outs[i], mode],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env,
            )
            for i in range(2)
        ]
        logs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                pytest.fail("resumable multi-process workers timed out")
            logs.append(out)
        for i, p in enumerate(procs):
            assert p.returncode == 0, f"worker {i} failed:\n{logs[i][-2000:]}"

    outs_a = [str(tmp_path / f"ra{i}.npz") for i in range(2)]
    run(f"resumable_kill:{ckpt}:512:2", outs_a)
    for o in outs_a:
        got = np.load(o)
        assert int(got["steps_done"]) == 2 < int(got["n_steps"])

    outs_b = [str(tmp_path / f"rb{i}.npz") for i in range(2)]
    run(f"resumable:{ckpt}:512", outs_b)
    want = sum(
        (oracle.count_vector(s, k) for _, s in records),
        np.zeros(1 << (2 * k), np.int64),
    )
    for o in outs_b:
        got = np.load(o)
        assert int(got["steps_done"]) == int(got["n_steps"])
        assert np.array_equal(got["hist"].astype(np.int64), want)


def test_bucketed_resumable_single_process(big_fasta, tmp_path):
    """Checkpointed bucket-sharded sparse count (config 5 + resume): stop
    after 2 steps, resume, and the final table must equal both the oracle
    and a no-checkpoint run (integer merges are bit-exact at any split)."""
    from dna_kmeres_parallel.models.oracle import count_table_any_k
    from dna_kmeres_parallel.utils import codec

    path, seqs = big_fasta
    k = 17
    cfg = KmerConfig(k=k)
    mesh = make_mesh(8)
    ckpt = str(tmp_path / "bkt_ck")
    batch = 2048

    c1, n1, _, _, steps_done, n_steps = (
        multihost.count_file_bucketed_multihost_resumable(
            path, cfg, mesh, checkpoint_path=ckpt, batch_bases=batch,
            max_steps=2,
        )
    )
    assert steps_done == 2 and n_steps > 2

    codes, counts, total_bases, n_seqs, steps_done2, _ = (
        multihost.count_file_bucketed_multihost_resumable(
            path, cfg, mesh, checkpoint_path=ckpt, batch_bases=batch
        )
    )
    assert steps_done2 == n_steps
    want = count_table_any_k(seqs, k)
    got = {
        codec.code_to_kmer(int(c), k): int(n) for c, n in zip(codes, counts)
    }
    assert got == want
    assert n_seqs == len(seqs)

    c3, n3, *_ = multihost.count_file_bucketed_multihost_resumable(
        path, cfg, mesh, batch_bases=batch
    )
    assert np.array_equal(c3, codes) and np.array_equal(n3, counts)


def test_bucketed_resumable_two_processes_kill_and_resume(tmp_path, make_dna):
    """The VERDICT r2 item-5 contract: a 2-process gloo bucket-sharded
    sparse run killed after 2 steps, then restarted, must resume from the
    common checkpoint and produce the bit-identical global table."""
    import os
    import socket
    import subprocess
    import sys

    from dna_kmeres_parallel.models.oracle import count_table_any_k
    from dna_kmeres_parallel.models.sparse_engine import (
        merge_sparse_tables,
    )
    from dna_kmeres_parallel.utils import codec
    from dna_kmeres_parallel.utils import fasta as fasta_mod

    records = [(f">r{i}", make_dna(400 + 61 * i)) for i in range(8)]
    path = tmp_path / "bres.fasta"
    fasta_mod.write_fasta(path, records)
    k = 17
    ckpt = str(tmp_path / "bkt2p_ck")
    worker = os.path.join(os.path.dirname(__file__), "mp_worker.py")
    env = {kk: v for kk, v in os.environ.items() if kk not in ("XLA_FLAGS",)}
    env["PYTHONPATH"] = os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))
    )

    def run(mode, outs):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [
            subprocess.Popen(
                [sys.executable, worker, str(i), "2", str(port), str(path),
                 str(k), outs[i], mode],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env,
            )
            for i in range(2)
        ]
        logs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                pytest.fail("bucketed resumable workers timed out")
            logs.append(out)
        for i, p in enumerate(procs):
            assert p.returncode == 0, f"worker {i} failed:\n{logs[i][-2000:]}"

    outs_a = [str(tmp_path / f"ba{i}.npz") for i in range(2)]
    run(f"bktresume_kill:{ckpt}:512:2", outs_a)
    for o in outs_a:
        got = np.load(o)
        assert int(got["steps_done"]) == 2 < int(got["n_steps"])

    outs_b = [str(tmp_path / f"bb{i}.npz") for i in range(2)]
    run(f"bktresume:{ckpt}:512", outs_b)
    tables = []
    for o in outs_b:
        got = np.load(o)
        assert int(got["steps_done"]) == int(got["n_steps"])
        tables.append(
            (got["codes"].astype(np.uint64), got["counts"].astype(np.int64))
        )
    codes, counts = merge_sparse_tables(tables)
    want = count_table_any_k([s for _, s in records], k)
    got_tbl = {
        codec.code_to_kmer(int(c), k): int(n) for c, n in zip(codes, counts)
    }
    assert got_tbl == want

    # A clean single-shot run must be bit-identical per process.
    outs_c = [str(tmp_path / f"bc{i}.npz") for i in range(2)]
    run(f"bktresume:{tmp_path / 'bkt_clean'}:512", outs_c)
    for ob, oc in zip(outs_b, outs_c):
        gb, gc = np.load(ob), np.load(oc)
        assert np.array_equal(gb["codes"], gc["codes"])
        assert np.array_equal(gb["counts"], gc["counts"])


def test_bucketed_resumable_planes_route(big_fasta, tmp_path, monkeypatch):
    """The r4 v2 plane-staged route through the multihost bucketed path
    (interpret-mode Pallas; single process on the virtual mesh): exact vs
    the XLA route's table."""
    from dna_kmeres_parallel.utils import codec

    monkeypatch.setenv("KMER_PALLAS_INTERPRET", "1")
    path, seqs = big_fasta
    k = 17
    cfg = KmerConfig(k=k)
    mesh = make_mesh(8)
    codes, counts, *_ = multihost.count_file_bucketed_multihost_resumable(
        path, cfg, mesh, batch_bases=2048
    )
    monkeypatch.delenv("KMER_PALLAS_INTERPRET")
    c2, n2, *_ = multihost.count_file_bucketed_multihost_resumable(
        path, KmerConfig(k=k, use_pallas=False), mesh, batch_bases=2048
    )
    assert np.array_equal(codes, c2) and np.array_equal(counts, n2)


def test_distance_multihost_single_process(big_fasta, tmp_path):
    # Single-process path of the r5 multi-host distance engine: rank 0
    # owns every row; the stitched CSV must be byte-identical to the
    # oracle CSV (dense regime, k=5).
    from dna_kmeres_parallel.utils import io as io_mod

    path, seqs = big_fasta
    out = tmp_path / "d.csv"
    report = multihost.distance_file_multihost_resumable(
        path, KmerConfig(k=5), str(out), panel_rows=16
    )
    assert report["all_complete"] and report["regime"] == "dense"
    ref = tmp_path / "ref.csv"
    io_mod.write_distances_csv(
        ref, oracle.distance_matrix_packed(seqs, 5)
    )
    assert out.read_bytes() == ref.read_bytes()


def test_distance_multihost_two_processes_kill_and_resume(tmp_path, make_dna):
    """r5 VERDICT missing #2: TRUE 2-process gloo distances — row-range
    ownership, per-process shard CSVs + checkpoints, kill after 1 panel,
    resume, rank-0 stitch — byte-identical to the single-process sparse
    CSV at k=21."""
    import os
    import socket
    import subprocess
    import sys

    from dna_kmeres_parallel.models import oracle as oracle_mod
    from dna_kmeres_parallel.utils import fasta as fasta_mod
    from dna_kmeres_parallel.utils import io as io_mod

    records = [(f">r{i}", make_dna(90 + 13 * i)) for i in range(10)]
    path = tmp_path / "mdist.fasta"
    fasta_mod.write_fasta(path, records)
    k = 21
    csv = str(tmp_path / "mdist_out.csv")
    worker = os.path.join(os.path.dirname(__file__), "mp_worker.py")
    env = {kk: v for kk, v in os.environ.items() if kk not in ("XLA_FLAGS",)}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def run(mode, outs):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [
            subprocess.Popen(
                [sys.executable, worker, str(i), "2", str(port), str(path),
                 str(k), outs[i], mode],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env,
            )
            for i in range(2)
        ]
        logs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                pytest.fail("distance multi-process workers timed out")
            logs.append(out)
        for i, p in enumerate(procs):
            assert p.returncode == 0, f"worker {i} failed:\n{logs[i][-2000:]}"

    outs_a = [str(tmp_path / f"da{i}.npz") for i in range(2)]
    run(f"dist:{csv}:1:1", outs_a)  # killed after ONE panel each
    for o in outs_a:
        got = np.load(o)
        assert not int(got["completed"])
        assert not int(got["all_complete"])
    assert not os.path.exists(csv)  # no stitch before completion

    outs_b = [str(tmp_path / f"db{i}.npz") for i in range(2)]
    run(f"dist:{csv}:1", outs_b)
    rows = []
    for o in outs_b:
        got = np.load(o)
        assert int(got["completed"]) and int(got["all_complete"])
        rows.append(tuple(got["rows"].tolist()))
    # Row ranges partition [0, S-1) contiguously.
    S = len(records)
    assert rows[0][0] == 0 and rows[1][1] == S - 1
    assert rows[0][1] == rows[1][0]

    ref = tmp_path / "ref.csv"
    io_mod.write_distances_csv(
        ref,
        oracle_mod.distance_matrix_packed_sparse(
            [s for _, s in records], k
        ),
    )
    with open(csv, "rb") as f:
        assert f.read() == ref.read_bytes()


def test_distance_multihost_two_processes_dense_regime(tmp_path, make_dna):
    """The dense regime (small k) through the same 2-process row-sharded
    protocol: stitched CSV byte-identical to the oracle's."""
    import os
    import socket
    import subprocess
    import sys

    from dna_kmeres_parallel.models import oracle as oracle_mod
    from dna_kmeres_parallel.utils import fasta as fasta_mod
    from dna_kmeres_parallel.utils import io as io_mod

    records = [(f">r{i}", make_dna(80 + 11 * i)) for i in range(9)]
    path = tmp_path / "mdistd.fasta"
    fasta_mod.write_fasta(path, records)
    k = 5
    csv = str(tmp_path / "mdistd_out.csv")
    worker = os.path.join(os.path.dirname(__file__), "mp_worker.py")
    env = {kk: v for kk, v in os.environ.items() if kk not in ("XLA_FLAGS",)}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", str(port), str(path),
             str(k), str(tmp_path / f"dd{i}.npz"), f"dist:{csv}:2"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("dense distance multi-process workers timed out")
        logs.append(out)
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{logs[i][-2000:]}"
    for i in range(2):
        got = np.load(tmp_path / f"dd{i}.npz")
        assert int(got["completed"]) and int(got["all_complete"])

    ref = tmp_path / "refd.csv"
    io_mod.write_distances_csv(
        ref, oracle.distance_matrix_packed([s for _, s in records], k)
    )
    with open(csv, "rb") as f:
        assert f.read() == ref.read_bytes()
