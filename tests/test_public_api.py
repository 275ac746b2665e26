"""Top-level library API (the package boundary users import)."""

import numpy as np
import pytest

import dna_kmeres_parallel as dkp
from dna_kmeres_parallel.models import oracle
from dna_kmeres_parallel.utils import fasta


def test_count_sequences_dense(make_dna):
    seqs = [make_dna(200) for _ in range(3)]
    r = dkp.count_sequences(seqs, k=5)
    want = sum(
        (oracle.count_vector(s, 5) for s in seqs), np.zeros(4**5, np.int64)
    )
    assert np.array_equal(r.hist, want)


def test_count_sequences_sparse(make_dna):
    seqs = [make_dna(300)]
    r = dkp.count_sequences(seqs, k=21)
    assert r.table() == oracle.count_table_any_k(seqs, 21)


def test_count_file_and_distance_file(tmp_path, make_dna):
    records = [(f">r{i}", make_dna(150)) for i in range(4)]
    path = tmp_path / "a.fasta"
    fasta.write_fasta(path, records)
    r = dkp.count_file(str(path), k=4)
    assert r.n_seqs == 4
    d = dkp.distance_file(str(path), k=3)
    want = oracle.distance_matrix_packed([s for _, s in records], 3)
    assert np.array_equal(d.packed, want)


def test_engine_kernel_compile_error_propagates(make_dna, monkeypatch):
    # A kernel that fails to compile is an error, not a route change: the
    # distance run raises instead of quietly taking XLA's (min,+).
    import dna_kmeres_parallel.models.engine as engine_mod
    from dna_kmeres_parallel.models.engine import KmerEngine
    from dna_kmeres_parallel.utils.config import KmerConfig

    def broken(*a, **kw):
        raise RuntimeError("INTERNAL: Triton compilation failed")

    monkeypatch.setattr(
        engine_mod.distance_pallas, "min_sum_matrix_pallas", broken
    )
    monkeypatch.setenv("KMER_PALLAS_INTERPRET", "1")  # route the kernel
    seqs = [make_dna(120) for _ in range(4)]
    with pytest.raises(RuntimeError, match="Triton"):
        KmerEngine(KmerConfig(k=3)).distance_sequences(seqs)


def test_union_host_alloc_failure_degrades_and_is_counted(
    make_dna, monkeypatch, rng
):
    # The one degrade left: a device route that cannot allocate falls back
    # to the host two-pointer, exact, and is counted in runtime.DEGRADES.
    from dna_kmeres_parallel.models import sparse_engine
    from dna_kmeres_parallel.ops import runtime

    def oom(*a, **kw):
        raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")

    monkeypatch.setattr(sparse_engine, "union_dense_min_sums", oom)
    monkeypatch.setattr(runtime, "DEGRADES", {})
    monkeypatch.setenv("KMER_DIST_UNION", "1")
    genome = make_dna(1500)
    seqs = [genome[s : s + 120] for s in rng.integers(0, 1300, size=6)]
    info = {}
    got = sparse_engine.distance_sparse_packed(seqs, 21, info=info)
    assert info["route"] == "host/sparse"
    assert runtime.DEGRADES == {"union": 1}
    assert np.array_equal(got, oracle.distance_matrix_packed_sparse(seqs, 21))


def test_cli_merge_and_histo(tmp_path, make_dna, monkeypatch):
    # merge: two per-file npz tables combine into the whole-input table;
    # histo: the spectrum sums to the distinct count.
    import json
    import os
    import subprocess
    import sys

    from dna_kmeres_parallel.models import oracle as oracle_mod
    from dna_kmeres_parallel.utils import fasta as fasta_mod

    seqs_a = [make_dna(200) for _ in range(3)]
    seqs_b = [make_dna(150) for _ in range(2)]
    pa, pb = tmp_path / "a.fasta", tmp_path / "b.fasta"
    fasta_mod.write_fasta(pa, [(f">a{i}", s) for i, s in enumerate(seqs_a)])
    fasta_mod.write_fasta(pb, [(f">b{i}", s) for i, s in enumerate(seqs_b)])

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"

    def run(*argv):
        r = subprocess.run(
            [sys.executable, "-m", "dna_kmeres_parallel.cli", *argv],
            capture_output=True, text=True, env=env, timeout=300,
        )
        assert r.returncode == 0, r.stdout + r.stderr
        return json.loads(r.stdout.strip().splitlines()[-1])

    k = 17
    run("count", "--k", str(k), str(pa), "-o", str(tmp_path / "a.npz"))
    run("count", "--k", str(k), str(pb), "-o", str(tmp_path / "b.npz"))
    rep = run(
        "merge", str(tmp_path / "a.npz"), str(tmp_path / "b.npz"),
        "-o", str(tmp_path / "m.csv"),
    )
    want = oracle_mod.count_table_any_k(seqs_a + seqs_b, k)
    assert rep["total_kmers"] == sum(want.values())
    assert rep["distinct_kmers"] == len(want)
    got = {}
    with open(tmp_path / "m.csv") as f:
        next(f)
        for line in f:
            kmer, n = line.strip().split(",")
            got[kmer] = int(n)
    assert got == want

    rep = run(
        "histo", "--k", str(k), str(pa), str(pb),
        "-o", str(tmp_path / "spec.tsv"),
    )
    assert rep["distinct_kmers"] == len(want)
    assert rep["total_kmers"] == sum(want.values())
    spec = {}
    with open(tmp_path / "spec.tsv") as f:
        for line in f:
            i, n = line.strip().split("\t")
            spec[int(i)] = int(n)
    from collections import Counter
    want_spec = Counter(want.values())
    for i, n in want_spec.items():
        assert spec[i] == n
    assert sum(spec.values()) == len(want)


def test_cli_histo_multi_npz_and_oracle(tmp_path, make_dna):
    import json
    import os
    import subprocess
    import sys

    from dna_kmeres_parallel.models import oracle as oracle_mod
    from dna_kmeres_parallel.utils import fasta as fasta_mod

    seqs = [make_dna(180) for _ in range(3)]
    pa = tmp_path / "h.fasta"
    fasta_mod.write_fasta(pa, [(f">h{i}", s) for i, s in enumerate(seqs)])
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"

    def run(*argv, expect_rc=0):
        r = subprocess.run(
            [sys.executable, "-m", "dna_kmeres_parallel.cli", *argv],
            capture_output=True, text=True, env=env, timeout=300,
        )
        assert r.returncode == expect_rc, r.stdout + r.stderr
        return json.loads(r.stdout.strip().splitlines()[-1]) if expect_rc == 0 else None

    k = 15
    run("count", "--k", str(k), str(pa), "-o", str(tmp_path / "h1.npz"))
    run("count", "--k", str(k), str(pa), "-o", str(tmp_path / "h2.npz"))
    # two npz inputs: merged table = doubled counts
    rep = run("histo", str(tmp_path / "h1.npz"), str(tmp_path / "h2.npz"))
    want = oracle_mod.count_table_any_k(seqs, k)
    assert rep["distinct_kmers"] == len(want)
    assert rep["total_kmers"] == 2 * sum(want.values())
    # mixed npz + fasta inputs rejected
    run("histo", str(tmp_path / "h1.npz"), str(pa), expect_rc=2)
    # oracle engine honored
    rep = run("histo", "--engine", "oracle", "--k", str(k), str(pa))
    assert rep["total_kmers"] == sum(want.values())


def test_cli_query_and_min_count(tmp_path, make_dna, capsys):
    import json

    from dna_kmeres_parallel import cli
    from dna_kmeres_parallel.models import oracle
    from dna_kmeres_parallel.utils import fasta

    seqs = [make_dna(120) for _ in range(3)]
    path = tmp_path / "q.fasta"
    fasta.write_fasta(path, [(f">r{i}", s) for i, s in enumerate(seqs)])
    npz = tmp_path / "t.npz"
    assert cli.main(["count", "--k", "17", str(path), "-o", str(npz)]) == 0
    capsys.readouterr()
    want = oracle.count_table_any_k(seqs, 17)
    some = list(want.items())[:5] + [("A" * 17, want.get("A" * 17, 0))]
    assert cli.main(["query", str(npz)] + [m for m, _ in some]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["k"] == 17
    for m, c in some:
        assert got["counts"][m] == c
    # invalid k-mer -> clean error
    assert cli.main(["query", str(npz), "NOTAKMER"]) == 2
    capsys.readouterr()

    # min-count: repeats survive, singletons are dropped from the output
    s = make_dna(60)
    path2 = tmp_path / "m.fasta"
    fasta.write_fasta(path2, [(">a", s + s), (">b", make_dna(40))])
    out = tmp_path / "f.csv"
    assert (
        cli.main(
            ["count", "--k", "13", str(path2), "-o", str(out), "--min-count", "2"]
        )
        == 0
    )
    rep = json.loads(capsys.readouterr().out)
    assert rep["min_count"] == 2 and rep["distinct_kept"] < rep["distinct_kmers"]
    table = {
        line.split(",")[0]: int(line.split(",")[1])
        for line in out.read_text().strip().splitlines()[1:]
    }
    assert table and all(c >= 2 for c in table.values())
    full = oracle.count_table_any_k([s + s, ""], 13)
    for m, c in full.items():
        if c >= 2:
            assert table.get(m, 0) >= 2


def test_cli_min_count_dense_npz(tmp_path, make_dna, capsys):
    import json

    import numpy as np

    from dna_kmeres_parallel import cli
    from dna_kmeres_parallel.utils import fasta

    s = make_dna(50)
    path = tmp_path / "d.fasta"
    fasta.write_fasta(path, [(">a", s * 3)])
    npz = tmp_path / "d.npz"
    assert (
        cli.main(["count", "--k", "4", str(path), "-o", str(npz), "--min-count", "3"])
        == 0
    )
    capsys.readouterr()
    with np.load(npz) as z:
        hist = z["hist"]
    assert hist.max() >= 3
    assert not ((hist > 0) & (hist < 3)).any()


def test_cli_merge_set_ops(tmp_path, make_dna, capsys):
    import json

    from dna_kmeres_parallel import cli
    from dna_kmeres_parallel.models import oracle
    from dna_kmeres_parallel.utils import fasta

    a, b = make_dna(150), make_dna(150)
    shared = make_dna(60)
    pa, pb = tmp_path / "a.fasta", tmp_path / "b.fasta"
    fasta.write_fasta(pa, [(">a", a + shared)])
    fasta.write_fasta(pb, [(">b", b + shared)])
    na, nb = tmp_path / "a.npz", tmp_path / "b.npz"
    k = 15
    assert cli.main(["count", "--k", str(k), str(pa), "-o", str(na)]) == 0
    assert cli.main(["count", "--k", str(k), str(pb), "-o", str(nb)]) == 0
    capsys.readouterr()

    ta = oracle.count_table_any_k([a + shared], k)
    tb = oracle.count_table_any_k([b + shared], k)

    out = tmp_path / "i.csv"
    assert cli.main(["merge", str(na), str(nb), "-o", str(out), "--op", "intersect"]) == 0
    capsys.readouterr()
    got = {
        ln.split(",")[0]: int(ln.split(",")[1])
        for ln in out.read_text().strip().splitlines()[1:]
    }
    want = {m: min(c, tb[m]) for m, c in ta.items() if m in tb}
    assert got == want

    out2 = tmp_path / "s.csv"
    assert cli.main(["merge", str(na), str(nb), "-o", str(out2), "--op", "subtract"]) == 0
    capsys.readouterr()
    got = {
        ln.split(",")[0]: int(ln.split(",")[1])
        for ln in out2.read_text().strip().splitlines()[1:]
    }
    want = {m: c - tb.get(m, 0) for m, c in ta.items() if c - tb.get(m, 0) > 0}
    assert got == want


def test_cli_merge_set_ops_empty_right(tmp_path, make_dna, capsys):
    """Set ops against an EMPTY table: intersect -> empty, subtract -> A."""
    import json

    from dna_kmeres_parallel import cli
    from dna_kmeres_parallel.utils import fasta

    pa = tmp_path / "a.fasta"
    fasta.write_fasta(pa, [(">a", make_dna(100))])
    pe = tmp_path / "e.fasta"
    fasta.write_fasta(pe, [(">e", "NNNNNNNNNN")])  # no valid 15-mers
    na, ne = tmp_path / "a.npz", tmp_path / "e.npz"
    assert cli.main(["count", "--k", "15", str(pa), "-o", str(na)]) == 0
    assert cli.main(["count", "--k", "15", str(pe), "-o", str(ne)]) == 0
    capsys.readouterr()
    out = tmp_path / "o.csv"
    assert cli.main(["merge", str(na), str(ne), "-o", str(out), "--op", "intersect"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["distinct_kmers"] == 0
    assert cli.main(["merge", str(na), str(ne), "-o", str(out), "--op", "subtract"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["distinct_kmers"] == 86 - 15 + 1 or rep["distinct_kmers"] > 0


def test_cli_oracle_npz_output(tmp_path, make_dna, capsys):
    """--engine oracle -o table.npz must write a REAL npz (review
    regression: it silently wrote CSV bytes under the .npz name)."""
    import numpy as np

    from dna_kmeres_parallel import cli
    from dna_kmeres_parallel.models import oracle
    from dna_kmeres_parallel.utils import fasta

    s = make_dna(120)
    path = tmp_path / "o.fasta"
    fasta.write_fasta(path, [(">a", s)])
    npz = tmp_path / "o.npz"
    assert cli.main(["count", "--k", "15", "--engine", "oracle", str(path), "-o", str(npz)]) == 0
    capsys.readouterr()
    with np.load(npz) as z:
        assert int(z["counts"].sum()) == sum(
            oracle.count_table_any_k([s], 15).values()
        )
    # and query reads it
    assert cli.main(["query", str(npz), "A" * 15]) == 0


def test_cli_histo_native_engine(tmp_path, make_dna, capsys):
    import json

    from dna_kmeres_parallel import cli, native
    from dna_kmeres_parallel.utils import fasta

    if not native.available():
        import pytest

        pytest.skip("native lib unavailable")
    s = make_dna(60)
    path = tmp_path / "h.fasta"
    fasta.write_fasta(path, [(">a", s * 2)])
    assert cli.main(["histo", "--k", "15", "--engine", "native", str(path)]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["distinct_kmers"] > 0
