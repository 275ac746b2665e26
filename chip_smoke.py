#!/usr/bin/env python
"""Run the count and distance paths once on the GPU and check them exactly.

Drives the program through the entry points a user calls (cli.main and
the engine APIs), in this one process, at the sizes of BASELINE.json's
configurations (scale cut where noted), and compares every result bit for
bit with the C++ host engine (`--engine native`) and the NumPy oracle
(models/oracle.py). Inputs are generated from --seed with utils/datagen.py.

    python chip_smoke.py [--seed N] [--workdir DIR]
    python chip_smoke.py --four-cards     # the multi-card phases only

Each phase prints one JSON line: the phase, the route the program reports,
time of a cold (compiling) and a warm (steady) run, its steady rate, and
exact: true.
The last line is {"ok": true, "device": {...}}. Any mismatch, any counted
degrade (ops/runtime.DEGRADES), or a platform other than "gpu" ends the
run with a nonzero exit before that line.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: Phase-1 read set: 30x coverage of a 9 Mbase genome = 270 Mbase of
#: 150 bp reads. BASELINE.json's config 3 names a 1 GB file; the cut keeps
#: the cold run (generation, device, native and oracle checks) near ten
#: minutes.
READS_GENOME = 9_000_000
READS_COVERAGE = 30.0


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


class Runner:
    def __init__(self, workdir: str):
        self.workdir = workdir

    def path(self, name: str) -> str:
        return os.path.join(self.workdir, name)

    def cli(self, argv: list[str]) -> dict:
        """cli.main(argv) in-process; returns its JSON report."""
        from dna_kmeres_parallel import cli

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        check(rc == 0, f"cli {' '.join(argv)} exited {rc}")
        return json.loads(buf.getvalue().strip().splitlines()[-1])

    @staticmethod
    def timed(fn):
        """Run fn cold (compiling) and again warm: (warm result, cold wall
        seconds, warm wall seconds). The warm run is the steady state; the
        difference is what the cold run spent compiling."""
        t0 = time.perf_counter()
        fn()
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = fn()
        return out, cold, time.perf_counter() - t0

    @staticmethod
    def emit(phase: str, route: str, cold: float, warm: float,
             rate: dict, **extra) -> None:
        line = {
            "phase": phase,
            "route": route,
            "cold_wall_s": cold,
            "compile_s": max(cold - warm, 0.0),
            "steady_s": warm,
            **rate,
            **extra,
            "exact": True,
        }
        print(json.dumps(line), flush=True)


def _npz_table(path: str):
    z = np.load(path)
    if "hist" in z:
        hist = z["hist"].astype(np.int64)
        codes = np.flatnonzero(hist).astype(np.uint64)
        return codes, hist[codes.astype(np.int64)]
    return z["codes"].astype(np.uint64), z["counts"].astype(np.int64)


def _same_table(a: str, b: str) -> bool:
    (ca, na), (cb, nb) = _npz_table(a), _npz_table(b)
    return bool(np.array_equal(ca, cb) and np.array_equal(na, nb))


def _same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(1 << 24), fb.read(1 << 24)
            if x != y:
                return False
            if not x:
                return True


def _head_lines(path: str, n: int) -> bytes:
    out = []
    with open(path, "rb") as f:
        for _ in range(n):
            out.append(f.readline())
    return b"".join(out)


def _native_distance_csv(seqs, k: int, out: str) -> None:
    """Packed distances from the native threaded two-pointer (host)."""
    from dna_kmeres_parallel import native
    from dna_kmeres_parallel.models import sparse_engine
    from dna_kmeres_parallel.utils import io as io_mod

    codes, cnts, offs = sparse_engine.build_pair_tables(seqs, k)
    sums = native.min_sum_pairs_native(codes, cnts, offs)
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    io_mod.write_distances_csv(
        out, sparse_engine.finish_distances_packed(sums, lengths, k)
    )


def _oracle_panel_ok(csv: str, seqs, k: int, n_rows: int) -> bool:
    """The first n_rows rows of the CSV equal the oracle's, byte for byte."""
    from dna_kmeres_parallel import native
    from dna_kmeres_parallel.models import oracle

    panel = oracle.distance_rows_packed(seqs, k, n_rows)
    return _head_lines(csv, panel.shape[0]) == native.format_f6(panel)


def make_inputs(r: Runner, seed: int) -> dict:
    from dna_kmeres_parallel.utils import datagen, fasta

    paths = {
        "reads": r.path("reads.fasta"),
        "slice": r.path("slice.fasta"),
        "genomes": r.path("genomes.fasta"),
        "short": r.path("short.fasta"),
        "union": r.path("union_reads.fasta"),
        "small": r.path("small.fasta"),
    }
    datagen.realistic_fasta(
        paths["reads"], genome_len=READS_GENOME, coverage=READS_COVERAGE,
        read_len=150, seed=seed,
    )
    # A 1 Mbase slice of the read set for the oracle checks.
    records, total = [], 0
    for rec in fasta.parse_fasta(paths["reads"]):
        records.append((rec.id, rec.seq))
        total += len(rec.seq)
        if total >= 1_000_000:
            break
    fasta.write_fasta(paths["slice"], records)
    # S=8192 sequences of 8-16 kb: counts per bin at k=3 exceed the int8
    # threshold route's cap of 64, so distances take the (min,+) route.
    datagen.random_fasta(paths["genomes"], 8192, (8000, 16000), seed=seed + 1)
    # S=2048 sequences of ~1 kb: low multiplicity at k=8 (threshold route).
    datagen.random_fasta(paths["short"], 2048, (900, 1100), seed=seed + 2)
    # S=2048 reads at 30x from one genome (k=21 union route).
    datagen.realistic_fasta(
        paths["union"], genome_len=2048 * 150 // 30, coverage=30.0,
        read_len=150, seed=seed + 3,
    )
    datagen.random_fasta(paths["small"], 12, (200, 400), seed=seed + 4,
                         invalid_frac=0.01)
    return paths


def single_card(r: Runner, paths: dict) -> None:
    from dna_kmeres_parallel.models import oracle
    from dna_kmeres_parallel.utils import fasta

    reads, total_reads = paths["reads"], None

    # 1. Streamed k=21 count (config 3), table == the native engine's.
    rep, cold, wall = r.timed(
        lambda: r.cli(["stream", "--k", "21", reads, "-o", r.path("s21.npz")])
    )
    total_reads = rep["total_bases"]
    r.cli(["count", "--k", "21", "--engine", "native", reads,
           "-o", r.path("n21.npz")])
    check(_same_table(r.path("s21.npz"), r.path("n21.npz")),
          "stream k=21 table != native")
    r.emit("stream_k21", rep["route"], cold, wall,
           {"gbase_per_s": total_reads / wall / 1e9},
           total_bases=total_reads, distinct=rep["distinct_kmers"])

    # 1b. The same stream held to the device route (the auto race above may
    # count most batches on the host): every batch is encoded on the card.
    rep, cold, wall = r.timed(
        lambda: r.cli(["stream", "--k", "21", "--compact", "device", reads,
                       "-o", r.path("s21d.npz")])
    )
    check(rep["route"] == "compact=device/xla-encode+host-radix",
          f"stream k=21 --compact device route {rep['route']}")
    check("host_count" not in rep["metrics"]["phase_seconds"],
          "stream k=21 --compact device counted batches on the host")
    check(_same_table(r.path("s21d.npz"), r.path("n21.npz")),
          "stream k=21 --compact device table != native")
    r.emit("stream_k21_device", rep["route"], cold, wall,
           {"gbase_per_s": total_reads / wall / 1e9},
           batches=rep["metrics"]["counters"].get("batches"))

    # 2. Canonical k=11 (config 2).
    rep, cold, wall = r.timed(
        lambda: r.cli(["count", "--k", "11", "--canonical", reads,
                       "-o", r.path("c11.npz")])
    )
    r.cli(["count", "--k", "11", "--canonical", "--engine", "native", reads,
           "-o", r.path("n11.npz")])
    check(_same_table(r.path("c11.npz"), r.path("n11.npz")),
          "canonical k=11 table != native")
    r.emit("count_k11_canonical", rep["route"], cold, wall,
           {"gbase_per_s": total_reads / wall / 1e9})

    # 3. Dense k=4 (config 1), then k=4/11/21 vs the oracle on 1 Mbase.
    rep, cold, wall = r.timed(
        lambda: r.cli(["count", "--k", "4", reads, "-o", r.path("c4.npz")])
    )
    r.cli(["count", "--k", "4", "--engine", "native", reads,
           "-o", r.path("n4.npz")])
    check(_same_table(r.path("c4.npz"), r.path("n4.npz")),
          "dense k=4 table != native")
    slice_seqs = [x.seq for x in fasta.parse_fasta(paths["slice"])]
    for k, canonical in ((4, False), (11, True), (21, False)):
        argv = ["count", "--k", str(k), paths["slice"],
                "-o", r.path(f"slice{k}.npz")]
        if canonical:
            argv.insert(3, "--canonical")
        r.cli(argv)
        codes, counts = _npz_table(r.path(f"slice{k}.npz"))
        want = oracle.count_table_any_k(slice_seqs, k, canonical)
        from dna_kmeres_parallel.utils import codec

        got = {codec.code_to_kmer(int(c), k): int(n)
               for c, n in zip(codes, counts)}
        check(got == want, f"k={k} slice table != oracle")
    r.emit("count_k4_dense", rep["route"], cold, wall,
           {"gbase_per_s": total_reads / wall / 1e9},
           oracle_slice_bases=sum(len(s) for s in slice_seqs))

    # 4. Distances at k=3 on the (min,+) route, CSV == oracle (whole).
    genomes = paths["genomes"]
    rep, cold, wall = r.timed(
        lambda: r.cli(["distance", "--k", "3", genomes, "-o", r.path("d3.csv")])
    )
    check(rep["route"] == "pallas-min-plus", f"k=3 route {rep['route']}")
    seqs = [x.seq for x in fasta.parse_fasta(genomes)]
    from dna_kmeres_parallel.utils import io as io_mod

    io_mod.write_distances_csv(
        r.path("d3_oracle.csv"), oracle.distance_matrix_packed(seqs, 3)
    )
    check(_same_bytes(r.path("d3.csv"), r.path("d3_oracle.csv")),
          "k=3 distance CSV != oracle")
    r.emit("distance_k3", rep["route"], cold, wall,
           {"pairs_per_s": rep["n_pairs"] / wall},
           n_seqs=rep["n_seqs"])

    # 5. Distances at k=8 on the int8 threshold route.
    short = paths["short"]
    rep, cold, wall = r.timed(
        lambda: r.cli(["distance", "--k", "8", short, "-o", r.path("d8.csv")])
    )
    check(rep["route"].startswith("int8-threshold"), f"k=8 route {rep['route']}")
    seqs = [x.seq for x in fasta.parse_fasta(short)]
    _native_distance_csv(seqs, 8, r.path("d8_native.csv"))
    check(_same_bytes(r.path("d8.csv"), r.path("d8_native.csv")),
          "k=8 distance CSV != native two-pointer")
    check(_oracle_panel_ok(r.path("d8.csv"), seqs, 8, 8),
          "k=8 distance rows != oracle panel")
    r.emit("distance_k8", rep["route"], cold, wall,
           {"pairs_per_s": rep["n_pairs"] / wall},
           n_seqs=rep["n_seqs"])

    # 6. Sparse distances at k=21 on the union route.
    union = paths["union"]
    rep, cold, wall = r.timed(
        lambda: r.cli(["distance", "--k", "21", union, "-o", r.path("d21.csv")])
    )
    check(rep["engine"].startswith("union/"), f"k=21 route {rep['engine']}")
    seqs = [x.seq for x in fasta.parse_fasta(union)]
    _native_distance_csv(seqs, 21, r.path("d21_native.csv"))
    check(_same_bytes(r.path("d21.csv"), r.path("d21_native.csv")),
          "k=21 distance CSV != native two-pointer")
    check(_oracle_panel_ok(r.path("d21.csv"), seqs, 21, 8),
          "k=21 distance rows != oracle panel")
    r.emit("distance_k21_union", rep["engine"], cold, wall,
           {"pairs_per_s": rep["n_pairs"] / wall},
           n_seqs=rep["n_seqs"])

    # 7. selftest (engine vs oracle vs native) at k=3 and k=21.
    for k in (3, 21):
        rep, cold, wall = r.timed(
            lambda k=k: r.cli(["selftest", "--k", str(k), paths["small"]])
        )
        r.emit(f"selftest_k{k}", rep.get("engine", "dense"), cold, wall, {})


def four_cards(r: Runner, paths: dict) -> None:
    import jax

    from dna_kmeres_parallel.parallel import multihost
    from dna_kmeres_parallel.parallel.mesh import make_mesh
    from dna_kmeres_parallel.utils import fasta
    from dna_kmeres_parallel.utils.config import KmerConfig

    devs = jax.devices()
    check(len(devs) == 4 and all(d.platform == "gpu" for d in devs),
          f"--four-cards needs 4 GPUs, found {len(devs)}")
    mesh = make_mesh(4)
    check(len({d.id for d in mesh.devices.flat}) == 4,
          "the mesh does not span 4 distinct cards")
    reads = paths["reads"]

    rep, cold, wall = r.timed(
        lambda: r.cli(["stream", "--k", "21", "--mesh", "4", reads,
                       "-o", r.path("m21.npz")])
    )
    r.cli(["count", "--k", "21", "--engine", "native", reads,
           "-o", r.path("n21.npz")])
    check(_same_table(r.path("m21.npz"), r.path("n21.npz")),
          "stream k=21 --mesh 4 table != native")
    r.emit("stream_k21_mesh4", rep["route"], cold, wall,
           {"gbase_per_s": rep["total_bases"] / wall / 1e9})

    genomes = paths["genomes"]
    rep, cold, wall = r.timed(
        lambda: r.cli(["distance", "--k", "3", "--mesh", "4", genomes,
                       "-o", r.path("m3.csv")])
    )
    seqs = [x.seq for x in fasta.parse_fasta(genomes)]
    _native_distance_csv(seqs, 3, r.path("m3_native.csv"))
    check(_same_bytes(r.path("m3.csv"), r.path("m3_native.csv")),
          "k=3 --mesh 4 distance CSV != native two-pointer")
    r.emit("distance_k3_mesh4", rep["route"], cold, wall,
           {"pairs_per_s": rep["n_pairs"] / wall})

    (codes, counts, total, *_), cold, wall = r.timed(
        lambda: multihost.count_file_bucketed_multihost_resumable(
            reads, KmerConfig(k=31), mesh, batch_bases=16 << 20
        )
    )
    r.cli(["count", "--k", "31", "--engine", "native", reads,
           "-o", r.path("n31.npz")])
    nc, nn = _npz_table(r.path("n31.npz"))
    check(np.array_equal(codes, nc) and np.array_equal(counts, nn),
          "bucketed k=31 over 4 cards != native")
    r.emit("bucketed_k31_mesh4", "bucketed/agg-exchange", cold, wall,
           {"gbase_per_s": total / wall / 1e9})


def _watchdog(seconds: float) -> None:
    """End the process, failed, after ``seconds`` even when a compile or a
    collective hangs in native code (where no Python exception lands)."""
    import threading

    def expire():
        print(f"chip_smoke: FAIL: time limit of {seconds:.0f} s reached",
              file=sys.stderr, flush=True)
        os._exit(1)

    timer = threading.Timer(seconds, expire)
    timer.daemon = True
    timer.start()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=os.path.join(HERE, "bench_out", "smoke"))
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card phases (needs 4 GPUs)")
    ap.add_argument("--time-limit", type=float, default=1100.0,
                    help="seconds after which the run fails (a hung "
                    "compile or collective ends the process)")
    args = ap.parse_args(argv)
    _watchdog(args.time_limit)

    sys.path.insert(0, HERE)
    try:
        import dna_kmeres_parallel as pkg
    except ImportError as e:
        print(f"chip_smoke: the program is not beside this script ({e})",
              file=sys.stderr)
        return 2
    if not os.path.abspath(pkg.__file__).startswith(HERE + os.sep):
        print("chip_smoke: the program is not beside this script",
              file=sys.stderr)
        return 2
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        print(f"chip_smoke: nvidia-smi failed: {smi.stderr.strip()}",
              file=sys.stderr)
        return 2
    import jaxlib

    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"jax": jax.__version__, "jaxlib": jaxlib.__version__,
                      "device_kind": dev.device_kind,
                      "device_count": len(jax.devices())}), flush=True)

    from dna_kmeres_parallel.ops import runtime
    from dna_kmeres_parallel.utils.cache import enable_compile_cache

    enable_compile_cache()
    os.makedirs(args.workdir, exist_ok=True)
    r = Runner(args.workdir)
    try:
        t0 = time.perf_counter()
        paths = make_inputs(r, args.seed)
        print(json.dumps({"phase": "generate_inputs",
                          "wall_s": time.perf_counter() - t0}), flush=True)
        if args.four_cards:
            four_cards(r, paths)
        else:
            single_card(r, paths)
        check(not runtime.DEGRADES, f"routes degraded: {runtime.DEGRADES}")
        check(runtime.backend().kernel == "compiled",
              "the (min,+) kernel did not run compiled")
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
