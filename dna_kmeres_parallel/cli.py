"""Command-line interface.

Replaces the reference's compile-time configuration (hard-coded paths and
#defines, /root/reference/main.cu:19-50) with runtime flags.

  kmers count    --k 4 in.fasta -o table.csv
  kmers distance --k 3 in.fasta -o distances.csv [--tsv min_distances.csv]
  kmers selftest --k 3 in.fasta       # oracle-vs-engine differential check
  kmers bench    --k 11 --bases 64M   # single-chip throughput microbench
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def _parse_size(s: str) -> int:
    s = s.strip().upper()
    for suffix, m in (("K", 1 << 10), ("M", 1 << 20), ("G", 1 << 30)):
        if s.endswith(suffix):
            return int(float(s[:-1]) * m)
    return int(s)


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--k", type=int, default=3, help="k-mer length")
    p.add_argument(
        "--canonical",
        action="store_true",
        help="fold reverse complements (min(code, rc))",
    )
    p.add_argument(
        "--max-seqs", type=int, default=None, help="ingest cap (reference: 100)"
    )
    p.add_argument(
        "--parser",
        choices=("modern", "blank_line", "no_blank_line"),
        default="modern",
        help="record-splitting semantics (reference emulation variants)",
    )
    p.add_argument(
        "--engine",
        choices=("device", "oracle", "native"),
        default="device",
        help="device = JAX/Pallas engine, oracle = NumPy golden engine, "
        "native = C++ host engine (rolling encoder fused into the radix "
        "compactor; count command, any k <= 31)",
    )
    p.add_argument(
        "--mesh",
        type=int,
        default=None,
        metavar="N",
        help="run over an N-device mesh: data-parallel counting (stream "
        "command, per-chip partials merged exactly) and partner-sharded "
        "distances (distance command, incl. --stream-panel — dense "
        "panels always; sparse k>=12 panels when the union-indexed "
        "device route fires; bit-identical output at any N)",
    )
    p.add_argument(
        "--device-sort",
        choices=("auto", "on", "off"),
        default="auto",
        help="sparse path (k >= 13): whether the device sorts window words. "
        "auto (default) skips the device sort when the native radix "
        "compactor is available (encode kernel alone on device)",
    )
    p.add_argument(
        "--compact",
        choices=("auto", "device", "host", "device-rle", "device-super"),
        default="auto",
        help="sparse streamed path: build batch tables from device-shipped "
        "words ('device'), from the host-resident stream with the native "
        "engine — zero D2H ('host'), race the two on "
        "the first batches and finish with the winner ('auto'), or have "
        "the device sort+RLE-collapse runs and ship only distinct "
        "(code, count) pairs — for high-coverage/duplicated inputs "
        "('device-rle') — or ship packed super-k-mer records, "
        "~1.5-2 B/window instead of 6-8, when D2H bandwidth bounds the "
        "stream ('device-super')",
    )


def _build_config(args):
    from dna_kmeres_parallel.utils.config import KmerConfig

    ds = getattr(args, "device_sort", "auto")
    return KmerConfig(
        k=args.k,
        canonical=args.canonical,
        max_seqs=args.max_seqs,
        parser_variant=args.parser,
        mesh_shape=(args.mesh,) if getattr(args, "mesh", None) else (),
        device_sort=None if ds == "auto" else ds == "on",
        compact=getattr(args, "compact", "auto"),
    )


def _expand_inputs(inputs) -> list[str]:
    """Expand globs / accept multiple paths (the reference hard-codes ONE
    absolute path, main.cu:47-50; SURVEY §5 mandates input globs)."""
    import glob as globmod

    if isinstance(inputs, (str, os.PathLike)):
        inputs = [inputs]
    paths: list[str] = []
    for item in inputs:
        s = str(item)
        if any(ch in s for ch in "*?["):
            matches = sorted(globmod.glob(s))
            if not matches:
                raise FileNotFoundError(s)
            paths.extend(matches)
        else:
            paths.append(s)
    return paths


def _load_records(args):
    from dna_kmeres_parallel.utils import fasta

    records = []
    for path in _expand_inputs(args.input):
        remaining = None if args.max_seqs is None else args.max_seqs - len(records)
        if remaining is not None and remaining <= 0:
            break
        if args.parser == "modern":
            records.extend(fasta.parse_fasta(path, max_seqs=remaining))
        else:
            records.extend(
                fasta.parse_fasta_reference(
                    path, variant=args.parser, max_seqs=remaining
                )
            )
    return records


def cmd_count(args) -> int:
    from dna_kmeres_parallel.models import oracle
    from dna_kmeres_parallel.utils import codec, io

    sparse = args.k > 12  # beyond the dense 4^k-bins comfort zone
    mesh_stream = bool(getattr(args, "mesh", None)) and args.engine == "device"
    if mesh_stream:
        # The streaming pipeline parses the files itself — loading every
        # record here too would double I/O and hold the whole dataset in
        # RAM for the run; n_seqs/total_bases come from the result.
        seqs = []
        total_bases = None
    else:
        records = _load_records(args)
        seqs = [r.seq for r in records]
        total_bases = sum(len(s) for s in seqs)
    npz = bool(args.output) and str(args.output).endswith(".npz")
    result = None
    route = args.engine
    t0 = time.perf_counter()
    if args.engine == "oracle":
        from dna_kmeres_parallel.models.sparse_engine import (
            SparseCountResult,
        )

        table = oracle.count_table_any_k(seqs, args.k, args.canonical)
        total_kmers = sum(table.values())
        distinct = len(table)
        if npz:
            # .npz output needs a result object (the oracle previously fell
            # through to the CSV writer and produced a CSV named .npz).
            codes = np.sort(
                np.array(
                    [codec.kmer_to_code(m) for m in table], dtype=np.uint64
                )
            )
            counts = np.array(
                [table[codec.code_to_kmer(int(c), args.k)] for c in codes],
                dtype=np.int64,
            )
            result = SparseCountResult(
                k=args.k, canonical=args.canonical, codes=codes,
                counts=counts, n_seqs=len(seqs), total_bases=total_bases,
            )
    elif args.engine == "native":
        # C++ host engine: rolling 2k-bit encoder fused into the MSD+LSD
        # radix compactor (native.count_sparse_host_native) — the CPU
        # golden engine at GB scale; bit-identical tables to the device path.
        from dna_kmeres_parallel import native as native_mod
        from dna_kmeres_parallel.models.sparse_engine import (
            SparseCountResult,
        )

        flat = codec.concat_with_sentinels(seqs)
        codes, counts = native_mod.count_sparse_host_native(
            flat, args.k, args.canonical
        )
        result = SparseCountResult(
            k=args.k,
            canonical=args.canonical,
            codes=codes,
            counts=counts,
            n_seqs=len(seqs),
            total_bases=total_bases,
        )
        total_kmers, distinct = result.total_kmers, result.distinct_kmers
        table = (
            result.table()
            if (args.output and not npz and args.min_count <= 1)
            else None
        )
    elif mesh_stream:
        # Mesh counting runs through the streaming pipeline (the same
        # data-parallel engine the stream command uses; the in-memory
        # engines are single-chip) — `count --mesh N` is `stream --mesh N`
        # without a checkpoint.
        from dna_kmeres_parallel.models.pipeline import StreamingCounter

        inputs = _expand_inputs(args.input)
        counter = StreamingCounter(_build_config(args))
        result = counter.run(inputs if len(inputs) > 1 else inputs[0])
        route = counter.route
        total_bases = result.total_bases
        total_kmers, distinct = result.total_kmers, result.distinct_kmers
        table = (
            result.table()
            if (args.output and not npz and args.min_count <= 1)
            else None
        )
    elif sparse:
        from dna_kmeres_parallel.models.sparse_engine import SparseKmerEngine

        engine = SparseKmerEngine(_build_config(args))
        result = engine.count_sequences(seqs)
        route = engine.route()
        total_kmers, distinct = result.total_kmers, result.distinct_kmers
        table = (
            result.table()
            if (args.output and not npz and args.min_count <= 1)
            else None
        )
    else:
        from dna_kmeres_parallel.models.engine import KmerEngine

        engine = KmerEngine(_build_config(args))
        result = engine.count_sequences(seqs)
        route = engine.count_route()
        total_kmers, distinct = result.total_kmers, result.distinct_kmers
        table = (
            result.table()
            if (args.output and not npz and args.min_count <= 1)
            else None
        )
    elapsed = time.perf_counter() - t0

    kept = None
    if args.min_count > 1:
        # KMC-style -ci: drop below-threshold k-mers from the OUTPUT
        # (stats above report the unfiltered table).
        if result is not None and hasattr(result, "codes"):
            keep = result.counts >= args.min_count
            result = dataclasses.replace(
                result, codes=result.codes[keep], counts=result.counts[keep]
            )
            kept = int(result.codes.shape[0])
            table = result.table() if (args.output and not npz) else None
        elif table is not None:
            table = {m: c for m, c in table.items() if c >= args.min_count}
            kept = len(table)
        elif result is not None and hasattr(result, "hist"):
            hist = result.hist.copy()
            hist[hist < args.min_count] = 0
            result = dataclasses.replace(result, hist=hist)
            kept = int(np.count_nonzero(hist))

    if args.output and npz and result is not None:
        io.write_count_npz(args.output, result)
    elif args.output and table is not None:
        io.write_count_table_csv(args.output, table)
    report = {
        "k": args.k,
        "canonical": args.canonical,
        "engine": args.engine + ("/sparse" if sparse and args.engine == "device" else ""),
        "route": route,
        "n_seqs": result.n_seqs if mesh_stream else len(seqs),
        "total_bases": total_bases,
        "total_kmers": total_kmers,
        "distinct_kmers": distinct,
        "elapsed_s": round(elapsed, 4),
        "bases_per_sec": round(total_bases / max(elapsed, 1e-9), 1),
        "output": args.output,
    }
    if kept is not None:
        report["min_count"] = args.min_count
        report["distinct_kept"] = kept
    print(json.dumps(report))
    return 0


def cmd_distance(args) -> int:
    from dna_kmeres_parallel.models import oracle
    from dna_kmeres_parallel.models.engine import KmerEngine

    if args.engine == "native":
        print(
            "error: --engine native serves the count command only "
            "(distances run on device or oracle)",
            file=sys.stderr,
        )
        return 2
    from dna_kmeres_parallel.utils import io

    records = _load_records(args)
    seqs = [r.seq for r in records]
    t0 = time.perf_counter()
    from dna_kmeres_parallel.ops.encode import MAX_DENSE_K

    from dna_kmeres_parallel.models.sparse_engine import (
        dense_distance_preferred,
    )

    if args.k > MAX_DENSE_K or not dense_distance_preferred(
        len(seqs), args.k, [len(s) for s in seqs]
    ):
        # Sparse-table distances: per-sequence sorted tables + host
        # pairwise intersection min-sums — beyond the reference's
        # dense-vector design (kernels.h:85-109), completing distance
        # coverage for every k the counting engines support. Routes here
        # for every k > 15, for mid-k (9..15) whenever the dense
        # [S, 4^k] counts matrix would overflow the memory budget
        # (KMER_DENSE_DIST_BUDGET; 4^13 is 268 MB per sequence),
        # AND — r4 — whenever the predicted per-pair cost favors the
        # sparse tables (dense pays ~2*4^k terms/pair vs ~2*E[table]
        # two-pointer steps; see dense_distance_preferred).
        from dna_kmeres_parallel.models import sparse_engine
        from dna_kmeres_parallel.utils import io as io_mod

        route_info: dict = {}
        if args.engine != "oracle" and args.stream_panel and args.output:
            # Streamed sparse path (r5): panels of packed rows append to
            # the CSV through the shared resumable writer — same
            # --checkpoint / --mesh semantics as the dense stream; the
            # union-indexed device route rides the mesh when the cost
            # gate fires, the native threaded two-pointer serves the
            # host route panel-by-panel otherwise.
            mesh = None
            if getattr(args, "mesh", None):
                from dna_kmeres_parallel.parallel.mesh import make_mesh

                if args.mesh > 1:
                    mesh = make_mesh(args.mesh)
            report = sparse_engine.distance_sparse_stream_to_csv(
                seqs,
                args.k,
                args.output,
                args.canonical,
                panel_rows=args.stream_panel,
                checkpoint_path=getattr(args, "checkpoint", None),
                mesh=mesh,
                info=route_info,
            )
            report.update(
                {
                    "k": args.k,
                    "engine": route_info.get("route", "host/sparse"),
                    "streamed": True,
                }
            )
            report["elapsed_s"] = round(report["elapsed_s"], 4)
            print(json.dumps(report))
            return 0
        if args.engine == "oracle":
            packed = oracle.distance_matrix_packed_sparse(
                seqs, args.k, args.canonical
            )
        else:
            packed = sparse_engine.distance_sparse_packed(
                seqs, args.k, args.canonical, info=route_info
            )
        elapsed = time.perf_counter() - t0
        if args.output:
            io_mod.write_distances_csv(args.output, packed)
        if args.tsv:
            io_mod.write_min_distances_tsv(args.tsv, packed, len(seqs))
        print(
            json.dumps(
                {
                    "k": args.k,
                    "engine": ("oracle" if args.engine == "oracle"
                               else route_info.get("route", "host/sparse")),
                    "n_seqs": len(seqs),
                    "n_pairs": int(packed.shape[0]),
                    "elapsed_s": round(elapsed, 4),
                    "output": args.output,
                }
            )
        )
        return 0
    if args.engine != "oracle" and args.stream_panel and args.output:
        # Big-S path: the distance matrix never materializes; panels of
        # packed rows append to the CSV directly (resumable via
        # --checkpoint; partner-sharded over --mesh).
        report = KmerEngine(_build_config(args)).distance_stream_to_csv(
            seqs, args.output, panel_rows=args.stream_panel,
            checkpoint_path=getattr(args, "checkpoint", None),
        )
        report.update({"k": args.k, "engine": args.engine, "streamed": True})
        report["elapsed_s"] = round(report["elapsed_s"], 4)
        print(json.dumps(report))
        return 0
    route = "oracle"
    if args.engine == "oracle":
        packed = oracle.distance_matrix_packed(seqs, args.k, args.canonical)
    else:
        result = KmerEngine(_build_config(args)).distance_sequences(seqs)
        packed, route = result.packed, result.route
    elapsed = time.perf_counter() - t0

    if args.output:
        io.write_distances_csv(args.output, packed)
    if args.tsv:
        io.write_min_distances_tsv(args.tsv, packed, len(seqs))
    report = {
        "k": args.k,
        "engine": args.engine,
        "route": route,
        "n_seqs": len(seqs),
        "n_pairs": int(packed.shape[0]),
        "elapsed_s": round(elapsed, 4),
        "output": args.output,
    }
    print(json.dumps(report))
    return 0


def _native_engine_table(seqs, k, canonical):
    """Host C++ engine table for selftest cross-checks (None when the
    native lib is unavailable)."""
    from dna_kmeres_parallel import native as native_mod
    from dna_kmeres_parallel.utils import codec

    if not native_mod.available():
        return None
    flat = codec.concat_with_sentinels(seqs)
    codes, counts = native_mod.count_sparse_host_native(flat, k, canonical)
    return {
        codec.code_to_kmer(int(c), k): int(n) for c, n in zip(codes, counts)
    }


def cmd_query(args) -> int:
    """Look up k-mer counts in a saved table (.npz): the library's
    count_of() as a CLI verb."""
    from dna_kmeres_parallel.models.sparse_engine import SparseCountResult
    from dna_kmeres_parallel.utils import io

    k, canonical, codes, counts = io.read_count_npz(args.table)
    result = SparseCountResult(
        k=k, canonical=canonical, codes=codes, counts=counts,
        n_seqs=0, total_bases=0,
    )
    out = {}
    for kmer in args.kmers:
        q = kmer.upper()
        if len(q) != k or any(c not in "ACGT" for c in q):
            print(
                f"error: {kmer!r} is not a valid {k}-mer over ACGT",
                file=sys.stderr,
            )
            return 2
        out[kmer] = result.count_of(q)
    print(json.dumps({"k": k, "canonical": canonical, "counts": out}))
    return 0


def cmd_selftest(args) -> int:
    from dna_kmeres_parallel.models import oracle
    from dna_kmeres_parallel.models.engine import KmerEngine

    records = _load_records(args)
    seqs = [r.seq for r in records]
    # Three-way differential: device engine vs NumPy oracle vs C++ host engine
    # (the reference's CPU-vs-GPU dual-engine strategy, SURVEY.md §4,
    # extended to three independent implementations).
    native_tbl = _native_engine_table(seqs, args.k, args.canonical)
    if args.k > 12:
        from dna_kmeres_parallel.models.sparse_engine import SparseKmerEngine

        got = SparseKmerEngine(_build_config(args)).count_sequences(seqs)
        want = oracle.count_table_any_k(seqs, args.k, args.canonical)
        verdict = {
            "engine": "sparse",
            "counts_equal": got.table() == want,
            "native_counts_equal": (
                native_tbl == want if native_tbl is not None else None
            ),
            "n_seqs": len(seqs),
            "total_kmers": sum(want.values()),
        }
        if len(seqs) >= 2:
            # Sparse-table distance differential (host engine vs oracle)
            # — the production distance route for this k band (k=13..15
            # dense vectors are infeasible; see dense_distance_feasible).
            from dna_kmeres_parallel.models import sparse_engine

            d_got = sparse_engine.distance_sparse_packed(
                seqs, args.k, args.canonical
            )
            d_want = oracle.distance_matrix_packed_sparse(
                seqs, args.k, args.canonical
            )
            verdict["distances_equal"] = bool(np.array_equal(d_got, d_want))
        print(json.dumps(verdict))
        ok = (
            verdict["counts_equal"]
            and verdict["native_counts_equal"] is not False
            and verdict.get("distances_equal", True)
        )
        return 0 if ok else 1
    engine = KmerEngine(_build_config(args))
    verdict = engine.verify_against_oracle(seqs)
    if native_tbl is not None:
        want = oracle.count_table_any_k(seqs, args.k, args.canonical)
        verdict["native_counts_equal"] = native_tbl == want
    print(json.dumps(verdict))
    ok = verdict["counts_equal"] and verdict["distances_equal"]
    return 0 if ok and verdict.get("native_counts_equal") is not False else 1


def cmd_stream(args) -> int:
    if args.engine == "native":
        print(
            "error: --engine native serves the count command only "
            "(use `count --engine native` for the C++ host engine)",
            file=sys.stderr,
        )
        return 2
    """Resumable streaming count with metrics and checkpointing."""
    from dna_kmeres_parallel.models.pipeline import StreamingCounter
    from dna_kmeres_parallel.utils import io

    sc = StreamingCounter(
        _build_config(args),
        checkpoint_path=args.checkpoint,
        checkpoint_every_bases=_parse_size(args.checkpoint_every),
    )
    inputs = _expand_inputs(args.input)
    result = sc.run(inputs if len(inputs) > 1 else inputs[0])
    if args.output:
        if str(args.output).endswith(".npz"):
            io.write_count_npz(args.output, result)
        else:
            io.write_count_table_csv(args.output, result.table())
    report = {
        "k": args.k,
        "canonical": args.canonical,
        "n_seqs": result.n_seqs,
        "total_bases": result.total_bases,
        "total_kmers": result.total_kmers,
        "distinct_kmers": result.distinct_kmers,
        "elapsed_s": round(result.elapsed_s, 4),
        "route": sc.route,
        "metrics": sc.metrics.report(),
        "checkpoint": args.checkpoint,
        "output": args.output,
    }
    print(json.dumps(report))
    return 0


def _table_set_op(ca, na, cb, nb, op):
    """Sorted-unique table set ops (KMC-tools semantics): intersect keeps
    codes present in BOTH with min counts; subtract decrements A's counts
    by B's and drops non-positives (counters_subtract)."""
    if cb.shape[0] == 0:
        # Empty right table: intersect -> empty; subtract -> A unchanged.
        if op == "intersect":
            return ca[:0], na[:0].astype(np.int64)
        return ca, na.astype(np.int64)
    idx_c = np.minimum(np.searchsorted(cb, ca), cb.shape[0] - 1)
    match = cb[idx_c] == ca
    other = np.where(match, nb[idx_c], 0)
    if op == "intersect":
        keep = match
        counts = np.minimum(na, other)
    else:  # subtract
        counts = na - other
        keep = counts > 0
    return ca[keep], counts[keep].astype(np.int64)


def cmd_merge(args) -> int:
    """Merge count-table npz files from separate runs (different input
    files, hosts, or checkpointed partials) into one exact table — the
    integer sorted-merge the whole framework is built on."""
    from dna_kmeres_parallel.models.sparse_engine import (
        SparseCountResult,
        merge_sparse_tables,
    )
    from dna_kmeres_parallel.utils import io

    tables = []
    k = canonical = None
    for path in _expand_inputs(args.input):
        tk, tc, codes, counts = io.read_count_npz(path)
        if k is None:
            k, canonical = tk, tc
        elif (tk, tc) != (k, canonical):
            print(
                json.dumps(
                    {"error": f"{path}: k/canonical mismatch "
                     f"({tk},{tc}) != ({k},{canonical})"}
                ),
                file=sys.stderr,
            )
            return 2
        tables.append((codes, counts))
    if args.op == "sum":
        codes, counts = merge_sparse_tables(tables)
    else:
        # KMC-tools-style set operations, folded left over the inputs.
        codes, counts = tables[0]
        for cb, nb in tables[1:]:
            codes, counts = _table_set_op(codes, counts, cb, nb, args.op)
    result = SparseCountResult(
        k=k, canonical=canonical, codes=codes, counts=counts,
        n_seqs=0, total_bases=0,
    )
    if str(args.output).endswith(".npz"):
        io.write_count_npz(args.output, result)
    else:
        io.write_count_table_csv(args.output, result.table())
    print(
        json.dumps(
            {
                "k": k,
                "canonical": canonical,
                "inputs": len(tables),
                "total_kmers": result.total_kmers,
                "distinct_kmers": result.distinct_kmers,
                "output": args.output,
            }
        )
    )
    return 0


def cmd_histo(args) -> int:
    """k-mer spectrum (count-of-counts histogram), the standard KMC/Gerbil
    `histogram` report: line i = number of distinct k-mers occurring i
    times."""
    import numpy as np

    from dna_kmeres_parallel.utils import io

    inputs = _expand_inputs(args.input)
    npz_inputs = [p for p in inputs if str(p).endswith(".npz")]
    if npz_inputs and len(npz_inputs) != len(inputs):
        print(
            json.dumps({"error": "histo inputs must be all .npz or all FASTA/FASTQ"}),
            file=sys.stderr,
        )
        return 2
    if npz_inputs:
        from dna_kmeres_parallel.models.sparse_engine import merge_sparse_tables

        tables = []
        k = canonical = None
        for path in npz_inputs:
            tk, tc, codes_t, counts_t = io.read_count_npz(path)
            if k is None:
                k, canonical = tk, tc
            elif (tk, tc) != (k, canonical):
                print(
                    json.dumps({"error": f"{path}: k/canonical mismatch"}),
                    file=sys.stderr,
                )
                return 2
            tables.append((codes_t, counts_t))
        _, counts = merge_sparse_tables(tables)
    else:
        records = _load_records(args)
        seqs = [r.seq for r in records]
        k, canonical = args.k, args.canonical
        if args.engine == "oracle":
            from dna_kmeres_parallel.models import oracle

            table = oracle.count_table_any_k(seqs, args.k, args.canonical)
            counts = np.fromiter(table.values(), dtype=np.int64, count=len(table))
        elif args.engine == "native":
            # C++ host engine — no device work at all (was previously
            # silently substituted with the device engine).
            from dna_kmeres_parallel import native as native_mod
            from dna_kmeres_parallel.utils import codec

            flat = codec.concat_with_sentinels(seqs)
            _, counts = native_mod.count_sparse_host_native(
                flat, args.k, args.canonical
            )
        elif args.k > 12:
            from dna_kmeres_parallel.models.sparse_engine import SparseKmerEngine

            r = SparseKmerEngine(_build_config(args)).count_sequences(seqs)
            counts = r.counts
        else:
            from dna_kmeres_parallel.models.engine import KmerEngine

            r = KmerEngine(_build_config(args)).count_sequences(seqs)
            counts = r.hist[r.hist > 0]

    cap = args.max_count
    clipped = np.minimum(counts, cap)
    spectrum = np.bincount(clipped.astype(np.int64), minlength=cap + 1)
    if args.output:
        with open(args.output, "w", encoding="ascii") as f:
            for i in range(1, cap + 1):
                f.write(f"{i}\t{int(spectrum[i])}\n")
    report = {
        "k": k,
        "canonical": canonical,
        "distinct_kmers": int(counts.shape[0]),
        "total_kmers": int(counts.sum()),
        "max_count": int(counts.max()) if counts.size else 0,
        "spectrum_head": [int(x) for x in spectrum[1:11]],
        "output": args.output,
    }
    print(json.dumps(report))
    return 0


def cmd_info(args) -> int:
    """Per-sequence stats dump (the reference's printSeqs/VERBOSE analogue,
    main.cu:664-669, structured instead of raw prints)."""
    records = _load_records(args)
    seqs = [r.seq for r in records]
    lengths = [len(s) for s in seqs]
    from dna_kmeres_parallel.utils import codec as codec_mod

    invalid = sum(
        int((codec_mod.encode_bases(s) == codec_mod.INVALID_BASE).sum())
        for s in seqs
    )
    report = {
        "n_seqs": len(seqs),
        "total_bases": sum(lengths),
        "min_len": min(lengths, default=0),
        "max_len": max(lengths, default=0),
        "invalid_bases": invalid,
        "ids": [r.id for r in records[:20]],
    }
    if args.verbose:
        report["lengths"] = lengths
    print(json.dumps(report))
    return 0


def cmd_calibrate(args) -> int:
    """Measure and persist this backend's routing calibration (r5):
    link rates always (cheap, no compiles); route pair rates unless
    --link-only (pays one compile per route, cached afterwards). The
    distance gates (union_dense_plan, dense_distance_preferred, the int8
    cmax gate) consume the persisted file automatically."""
    from dna_kmeres_parallel.ops import calibrate

    cal = dict(calibrate.get_calibration())
    cal.update(calibrate.measure_link())
    if not args.link_only:
        cal.update(calibrate.measure_compute())
    path = calibrate.save_calibration(cal)
    print(json.dumps({"calibration_file": path, **cal}))
    return 0


def cmd_bench(args) -> int:
    from dna_kmeres_parallel.models.benchmarks import (
        run_count_bench,
        run_sparse_bench,
    )

    # Mirror production routing (bench.py): dense kernel for k <= 8, the
    # sparse path's device program for k >= 9 (no-device-sort by default).
    if args.k <= 8:
        report = run_count_bench(
            k=args.k,
            canonical=args.canonical,
            total_bases=_parse_size(args.bases),
            batch_bases=_parse_size(args.batch),
        )
    else:
        from dna_kmeres_parallel.models.sparse_engine import (
            resolve_device_sort,
        )
        from dna_kmeres_parallel.utils.config import KmerConfig

        cfg = KmerConfig(k=args.k, canonical=args.canonical)
        report = run_sparse_bench(
            k=args.k,
            canonical=args.canonical,
            total_bases=_parse_size(args.bases),
            batch_bases=_parse_size(args.batch),
            device_sort=resolve_device_sort(cfg),
            row_len=cfg.sort_row_len,  # production shape for the fallback
        )
    print(json.dumps(report))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="kmers")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("count", help="k-mer frequency table for a FASTA file")
    _add_common(p)
    p.add_argument("input", nargs="+", help="FASTA path(s) or glob(s)")
    p.add_argument("-o", "--output", default=None, help="count table CSV path")
    p.add_argument(
        "--min-count", type=int, default=1, metavar="N",
        help="exclude k-mers seen fewer than N times from the output "
        "(KMC-style -ci; stats still report the full table)",
    )
    p.set_defaults(fn=cmd_count)

    p = sub.add_parser("query", help="look up k-mer counts in a saved .npz table")
    p.add_argument("table", help="count table .npz (from count/merge -o)")
    p.add_argument("kmers", nargs="+", help="k-mer string(s) to look up")
    p.set_defaults(fn=cmd_query)

    p = sub.add_parser("distance", help="pairwise k-mer distance matrix")
    _add_common(p)
    p.add_argument("input", nargs="+", help="FASTA path(s) or glob(s)")
    p.add_argument(
        "-o", "--output", default=None, help="packed distances CSV (%%f per line)"
    )
    p.add_argument(
        "--tsv", default=None, help="ragged lower-triangle TSV (printMinDistances format)"
    )
    p.add_argument(
        "--stream-panel",
        type=int,
        default=None,
        metavar="ROWS",
        help="stream the distance matrix to CSV in ROWS-row panels "
        "(bounded memory for large sequence counts)",
    )
    p.add_argument(
        "--checkpoint",
        default=None,
        help="streamed-path checkpoint JSON (resume if present; the "
        "resumed CSV is byte-identical to a single-shot run)",
    )
    p.set_defaults(fn=cmd_distance)

    p = sub.add_parser("selftest", help="oracle-vs-engine differential check")
    _add_common(p)
    p.add_argument("input", nargs="+", help="FASTA path(s) or glob(s)")
    p.set_defaults(fn=cmd_selftest)

    p = sub.add_parser(
        "merge", help="merge count-table npz files into one exact table"
    )
    p.add_argument("input", nargs="+", help="count npz path(s) or glob(s)")
    p.add_argument("-o", "--output", required=True, help="merged table (.npz or .csv)")
    p.add_argument(
        "--op",
        choices=("sum", "intersect", "subtract"),
        default="sum",
        help="sum = exact additive merge (default); intersect = codes in "
        "ALL inputs with min counts; subtract = left table minus the "
        "others' counts, non-positives dropped (KMC-tools semantics)",
    )
    p.set_defaults(fn=cmd_merge)

    p = sub.add_parser(
        "histo", help="k-mer spectrum (count-of-counts histogram)"
    )
    _add_common(p)
    p.add_argument("input", nargs="+", help="FASTA/FASTQ path(s) or a count .npz")
    p.add_argument("-o", "--output", default=None, help="spectrum TSV path")
    p.add_argument(
        "--max-count", type=int, default=10000,
        help="clip spectrum at this multiplicity (last bin absorbs the tail)",
    )
    p.set_defaults(fn=cmd_histo)

    p = sub.add_parser("info", help="per-sequence stats for a FASTA file")
    _add_common(p)
    p.add_argument("input", nargs="+", help="FASTA path(s) or glob(s)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser(
        "stream", help="resumable streaming count (checkpoint/resume, metrics)"
    )
    _add_common(p)
    p.add_argument("input", nargs="+", help="FASTA path(s) or glob(s)")
    p.add_argument("-o", "--output", default=None, help="count table CSV path")
    p.add_argument(
        "--checkpoint", default=None, help="checkpoint .npz path (resume if present)"
    )
    p.add_argument(
        "--checkpoint-every",
        default="256M",
        help="bases between checkpoints (e.g. 64M, 1G)",
    )
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("bench", help="single-chip throughput microbenchmark")
    p.add_argument("--k", type=int, default=11)
    p.add_argument("--canonical", action="store_true")
    p.add_argument("--bases", default="64M", help="total bases (e.g. 64M, 1G)")
    p.add_argument("--batch", default="8M", help="bases per device batch")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser(
        "calibrate",
        help="measure this backend's link + route rates and persist "
        "them for the routing gates (ops/calibrate)",
    )
    p.add_argument(
        "--link-only",
        action="store_true",
        help="measure only H2D/D2H/roundtrip (no device compiles)",
    )
    p.set_defaults(fn=cmd_calibrate)

    args = parser.parse_args(argv)
    if hasattr(args, "k"):
        kmax = 31
        if not (1 <= args.k <= kmax):
            parser.error(
                f"--k {args.k} out of range for '{args.command}': "
                f"supported 1 <= k <= {kmax}"
            )
    from dna_kmeres_parallel.utils.cache import enable_compile_cache

    enable_compile_cache()
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: cannot open input: {e.filename or e}", file=sys.stderr)
        return 2
    except (ValueError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
