#!/usr/bin/env python
"""End-to-end streamed-count A/B across compact modes (VERDICT r1 item 2).

Synthesizes a FASTA (random = dup~1, or 'reads' = C-x coverage of one
genome — the realistic sequencing workload where duplication is high),
then runs the identical stream through the compact modes and compares
wall clock + exactness (all modes must produce the identical table).

Usage:
  python scripts/e2e_stream_bench.py [--bases 64M] [--k 21]
      [--modes auto,device,host,device-rle] [--data random|reads]
      [--coverage 30] [--batch 16M]
Prints one JSON line per mode; final line summarizes.
"""

import argparse
import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _size(s):
    for suf, m in (("G", 1 << 30), ("M", 1 << 20), ("K", 1 << 10)):
        if s.upper().endswith(suf):
            return int(float(s[:-1]) * m)
    return int(s)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bases", default="64M")
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--modes", default="device,host,device-rle")
    ap.add_argument("--data", default="random", choices=("random", "reads"))
    ap.add_argument("--coverage", type=int, default=30)
    ap.add_argument("--batch", default="16M")
    ap.add_argument("--out", default="bench_out/e2e_bench.fasta")
    args = ap.parse_args()

    from dna_kmeres_parallel.utils.cache import enable_compile_cache

    enable_compile_cache()
    import numpy as np

    from dna_kmeres_parallel.models.pipeline import StreamingCounter
    from dna_kmeres_parallel.utils.config import KmerConfig

    total = _size(args.bases)
    rng = np.random.default_rng(17)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    if not (
        os.path.exists(args.out)
        and os.path.getsize(args.out) > total
        and open(args.out).readline().strip()
        == f">e2e_{args.data}_{total}_{args.coverage}_0"
    ):
        with open(args.out, "w") as f:
            if args.data == "random":
                seq_len = 4 << 20
                i = 0
                done = 0
                while done < total:
                    L = min(seq_len, total - done)
                    s = alphabet[rng.integers(0, 4, L)].tobytes().decode()
                    f.write(f">e2e_{args.data}_{total}_{args.coverage}_{i}\n")
                    f.write(s + "\n")
                    i += 1
                    done += L
            else:
                genome_len = max(total // args.coverage, 1000)
                genome = alphabet[rng.integers(0, 4, genome_len)]
                read_len = 150
                n_reads = total // read_len
                starts = rng.integers(0, genome_len - read_len, n_reads)
                for i, st in enumerate(starts):
                    s = genome[st : st + read_len].tobytes().decode()
                    f.write(
                        f">e2e_{args.data}_{total}_{args.coverage}_{i}\n"
                        if i == 0
                        else f">r{i}\n"
                    )
                    f.write(s + "\n")
    print(
        json.dumps(
            {
                "phase": "synthesize",
                "bytes": os.path.getsize(args.out),
                "elapsed_s": round(time.perf_counter() - t0, 2),
            }
        ),
        flush=True,
    )

    results = {}
    for mode in args.modes.split(","):
        sc = StreamingCounter(
            KmerConfig(k=args.k, batch_bases=_size(args.batch), compact=mode)
        )
        t0 = time.perf_counter()
        res = sc.run(args.out)
        wall = time.perf_counter() - t0
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(res.codes).tobytes())
        h.update(np.ascontiguousarray(res.counts).tobytes())
        digest = h.hexdigest()[:16]
        rep = sc.metrics.report()
        results[mode] = digest
        print(
            json.dumps(
                {
                    "mode": mode,
                    "k": args.k,
                    "total_bases": int(res.total_bases),
                    "distinct": int(res.codes.shape[0]),
                    "wall_s": round(wall, 2),
                    "gbases_per_sec_e2e": round(
                        res.total_bases / wall / 1e9, 4
                    ),
                    "phase_seconds": {
                        kk: round(v, 2)
                        for kk, v in rep["phase_seconds"].items()
                    },
                    "counters": {
                        kk: v
                        for kk, v in rep["counters"].items()
                        if kk in ("batches", "compact_host_selected")
                    },
                    "table_sha": digest,
                }
            ),
            flush=True,
        )
    print(
        json.dumps(
            {
                "phase": "summary",
                "tables_identical": len(set(results.values())) == 1,
                "modes": results,
            }
        ),
        flush=True,
    )
    return 0 if len(set(results.values())) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
