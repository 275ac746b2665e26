#!/usr/bin/env python
"""The reference's design-scale distance run (VERDICT r1 item 5).

The reference's step-1 grid constant says the program was sized for
54,018 sequences (/root/reference/main.cu:29, BLOCKS_STEP_1) — 1.459G
pairs — although the shipped binary caps ingest at 100 (MAX_SEQS,
main.cu:30). This script actually runs that scale end-to-end on the device
engine: synthesize 54,018 sequences, stream the packed-triangle distance
CSV via engine.distance_stream_to_csv (panelled (min,+) Pallas kernel,
native %f formatter), then spot-check sampled rows byte-for-byte against
the NumPy oracle.

Usage: python scripts/design_scale_distance.py [--n-seqs 54018] [--k 3]
       [--out bench_out/design54k.csv] [--sample-rows 6]
Prints one JSON line per phase; final line is the summary.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-seqs", type=int, default=54018)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--out", default="bench_out/design54k.csv")
    ap.add_argument("--sample-rows", type=int, default=6)
    ap.add_argument("--panel-rows", type=int, default=2048)
    args = ap.parse_args()

    from dna_kmeres_parallel.utils.cache import enable_compile_cache

    enable_compile_cache()
    import numpy as np

    from dna_kmeres_parallel.models.engine import KmerEngine
    from dna_kmeres_parallel.models import oracle
    from dna_kmeres_parallel.ops import distance as dist_ops
    from dna_kmeres_parallel.utils.config import KmerConfig

    S, k = args.n_seqs, args.k
    rng = np.random.default_rng(54018)
    t0 = time.perf_counter()
    lengths = rng.integers(180, 521, S)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = [
        alphabet[rng.integers(0, 4, L)].tobytes().decode("ascii")
        for L in lengths
    ]
    print(
        json.dumps(
            {
                "phase": "synthesize",
                "n_seqs": S,
                "total_bases": int(lengths.sum()),
                "elapsed_s": round(time.perf_counter() - t0, 2),
            }
        ),
        flush=True,
    )

    eng = KmerEngine(KmerConfig(k=k))
    t_c = time.perf_counter()
    counts = eng.counts_matrix(seqs)  # warms the per-bucket count programs
    print(
        json.dumps(
            {
                "phase": "counts_matrix",
                "shape": list(counts.shape),
                "elapsed_s": round(time.perf_counter() - t_c, 2),
            }
        ),
        flush=True,
    )
    del counts
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    report = eng.distance_stream_to_csv(seqs, args.out, panel_rows=args.panel_rows)
    n_pairs = report["n_pairs"]
    report["phase"] = "distance_stream"
    report["pairs_per_sec"] = round(n_pairs / report["elapsed_s"], 1)
    print(json.dumps(report), flush=True)
    assert n_pairs == S * (S - 1) // 2, (n_pairs, S)

    # ---- spot-check sampled rows byte-for-byte against the oracle ------
    t0 = time.perf_counter()
    size = os.path.getsize(args.out)
    fixed9 = size == 9 * n_pairs  # every distance in [0,1] -> "d.dddddd\n"
    counts = oracle.counts_matrix(seqs, k).astype(np.int64)
    L = np.array([len(s) for s in seqs], dtype=np.int64)
    sample = sorted(
        int(i) for i in rng.choice(S - 1, size=args.sample_rows, replace=False)
    )
    checked = 0
    ok = True
    with open(args.out, "rb") as f:
        for i in sample:
            # packed strict-upper-triangle row i starts after rows 0..i-1:
            # sum_{r<i} (S-1-r) pairs.
            start_pair = i * (S - 1) - i * (i - 1) // 2
            row_pairs = S - 1 - i
            sums = np.minimum(counts[i][None, :], counts[i + 1 :]).sum(axis=1)
            d = dist_ops.finish_distances_panel(
                sums[None, :], L[i : i + 1], L[i + 1 :], k
            )[0]
            want = ("".join("%f\n" % v for v in d)).encode("ascii")
            if fixed9:
                f.seek(9 * start_pair)
                got = f.read(9 * row_pairs)
            else:  # variable-width fallback: scan (slow, correctness only)
                f.seek(0)
                for _ in range(start_pair):
                    f.readline()
                got = b"".join(f.readline() for _ in range(row_pairs))
            ok = ok and (got == want)
            checked += row_pairs
    print(
        json.dumps(
            {
                "phase": "spot_check",
                "rows": sample,
                "pairs_checked": checked,
                "bytes_fixed_width": fixed9,
                "exact": ok,
                "elapsed_s": round(time.perf_counter() - t0, 2),
            }
        ),
        flush=True,
    )
    print(
        json.dumps(
            {
                "phase": "summary",
                "n_seqs": S,
                "n_pairs": n_pairs,
                "k": k,
                "csv_bytes": size,
                "elapsed_s": report["elapsed_s"],
                "pairs_per_sec": report["pairs_per_sec"],
                "spot_check_exact": ok,
            }
        ),
        flush=True,
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
