#!/usr/bin/env python
"""Scale benchmark for the k>15 sparse-table distance path (VERDICT r2
item 4): S in the thousands at k=21, end-to-end (per-sequence tables +
threaded two-pointer pair min-sums + float32 finish + CSV), with a
host-thread scaling curve and sampled exactness vs the oracle.

Host-only path by design: the pairwise sorted-table intersection is an
irregular two-pointer merge (data-dependent advance, no matmul shape) — see
models/sparse_engine.distance_sparse_packed.

Usage: python scripts/sparse_distance_scale.py [S] [seq_len] [k]
"""

import json
import os
import sys
import time

import numpy as np


def main() -> int:
    S = int(sys.argv[1]) if len(sys.argv) > 1 else 5000
    seq_len = int(sys.argv[2]) if len(sys.argv) > 2 else 300
    k = int(sys.argv[3]) if len(sys.argv) > 3 else 21

    from dna_kmeres_parallel import native
    from dna_kmeres_parallel.models import oracle, sparse_engine
    from dna_kmeres_parallel.utils import io, triangular

    rng = np.random.default_rng(54018)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = [
        alpha[rng.integers(0, 4, size=int(rng.integers(seq_len - 60, seq_len + 60)))]
        .tobytes()
        .decode()
        for _ in range(S)
    ]
    n_pairs = S * (S - 1) // 2
    report = {"S": S, "k": k, "n_pairs": n_pairs,
              "native": native.available()}

    # Phase 1: per-sequence tables (the engine's own builder, so the
    # benchmark measures the path production takes — incl. device routing
    # for long sequences).
    t0 = time.perf_counter()
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    codes, cnts, offs = sparse_engine.build_pair_tables(seqs, k, False)
    report["tables_s"] = round(time.perf_counter() - t0, 3)
    report["table_entries"] = int(codes.shape[0])

    # Phase 2: pair min-sums, thread scaling curve.
    for nt in (1, 2, 4, 0):  # 0 = library default (all cores)
        os.environ["KMER_NATIVE_THREADS"] = str(nt) if nt else ""
        t0 = time.perf_counter()
        sums = native.min_sum_pairs_native(codes, cnts, offs)
        dt = time.perf_counter() - t0
        key = f"pairs_s_nt{nt or 'auto'}"
        report[key] = round(n_pairs / dt, 1)
        report[f"minsum_s_nt{nt or 'auto'}"] = round(dt, 3)
    os.environ.pop("KMER_NATIVE_THREADS", None)

    # Phase 3: float32 finish + CSV (bounded memory, native %f writer).
    t0 = time.perf_counter()
    out = sparse_engine.finish_distances_packed(sums, lengths, k)
    csv_path = "bench_out/sparse_dist_scale.csv"
    os.makedirs("bench_out", exist_ok=True)
    with open(csv_path, "wb") as f:
        f.write(native.format_f6(out))
    report["finish_csv_s"] = round(time.perf_counter() - t0, 3)
    report["csv_bytes"] = os.path.getsize(csv_path)

    # Exactness: sample pairs against the oracle's sparse twin.
    sample_rows = [0, S // 2, S - 2]
    ok = True
    for i in sample_rows:
        js = np.arange(i + 1, min(i + 6, S))
        sub = [seqs[i]] + [seqs[j] for j in js]
        want = oracle.distance_matrix_packed_sparse(sub, k)[: js.shape[0]]
        got = np.array(
            [out[triangular.packed_index(i, int(j), S)] for j in js],
            dtype=np.float32,
        )
        ok = ok and np.array_equal(got, want)
    report["sampled_exact"] = bool(ok)
    print(json.dumps(report))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
