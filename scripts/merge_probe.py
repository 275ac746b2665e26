#!/usr/bin/env python
"""Host merge microbench: loser tree vs AVX-512 merge ladder.

Synthesizes the row-sorted device output shape ([rows, m] independently
sorted words with sentinel tails) for the k=21 production layout
((u16, u32) split words) and times native.compact_rows_native. Run per
mode (KMER_NATIVE_MERGE is latched once per process):

    KMER_NATIVE_MERGE=tree   python scripts/merge_probe.py
    KMER_NATIVE_MERGE=ladder python scripts/merge_probe.py

or with no argv/env, self-spawns both modes and prints the comparison.
"""

import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_rows(n: int, m: int, kbits: int, hi_dtype, seed: int):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1 << kbits, size=n, dtype=np.uint64)
    rows = n // m
    codes = codes[: rows * m].reshape(rows, m)
    codes.sort(axis=1)
    lo = (codes & 0xFFFFFFFF).astype(np.uint32)
    if hi_dtype is None:
        return (np.ascontiguousarray(lo),), codes
    hi = (codes >> 32).astype(hi_dtype)
    return (np.ascontiguousarray(hi), np.ascontiguousarray(lo)), codes


def run_one(n: int, m: int, kbits: int, hi_dtype, reps: int = 3) -> float:
    from dna_kmeres_parallel import native

    words, codes = make_rows(n, m, kbits, hi_dtype, seed=1)
    # Correctness: counts must equal the global bincount.
    ref_c, ref_n = np.unique(codes.reshape(-1), return_counts=True)
    c, cnt = native.compact_rows_native(words)
    assert np.array_equal(c, ref_c) and np.array_equal(cnt, ref_n), "MISMATCH"
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        native.compact_rows_native(words)
        best = min(best, time.perf_counter() - t0)
    return n / best / 1e6


def main() -> int:
    n = int(os.environ.get("PROBE_N", str(16 << 20)))
    mode = os.environ.get("KMER_NATIVE_MERGE")
    shapes = [(512, 42, np.uint16), (2048, 42, np.uint16), (512, 30, None)]
    if mode:
        for m, kbits, hd in shapes:
            r = run_one(n, m, kbits, hd)
            label = "u32" if hd is None else "u16+u32"
            print(f"{mode:6s} m={m:5d} {label:8s} {r:8.1f} Melem/s")
        return 0
    for sub in ("tree", "ladder"):
        env = dict(os.environ, KMER_NATIVE_MERGE=sub)
        subprocess.run([sys.executable, __file__], env=env, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
