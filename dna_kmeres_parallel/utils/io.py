"""Result writers: distance CSVs (reference-compatible), count tables, reports.

The reference emits one float per line with C's ``%f`` (6 decimals) to
``sequential_results.csv`` / ``parallel_results.csv``
(/root/reference/main.cu:201,357) and a ragged lower-triangle TSV via
``printMinDistances`` (/root/reference/utils.h:52-63). Both formats are
reproduced here so outputs are byte-diffable against the reference's.
"""

from __future__ import annotations

import json
from typing import Mapping

import numpy as np


def write_distances_csv(path, packed: np.ndarray) -> None:
    """One float per line, C "%f" format — byte-compatible with the
    reference's sequential/parallel results CSVs (main.cu:201,357).
    Formats through the multithreaded native snprintf path when built
    (same libc %f digits; a Python "%f" loop costs ~500 ns/value, ~12
    minutes at the reference's 1.46G-pair design scale)."""
    from dna_kmeres_parallel import native

    with open(path, "wb") as f:
        f.write(native.format_f6(np.asarray(packed, dtype=np.float32)))


def write_min_distances_tsv(path, packed: np.ndarray, n: int) -> None:
    """Ragged rows TSV: row i holds distances (i, i+1..n-1), "%.2f\\t" per
    entry — the printMinDistances format (utils.h:52-63)."""
    packed = np.asarray(packed, dtype=np.float32)
    with open(path, "w", encoding="ascii") as f:
        pos = 0
        for row_len in range(n - 1, 0, -1):
            f.write("".join("%.2f\t" % v for v in packed[pos : pos + row_len]))
            f.write("\n")
            pos += row_len


def write_count_table_csv(path, table: Mapping[str, int]) -> None:
    """k-mer frequency table: "kmer,count" per line, lexicographic order."""
    with open(path, "w", encoding="ascii") as f:
        f.write("kmer,count\n")
        for kmer in sorted(table):
            f.write(f"{kmer},{table[kmer]}\n")


def write_count_npz(path, result) -> None:
    """Binary count-table export: dense histograms save as `hist`; sparse
    results save as sorted (`codes` uint64, `counts` int64). Metadata in
    `k`/`canonical`. Loadable with np.load.

    Large sparse tables are written uncompressed: k-mer codes are near-
    incompressible and gzip cost dominated a 100 MB-input run (minutes of
    CPU for ~0 ratio)."""
    meta = {"k": result.k, "canonical": result.canonical}
    if hasattr(result, "hist"):
        save = np.savez_compressed if result.hist.nbytes < (64 << 20) else np.savez
        save(path, hist=result.hist, **meta)
    else:
        big = result.codes.nbytes + result.counts.nbytes >= (16 << 20)
        save = np.savez if big else np.savez_compressed
        save(path, codes=result.codes, counts=result.counts, **meta)


def read_count_npz(path):
    """Load a count-table npz (write_count_npz's format). Returns
    (k, canonical, codes_u64, counts_i64) — dense histograms are converted
    to their sparse nonzero form so merging treats both uniformly."""
    with np.load(path) as z:
        k = int(z["k"])
        canonical = bool(z["canonical"])
        if "hist" in z:
            hist = z["hist"]
            codes = np.nonzero(hist)[0].astype(np.uint64)
            counts = hist[codes.astype(np.int64)].astype(np.int64)
        else:
            codes = z["codes"].astype(np.uint64)
            counts = z["counts"].astype(np.int64)
    return k, canonical, codes, counts


def read_distances_csv(path) -> np.ndarray:
    with open(path, "r", encoding="ascii") as f:
        return np.array([float(x) for x in f if x.strip()], dtype=np.float32)


def write_report_json(path, report: Mapping) -> None:
    """Structured run report (counts, timings, config) — the framework's
    replacement for the reference's printf timing lines (main.cu:300,344)."""
    with open(path, "w", encoding="ascii") as f:
        json.dump(report, f, indent=2, sort_keys=True, default=str)
        f.write("\n")
