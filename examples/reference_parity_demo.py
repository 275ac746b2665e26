#!/usr/bin/env python
"""Reference-parity demo: reproduce the reference program end-to-end.

The reference binary (/root/reference/main.cu:120-174) parses a FASTA file,
counts k=3 k-mers per sequence, computes the pairwise distance matrix twice
(CPU golden engine + GPU engine) and writes both as one-float-per-line CSVs
to be diffed. This script does exactly that with this framework's engines:

  python examples/reference_parity_demo.py input.fasta outdir/

writes outdir/sequential_results.csv (NumPy oracle), outdir/
parallel_results.csv (device engine), outdir/min_distances.csv (the
printMinDistances TSV, utils.h:52-63), diffs the two CSVs, and prints a
JSON verdict — the dual-engine differential the reference intended, as an
executable check.
"""

import json
import pathlib
import sys
import time

# Runnable from anywhere without installing the package.
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv):
    if len(argv) != 3:
        print(__doc__)
        return 2
    fasta_path, outdir = argv[1], pathlib.Path(argv[2])
    outdir.mkdir(parents=True, exist_ok=True)

    from dna_kmeres_parallel.models import oracle
    from dna_kmeres_parallel.models.engine import KmerEngine
    from dna_kmeres_parallel.utils import fasta, io
    from dna_kmeres_parallel.utils.config import KmerConfig

    # Reference semantics: k=3 (kernels.h:14), MAX_SEQS=100 cap (main.cu:30).
    records = fasta.parse_fasta(fasta_path, max_seqs=100)
    seqs = [r.seq for r in records]

    t0 = time.perf_counter()
    sequential = oracle.distance_matrix_packed(seqs, 3)
    t_cpu = time.perf_counter() - t0
    io.write_distances_csv(outdir / "sequential_results.csv", sequential)

    engine = KmerEngine(KmerConfig(k=3, max_seqs=100))
    t0 = time.perf_counter()
    parallel = engine.distance_sequences(seqs).packed
    t_dev = time.perf_counter() - t0
    io.write_distances_csv(outdir / "parallel_results.csv", parallel)
    io.write_min_distances_tsv(outdir / "min_distances.csv", parallel, len(seqs))

    a = (outdir / "sequential_results.csv").read_bytes()
    b = (outdir / "parallel_results.csv").read_bytes()
    print(
        json.dumps(
            {
                "n_seqs": len(seqs),
                "n_pairs": int(sequential.shape[0]),
                "elapsed_serial_s": round(t_cpu, 4),
                "elapsed_parallel_s": round(t_dev, 4),
                "csvs_byte_identical": a == b,
            }
        )
    )
    return 0 if a == b else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
