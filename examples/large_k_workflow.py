#!/usr/bin/env python
"""Large-k counting workflow through the library API.

Demonstrates the k=21 production path end-to-end on synthetic data:
generate a FASTA, stream-count it with checkpointing (the no-device-sort
route: encode-only device program + native radix host compactor), look up
k-mers, compute the count spectrum, and cross-check the C++ host engine
against the accelerated engine table-for-table.

    python examples/large_k_workflow.py [outdir]

Runs on whatever backend JAX finds (GPU or CPU) — every path is exact, so
the outputs are identical either way.
"""

import json
import pathlib
import sys

# Runnable from anywhere without installing the package.
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv):
    import numpy as np

    outdir = pathlib.Path(argv[1] if len(argv) > 1 else "bench_out/kmer_demo")
    outdir.mkdir(parents=True, exist_ok=True)
    fasta_path = outdir / "demo.fasta"
    k = 21

    from dna_kmeres_parallel.utils.datagen import random_fasta

    total = random_fasta(str(fasta_path), n_seqs=8, seq_len=50_000, seed=3,
                         invalid_frac=0.001)

    # 1) Streamed, checkpointed counting (KmerConfig.device_sort=None auto-
    #    routes to the encode-only device program when the native radix
    #    compactor is built).
    from dna_kmeres_parallel.models.pipeline import StreamingCounter
    from dna_kmeres_parallel.utils.config import KmerConfig

    counter = StreamingCounter(
        KmerConfig(k=k), checkpoint_path=str(outdir / "ck.npz")
    )
    result = counter.run(str(fasta_path))
    print(json.dumps({
        "bases": total,
        "total_kmers": result.total_kmers,
        "distinct_kmers": result.distinct_kmers,
        "phases": counter.metrics.report()["phase_seconds"],
    }, indent=2))

    # 2) Point lookups (canonical-aware when the table is canonical).
    some = [result.codes[i] for i in range(0, result.codes.shape[0], max(result.codes.shape[0] // 3, 1))][:3]
    from dna_kmeres_parallel.utils import codec

    for code in some:
        kmer = codec.code_to_kmer(int(code), k)
        assert result.count_of(kmer) >= 1

    # 3) Count spectrum (count-of-counts).
    spectrum = np.bincount(np.minimum(result.counts, 10))
    print("spectrum[1..4]:", spectrum[1:5].tolist())

    # 4) Cross-check the C++ host engine (no device at all): tables must be
    #    bit-identical — the three-way differential the CLI selftest runs.
    from dna_kmeres_parallel import native

    if native.available():
        parsed = native.parse_fasta_native(str(fasta_path))
        codes, counts = native.count_sparse_host_native(parsed.stream, k)
        assert np.array_equal(codes, result.codes)
        assert np.array_equal(counts, result.counts)
        print("C++ host engine table: bit-identical")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
