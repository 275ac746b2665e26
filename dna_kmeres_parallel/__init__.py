"""dna_kmeres_parallel — an exact k-mer counting / k-mer distance framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
CUDA project ``axlwild/dna-kmeres-parallel`` (see /root/reference): FASTA
ingestion, exact k-mer counting over the ACGT alphabet, and pairwise fractional
common-k-mer-count distance matrices — extended with 2-bit packed encoding,
rolling k-mer codes, reverse-complement canonicalization, dense and sparse
(sorted) histograms for large k, and multi-device data-parallel sharding with
exact integer collective merges.

Layout
------
- ``utils/``     host-side primitives: codec, FASTA parsing, triangular index
                 math, config, CSV/reporting IO, checkpointing.
- ``models/``    engines: the NumPy golden oracle (exact reference semantics)
                 and the device engine / streaming pipeline built on top of ops.
- ``ops/``       device compute: rolling-code encoding, histograms
                 (scatter / sort-based), pairwise (min,+) distance
                 reductions, and the Pallas-Triton (min,+) kernel.
- ``parallel/``  meshes, shard_map data-parallel counting with psum merges,
                 bucket-sharded histograms with all_to_all exchange,
                 multi-host glue.
- ``native/``    C++ FASTA parser + 2-bit packer (ctypes extension) — the
                 host-side hot path.

Correctness contract: every accelerated path must match
``models.oracle`` count-for-count and distance-for-distance (float32); the
oracle itself reproduces the reference semantics documented in SURVEY.md §2.4.
"""

__version__ = "0.1.0"

from dna_kmeres_parallel.utils.config import KmerConfig  # noqa: F401


def count_file(path, k: int = 21, canonical: bool = False, **kw):
    """Count k-mers in a FASTA file. Returns CountResult (dense, k <= 12)
    or SparseCountResult (sorted table, larger k)."""
    cfg = KmerConfig(k=k, canonical=canonical, **kw)
    if cfg.bins <= cfg.dense_bins_limit:
        from dna_kmeres_parallel.models.engine import KmerEngine

        return KmerEngine(cfg).count_file(path)
    from dna_kmeres_parallel.models.sparse_engine import SparseKmerEngine

    return SparseKmerEngine(cfg).count_file(path)


def count_sequences(seqs, k: int = 21, canonical: bool = False, **kw):
    """Count k-mers over in-memory sequences (list of ACGT strings)."""
    cfg = KmerConfig(k=k, canonical=canonical, **kw)
    if cfg.bins <= cfg.dense_bins_limit:
        from dna_kmeres_parallel.models.engine import KmerEngine

        return KmerEngine(cfg).count_sequences(list(seqs))
    from dna_kmeres_parallel.models.sparse_engine import SparseKmerEngine

    return SparseKmerEngine(cfg).count_sequences(list(seqs))


def distance_file(path, k: int = 3, **kw):
    """Pairwise k-mer distance matrix of a FASTA file (DistanceResult)."""
    from dna_kmeres_parallel.models.engine import KmerEngine

    return KmerEngine(KmerConfig(k=k, **kw)).distance_file(path)


def distance_sequences(seqs, k: int = 3, **kw):
    """Pairwise k-mer distance matrix over in-memory sequences."""
    from dna_kmeres_parallel.models.engine import KmerEngine

    return KmerEngine(KmerConfig(k=k, **kw)).distance_sequences(list(seqs))


__all__ = [
    "KmerConfig",
    "__version__",
    "count_file",
    "count_sequences",
    "distance_file",
    "distance_sequences",
]
