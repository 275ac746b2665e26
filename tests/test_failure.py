"""Fault injection: transient device failures are retried, fatal ones surface."""

import numpy as np
import pytest

from dna_kmeres_parallel.models import oracle
from dna_kmeres_parallel.models.pipeline import StreamingCounter
from dna_kmeres_parallel.utils import fasta
from dna_kmeres_parallel.utils.config import KmerConfig


class FakeInternalError(Exception):
    """Mimics a transient runtime failure (name matches the retry filter)."""


@pytest.fixture
def fasta_file(tmp_path, make_dna):
    records = [(f">r{i}", make_dna(300)) for i in range(5)]
    path = tmp_path / "f.fasta"
    fasta.write_fasta(path, records)
    return str(path), [s for _, s in records]


def test_transient_failures_retried(fasta_file, monkeypatch):
    path, seqs = fasta_file
    import dna_kmeres_parallel.models.pipeline as pipeline_mod

    real = pipeline_mod._count_batch_packed
    fails = {"n": 2}  # within max_retries=2 for the first batch

    def flaky(*a, **kw):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise FakeInternalError("Internal: transient DMA failure (injected)")
        return real(*a, **kw)

    monkeypatch.setattr(pipeline_mod, "_count_batch_packed", flaky)
    sc = StreamingCounter(KmerConfig(k=4, batch_bases=256), max_retries=2)
    result = sc.run(path)
    want = sum(
        (oracle.count_vector(s, 4) for s in seqs), np.zeros(256, np.int64)
    )
    assert np.array_equal(result.hist, want)
    assert sc.metrics.counters["batch_retries"] == 2


def test_fatal_failures_surface(fasta_file, monkeypatch):
    path, _ = fasta_file
    import dna_kmeres_parallel.models.pipeline as pipeline_mod

    def broken(*a, **kw):
        raise ValueError("deterministic bug — must not be retried")

    monkeypatch.setattr(pipeline_mod, "_count_batch_packed", broken)
    sc = StreamingCounter(KmerConfig(k=4), max_retries=5)
    with pytest.raises(ValueError):
        sc.run(path)
    assert "batch_retries" not in sc.metrics.counters


def test_retries_exhausted(fasta_file, monkeypatch):
    path, _ = fasta_file
    import dna_kmeres_parallel.models.pipeline as pipeline_mod

    def always_transient(*a, **kw):
        raise FakeInternalError("Internal: persistent failure")

    monkeypatch.setattr(pipeline_mod, "_count_batch_packed", always_transient)
    sc = StreamingCounter(KmerConfig(k=4), max_retries=2)
    with pytest.raises(FakeInternalError):
        sc.run(path)
