"""Sanitizer-style runs (SURVEY.md §5 race-detection plan): the oracle
equality suite under jax_debug_nans, and degenerate-input robustness."""

import jax
import numpy as np
import pytest

from dna_kmeres_parallel.models import oracle
from dna_kmeres_parallel.models.engine import KmerEngine
from dna_kmeres_parallel.utils.config import KmerConfig


@pytest.fixture
def debug_nans():
    jax.config.update("jax_debug_nans", True)
    yield
    jax.config.update("jax_debug_nans", False)


def test_distance_under_debug_nans(make_dna, debug_nans):
    seqs = [make_dna(120) for _ in range(6)]
    result = KmerEngine(KmerConfig(k=3)).distance_sequences(seqs)
    want = oracle.distance_matrix_packed(seqs, 3)
    assert np.array_equal(result.packed, want)


def test_count_under_debug_nans(make_dna, debug_nans):
    seqs = [make_dna(200, invalid_frac=0.05) for _ in range(3)]
    result = KmerEngine(KmerConfig(k=4)).count_sequences(seqs)
    want = sum(
        (oracle.count_vector(s, 4) for s in seqs), np.zeros(256, np.int64)
    )
    assert np.array_equal(result.hist, want)


def test_degenerate_inputs():
    engine = KmerEngine(KmerConfig(k=3))
    # All-invalid sequence: zero counts, no crash.
    r = engine.count_sequences(["NNNNNNNN"])
    assert r.total_kmers == 0
    # Sequences shorter than k contribute nothing.
    r = engine.count_sequences(["A", "AC", ""])
    assert r.total_kmers == 0


def test_distance_shorter_than_k():
    # minLength < k gives denominator <= 0 — the reference divides anyway
    # (main.cu:614); we reproduce the formula without crashing.
    engine = KmerEngine(KmerConfig(k=3))
    result = engine.distance_sequences(["ACGTACGT", "AC"])
    want = oracle.distance_matrix_packed(["ACGTACGT", "AC"], 3)
    # denominator 0 with zero shared windows -> NaN on both engines.
    assert np.array_equal(result.packed, want, equal_nan=True)
