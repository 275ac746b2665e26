"""Engine end-to-end with the Pallas (min,+) kernel forced into
interpreter mode.

Exercises the code paths the GPU takes (kernel selection, halo masking,
distance finish, route reporting) without a card.
"""

import numpy as np
import pytest

from dna_kmeres_parallel.models import oracle
from dna_kmeres_parallel.models.engine import KmerEngine
from dna_kmeres_parallel.ops import runtime
from dna_kmeres_parallel.utils.config import KmerConfig


@pytest.fixture(autouse=True)
def force_pallas_interpret(monkeypatch):
    monkeypatch.setenv("KMER_PALLAS_INTERPRET", "1")
    yield


def test_pallas_mode_env(monkeypatch):
    be = runtime.backend()
    assert be.kernel == "interpret"
    assert be.platform == "cpu" and not be.accelerator
    monkeypatch.delenv("KMER_PALLAS_INTERPRET")
    # On the CPU test backend with no forcing, XLA's (min,+) is selected.
    assert runtime.backend().kernel is None


def test_count_via_pallas_matches_oracle(make_dna):
    seqs = [make_dna(400, invalid_frac=0.02) for _ in range(4)]
    result = KmerEngine(KmerConfig(k=5, batch_bases=512)).count_sequences(seqs)
    want = sum(
        (oracle.count_vector(s, 5) for s in seqs),
        np.zeros(4**5, dtype=np.int64),
    )
    assert np.array_equal(result.hist, want)


def test_count_k11_multigroup_via_pallas(make_dna):
    seqs = [make_dna(800)]
    result = KmerEngine(KmerConfig(k=11)).count_sequences(seqs)
    want = oracle.count_vector(seqs[0], 11)
    assert np.array_equal(result.hist, want)


def test_distance_via_pallas_bitexact(make_dna):
    seqs = [make_dna(90 + 11 * i, invalid_frac=0.02) for i in range(9)]
    result = KmerEngine(KmerConfig(k=3)).distance_sequences(seqs)
    want = oracle.distance_matrix_packed(seqs, 3)
    assert result.route == "pallas-min-plus"
    assert np.array_equal(result.packed, want)


def test_canonical_count_via_pallas(make_dna):
    seqs = [make_dna(300) for _ in range(3)]
    result = KmerEngine(KmerConfig(k=6, canonical=True)).count_sequences(seqs)
    want = sum(
        (oracle.count_vector(s, 6, canonical=True) for s in seqs),
        np.zeros(4**6, dtype=np.int64),
    )
    assert np.array_equal(result.hist, want)


@pytest.mark.parametrize("k,canonical", [(4, False), (6, True), (8, False)])
def test_count_stream_planes_route_exact(make_dna, k, canonical):
    """The dense band over the 2-bit packed wire format (pack_input):
    count_sequences must equal the oracle bin-for-bin, packed or not."""
    seqs = [make_dna(300 + 17 * i, invalid_frac=0.03) for i in range(5)]
    cfg = KmerConfig(k=k, canonical=canonical, pack_input=True,
                     batch_bases=512)
    res = KmerEngine(cfg).count_sequences(seqs)
    want = sum(
        (oracle.count_vector(s, k, canonical) for s in seqs),
        np.zeros(4**k, np.int64),
    )
    assert np.array_equal(res.hist.astype(np.int64), want)
    res2 = KmerEngine(cfg.replace(pack_input=False)).count_sequences(seqs)
    assert np.array_equal(res2.hist.astype(np.int64), want)
