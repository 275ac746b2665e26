"""Golden-engine tests: hand-computed fixtures + cross-implementation checks."""

import numpy as np
import pytest

from dna_kmeres_parallel.models import oracle
from dna_kmeres_parallel.utils import codec
from dna_kmeres_parallel.utils.triangular import packed_index, packed_size


def test_hand_counted_k3():
    # "ACGTAC": windows ACG, CGT, GTA, TAC  (L-k+1 = 4 windows).
    hist = oracle.count_vector("ACGTAC", 3)
    assert hist.sum() == 4
    assert hist[codec.kmer_to_code("ACG")] == 1
    assert hist[codec.kmer_to_code("CGT")] == 1
    assert hist[codec.kmer_to_code("GTA")] == 1
    assert hist[codec.kmer_to_code("TAC")] == 1


def test_hand_counted_repeats():
    # "AAAAA" at k=3 -> 3 windows, all AAA.
    hist = oracle.count_vector("AAAAA", 3)
    assert hist[0] == 3 and hist.sum() == 3


def test_invalid_windows_excluded():
    # "ACGNACG": windows ACG, CGN, GNA, NAC, ACG -> only 2 valid (both ACG).
    hist = oracle.count_vector("ACGNACG", 3)
    assert hist.sum() == 2
    assert hist[codec.kmer_to_code("ACG")] == 2


def test_window_count_exact(make_dna):
    # Contract 2: L-k+1 windows (loop bounds main.cu:641 / kernels.h:133).
    for L, k in [(10, 3), (100, 4), (57, 11)]:
        s = make_dna(L)
        assert oracle.count_vector(s, k).sum() == L - k + 1


def test_count_vector_vs_naive(make_dna):
    s = make_dna(400, invalid_frac=0.05)
    for k in (3, 4, 6):
        assert np.array_equal(
            oracle.count_vector(s, k), oracle.naive_count_vector(s, k)
        )


def test_canonical_folding(make_dna):
    s = make_dna(500)
    k = 5
    plain = oracle.count_vector(s, k)
    canon = oracle.count_vector(s, k, canonical=True)
    assert canon.sum() == plain.sum()
    # Canonical counts = plain counts folded onto min(code, rc).
    folded = np.zeros_like(plain)
    for c in np.nonzero(plain)[0]:
        folded[codec.canonical_code(int(c), k)] += plain[c]
    assert np.array_equal(canon, folded)
    # Strand invariance: counting the reverse complement gives the same table.
    rc = codec.revcomp_str(s)
    assert np.array_equal(canon, oracle.count_vector(rc, k, canonical=True))


def test_distance_identical_sequences():
    # Two identical sequences share all windows -> distance 0.
    d = oracle.distance_matrix_packed(["ACGTACGT", "ACGTACGT"], 3)
    assert d.shape == (1,)
    assert d[0] == pytest.approx(0.0)


def test_distance_disjoint_sequences():
    # No shared k-mers -> distance 1.
    d = oracle.distance_matrix_packed(["AAAAAA", "CCCCCC"], 3)
    assert d[0] == pytest.approx(1.0)


def test_distance_hand_computed():
    # s1="ACGTAC" (ACG,CGT,GTA,TAC), s2="ACGACG" (ACG,CGA,GAC,ACG).
    # shared min-sum = min(1,2)[ACG] = 1; minLen=6, denom = 6-3+1 = 4.
    # D = 1 - 1/4 = 0.75.
    d = oracle.distance_matrix_packed(["ACGTAC", "ACGACG"], 3)
    assert d[0] == pytest.approx(0.75)


def test_distance_denominator_uses_shorter():
    # s1 has 6 windows, s2 has 2; denominator is the shorter's window count.
    s1, s2 = "AAAAAAAA", "AAAA"  # k=3: 6 and 2 windows, min-sum = 2.
    d = oracle.distance_matrix_packed([s1, s2], 3)
    assert d[0] == pytest.approx(1.0 - 2.0 / 2.0)


def test_distance_float32_semantics():
    # Division is float32 (main.cu:614); check the dtype and a non-trivial value.
    d = oracle.distance_matrix_packed(["ACGTACG", "TTTACGA"], 3)
    assert d.dtype == np.float32
    s = np.minimum(
        oracle.count_vector("ACGTACG", 3), oracle.count_vector("TTTACGA", 3)
    ).sum()
    assert d[0] == np.float32(1.0) - np.float32(s) / np.float32(5)


def test_packed_layout(make_dna):
    seqs = [make_dna(30) for _ in range(5)]
    d = oracle.distance_matrix_packed(seqs, 3)
    assert d.shape == (packed_size(5),)
    # Spot-check position of pair (1,3).
    expected = oracle.distance_pair(
        oracle.count_vector(seqs[1], 3),
        oracle.count_vector(seqs[3], 3),
        len(seqs[1]),
        len(seqs[3]),
        3,
    )
    assert d[packed_index(1, 3, 5)] == expected


def test_count_table_keys(make_dna):
    s = make_dna(100)
    table = oracle.count_table([s], 4)
    assert sum(table.values()) == len(s) - 4 + 1
    for kmer in table:
        assert len(kmer) == 4 and all(c in "ACGT" for c in kmer)


@pytest.mark.parametrize("n_rows", [0, 1, 3, 9])
def test_distance_rows_packed_is_a_prefix(make_dna, n_rows):
    # The row panel is the first rows of the packed matrix, any k.
    seqs = [make_dna(60 + 7 * i, invalid_frac=0.02) for i in range(8)]
    full = oracle.distance_matrix_packed(seqs, 3)
    panel = oracle.distance_rows_packed(seqs, 3, n_rows)
    assert np.array_equal(panel, full[: panel.shape[0]])
    rows = min(n_rows, len(seqs) - 1)
    assert panel.shape[0] == sum(len(seqs) - 1 - i for i in range(rows))
