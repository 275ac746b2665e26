"""Unit tests for the 2-bit codec (SURVEY.md §4 unit-test plan)."""

import numpy as np
import pytest

from dna_kmeres_parallel.utils import codec


def test_encode_decode_roundtrip(make_dna):
    s = make_dna(1000, invalid_frac=0.05)
    bases = codec.encode_bases(s)
    assert bases.shape == (1000,)
    decoded = codec.decode_bases(bases)
    expected = "".join(ch if ch in "ACGT" else "N" for ch in s)
    assert decoded == expected


def test_base_order_matches_reference():
    # A=0, C=1, G=2, T=3 — the 2-bit encoding sketched at
    # /root/reference/main.cu:78-86 ("00->A, 01->C, 10->G, 11->T").
    assert codec.encode_bases("ACGT").tolist() == [0, 1, 2, 3]
    assert codec.encode_bases("acgtNX-").tolist() == [0xFF] * 7


def test_kmer_code_lexicographic():
    # Canonical space is lexicographic: AAA=0, AAC=1, ..., TTT=63.
    assert codec.kmer_to_code("AAA") == 0
    assert codec.kmer_to_code("AAC") == 1
    assert codec.kmer_to_code("TTT") == 63
    assert codec.kmer_to_code("CAA") == 16
    for c in [0, 1, 17, 42, 63]:
        assert codec.kmer_to_code(codec.code_to_kmer(c, 3)) == c


def test_rolling_equals_direct(make_dna):
    # Property: kmer_codes (shift-accumulate) == per-window kmer_to_code.
    s = make_dna(300, invalid_frac=0.03)
    k = 5
    codes, valid = codec.kmer_codes(codec.encode_bases(s), k)
    assert codes.shape == valid.shape == (len(s) - k + 1,)
    for i in range(len(s) - k + 1):
        window = s[i : i + k]
        if all(ch in "ACGT" for ch in window):
            assert valid[i]
            assert codes[i] == codec.kmer_to_code(window)
        else:
            assert not valid[i]


def test_kmer_codes_short_sequence():
    codes, valid = codec.kmer_codes(codec.encode_bases("AC"), 3)
    assert codes.size == 0 and valid.size == 0


def test_revcomp_involution(make_dna):
    k = 7
    codes = np.arange(0, 4**k, 97)
    rc = codec.revcomp_code(codes, k)
    assert np.array_equal(codec.revcomp_code(rc, k), codes)


def test_revcomp_matches_string():
    for kmer in ["ACGTACG", "AAAAAAA", "TTTGGCC", "GATTACA"]:
        k = len(kmer)
        rc_str = codec.revcomp_str(kmer)
        assert codec.revcomp_code(codec.kmer_to_code(kmer), k) == codec.kmer_to_code(rc_str)


def test_canonical_code():
    # canonical = min(code, rc) and is strand-invariant.
    for kmer in ["ACGT", "TTTT", "GATC", "CCGG"]:
        k = len(kmer)
        c = codec.kmer_to_code(kmer)
        c_rc = codec.kmer_to_code(codec.revcomp_str(kmer))
        assert codec.canonical_code(c, k) == codec.canonical_code(c_rc, k)
        assert codec.canonical_code(c, k) == min(c, c_rc)


@pytest.mark.parametrize("length", [0, 1, 3, 4, 5, 8, 100, 1001])
def test_pack_unpack_roundtrip(make_dna, length):
    s = make_dna(length, invalid_frac=0.1)
    bases = codec.encode_bases(s)
    packed, mask, L = codec.pack_bases(bases)
    assert L == length
    assert packed.shape[0] == (length + 3) // 4
    assert mask.shape[0] == (length + 7) // 8
    restored = codec.unpack_bases(packed, mask, L)
    assert np.array_equal(restored, bases)


def test_pack_density():
    # 4 bases/byte: 1 GB of bases -> 250 MB packed (+ 125 MB mask).
    bases = codec.encode_bases("ACGT" * 256)
    packed, mask, L = codec.pack_bases(bases)
    assert packed.nbytes * 4 == L
    assert mask.nbytes * 8 == L


def test_all_kmers_enumeration():
    # The explicit vocabulary in lexicographic order (reference utils.h:21-50
    # equivalent): AAA, AAC, AAG, AAT, ACA, ...
    kmers = codec.all_kmers(3)
    assert len(kmers) == 64
    assert kmers[:5] == ["AAA", "AAC", "AAG", "AAT", "ACA"]
    assert kmers[-1] == "TTT"
    assert kmers == sorted(kmers)
    for i, km in enumerate(kmers):
        assert codec.kmer_to_code(km) == i
