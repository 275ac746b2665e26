"""Triangular index math: bijection + equivalence with the reference formula."""

import numpy as np

from dna_kmeres_parallel.utils import triangular as tri


def test_matches_reference_formula():
    # Our 0-based formula == the reference's 1-based one
    # (/root/reference/kernels.h:46-48 called as (i+1, j-i, n),
    #  main.cu:106,609).
    for n in (2, 3, 5, 17, 100):
        for i in range(n - 1):
            for j in range(i + 1, n):
                assert tri.packed_index(i, j, n) == tri.packed_index_reference(
                    i + 1, j - i, n
                )


def test_bijection():
    n = 23
    seen = set()
    for i in range(n - 1):
        for j in range(i + 1, n):
            idx = tri.packed_index(i, j, n)
            assert 0 <= idx < tri.packed_size(n)
            seen.add(idx)
    assert len(seen) == tri.packed_size(n)


def test_row_major_order():
    # Packed order enumerates pairs (0,1),(0,2),...,(0,n-1),(1,2),...
    n = 9
    rows, cols = tri.unpack_indices(n)
    idx = tri.packed_index(rows, cols, n)
    assert np.array_equal(idx, np.arange(tri.packed_size(n)))


def test_square_roundtrip():
    n = 12
    packed = np.arange(tri.packed_size(n), dtype=np.float32)
    sq = tri.packed_to_square(packed, n)
    assert np.array_equal(sq, sq.T)
    assert np.array_equal(tri.square_to_packed(sq), packed)
