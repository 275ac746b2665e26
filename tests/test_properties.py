"""Property-based tests (hypothesis) for the codec and counting invariants."""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from dna_kmeres_parallel.models import oracle
from dna_kmeres_parallel.utils import codec

dna = st.text(alphabet="ACGT", min_size=0, max_size=200)
dna_with_junk = st.text(alphabet="ACGTNacgt-", min_size=0, max_size=200)
ks = st.integers(min_value=1, max_value=8)


@settings(max_examples=60, deadline=None)
@given(dna_with_junk, ks)
def test_window_count_invariant(s, k):
    # Total counts == number of fully-valid windows, <= L-k+1.
    hist = oracle.count_vector(s, k)
    n_windows = max(len(s) - k + 1, 0)
    valid_windows = sum(
        1
        for i in range(n_windows)
        if all(c in "ACGT" for c in s[i : i + k])
    )
    assert hist.sum() == valid_windows


@settings(max_examples=60, deadline=None)
@given(dna, ks)
def test_rolling_matches_per_window(s, k):
    codes, valid = codec.kmer_codes(codec.encode_bases(s), k)
    for i in range(max(len(s) - k + 1, 0)):
        assert valid[i]
        assert codes[i] == codec.kmer_to_code(s[i : i + k])


@settings(max_examples=60, deadline=None)
@given(dna, ks)
def test_canonical_strand_invariance(s, k):
    a = oracle.count_vector(s, k, canonical=True)
    b = oracle.count_vector(codec.revcomp_str(s), k, canonical=True)
    assert np.array_equal(a, b)


@settings(max_examples=60, deadline=None)
@given(dna_with_junk)
def test_pack_roundtrip_property(s):
    bases = codec.encode_bases(s)
    packed, mask, L = codec.pack_bases(bases)
    assert np.array_equal(codec.unpack_bases(packed, mask, L), bases)


@settings(max_examples=40, deadline=None)
@given(st.integers(min_value=1, max_value=12), st.integers(min_value=0))
def test_code_kmer_bijection(k, seed):
    code = seed % (4**k)
    assert codec.kmer_to_code(codec.code_to_kmer(code, k)) == code


@settings(max_examples=40, deadline=None)
@given(dna, st.integers(min_value=2, max_value=6))
def test_split_concat_additivity(s, k):
    # Counting s split anywhere (with halo semantics via concatenation of
    # count tables) equals counting s whole when split point respects the
    # halo: hist(s) == hist(s[:i+k-1] windows<i) + hist(s[i:]).
    if len(s) < k + 2:
        return
    i = len(s) // 2
    whole = oracle.count_vector(s, k)
    left = oracle.count_vector(s[: i + k - 1], k)
    right = oracle.count_vector(s[i:], k)
    assert np.array_equal(whole, left + right)


_dna_n = st.text(alphabet="ACGTN", min_size=0, max_size=300)


def _native_available():
    from dna_kmeres_parallel import native

    return native.available()


@pytest.mark.skipif(not _native_available(), reason="native lib unavailable")
@settings(max_examples=40, deadline=None)
@given(s=_dna_n, k=st.integers(5, 31), canonical=st.booleans())
def test_native_host_engine_property(s, k, canonical):
    """C++ host engine == oracle for arbitrary streams (invalid chars,
    short tails, any k/canonical) — the rolling fwd+rc encoder and the
    radix compactor under fuzz."""
    from dna_kmeres_parallel import native

    stream = codec.encode_bases(s)
    codes, counts = native.count_sparse_host_native(stream, k, canonical)
    want = oracle.count_table_any_k([s], k, canonical)
    got = {codec.code_to_kmer(int(c), k): int(n) for c, n in zip(codes, counts)}
    assert got == want


@pytest.mark.skipif(not _native_available(), reason="native lib unavailable")
@settings(max_examples=30, deadline=None)
@given(
    n=st.integers(0, 2000),
    k=st.sampled_from([13, 16, 17, 21, 24, 31]),
    frac=st.floats(0.0, 1.0),
    seed=st.integers(0, 2**31 - 1),
)
def test_compact_unsorted_property(n, k, frac, seed):
    """Radix compactor == np.unique over arbitrary word streams with
    arbitrary sentinel density (incl. all-sentinel and empty)."""
    from dna_kmeres_parallel import native
    from dna_kmeres_parallel.ops import sparse as sparse_ops

    rng = np.random.default_rng(seed)
    kbits = 2 * k
    codes = rng.integers(0, 1 << kbits, size=n, dtype=np.uint64)
    sent = rng.random(n) < frac
    hi_dtype = sparse_ops.hi_dtype(k)
    if hi_dtype is None:
        lo = np.where(sent, np.uint32(0xFFFFFFFF), codes.astype(np.uint32))
        words = (lo.astype(np.uint32),)
    else:
        lo = np.where(
            sent, np.uint32(0xFFFFFFFF), (codes & 0xFFFFFFFF).astype(np.uint32)
        )
        width = np.dtype(np.uint16 if hi_dtype == np.uint16 else np.uint32)
        hi_all1 = np.uint64(0xFFFF if width == np.uint16 else 0xFFFFFFFF)
        hi = np.where(sent, hi_all1, codes >> np.uint64(32)).astype(width)
        words = (hi, lo)
    got_c, got_n = native.compact_unsorted_native(words, kbits)
    want_c, want_n = np.unique(codes[~sent], return_counts=True)
    assert np.array_equal(got_c, want_c)
    assert np.array_equal(got_n, want_n.astype(np.int64))
