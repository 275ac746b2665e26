"""Device-op tests: jnp encode/histogram/distance vs the NumPy oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from dna_kmeres_parallel.models import oracle
from dna_kmeres_parallel.ops import distance as dist_ops
from dna_kmeres_parallel.ops import encode as encode_ops
from dna_kmeres_parallel.ops import histogram as hist_ops
from dna_kmeres_parallel.utils import codec


def _codes(s, k):
    bases = jnp.asarray(codec.encode_bases(s))
    return encode_ops.rolling_codes(bases, k)


def test_ascii_to_bases():
    raw = jnp.asarray(np.frombuffer(b"ACGTNacgt", dtype=np.uint8))
    out = np.asarray(encode_ops.ascii_to_bases(raw))
    assert out.tolist() == [0, 1, 2, 3] + [encode_ops.INVALID] * 5


def test_unpack_2bit_roundtrip(make_dna):
    s = make_dna(253, invalid_frac=0.07)
    bases = codec.encode_bases(s)
    packed, mask, L = codec.pack_bases(bases)
    data = np.asarray(encode_ops.unpack_2bit(jnp.asarray(packed)))[:L]
    valid = np.asarray(encode_ops.unpack_mask(jnp.asarray(mask)))[:L]
    restored = np.where(valid, data, codec.INVALID_BASE).astype(np.uint8)
    assert np.array_equal(restored, bases)


@pytest.mark.parametrize("k", [1, 3, 7, 11, 15])
def test_rolling_codes_match_host(make_dna, k):
    s = make_dna(500, invalid_frac=0.05)
    codes, valid = _codes(s, k)
    want_codes, want_valid = codec.kmer_codes(codec.encode_bases(s), k)
    assert np.array_equal(np.asarray(valid), want_valid)
    assert np.array_equal(np.asarray(codes)[want_valid], want_codes[want_valid])


def test_revcomp_codes_match_host():
    k = 9
    codes = jnp.asarray(np.arange(0, 4**k, 1013, dtype=np.int32))
    got = np.asarray(encode_ops.revcomp_codes(codes, k))
    want = codec.revcomp_code(np.asarray(codes), k)
    assert np.array_equal(got, want)


def test_canonicalize_matches_host():
    k = 6
    codes = jnp.asarray(np.arange(4**k, dtype=np.int32))
    got = np.asarray(encode_ops.canonicalize(codes, k))
    want = codec.canonical_code(np.asarray(codes), k)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("impl", ["sorted", "scatter", "auto"])
def test_histogram_matches_oracle(make_dna, impl):
    s = make_dna(3000, invalid_frac=0.02)
    k = 4
    bins = 4**k
    codes, valid = _codes(s, k)
    fn = {
        "sorted": hist_ops.histogram_sorted,
        "scatter": hist_ops.histogram_scatter,
        "auto": hist_ops.histogram,
    }[impl]
    got = np.asarray(fn(codes, valid, bins), dtype=np.int64)
    want = oracle.count_vector(s, k)
    assert np.array_equal(got, want)


def test_histogram_large_bins_scatter(make_dna):
    s = make_dna(5000)
    k = 8  # 65536 bins -> scatter path via auto-select
    codes, valid = _codes(s, k)
    got = np.asarray(hist_ops.histogram(codes, valid, 4**k), dtype=np.int64)
    assert np.array_equal(got, oracle.count_vector(s, k))


@pytest.mark.parametrize("pad", [0, 5])
def test_counts_matrix_matches_oracle(make_dna, pad):
    # Row grids padded past the longest sequence with INVALID bases.
    k = 3
    bins = 64
    seqs = [make_dna(80 + 7 * i, invalid_frac=0.03) for i in range(9)]
    L = max(len(s) for s in seqs)
    grid = np.full((len(seqs), L + pad), codec.INVALID_BASE, dtype=np.uint8)
    for i, s in enumerate(seqs):
        grid[i, : len(s)] = codec.encode_bases(s)
    codes, valid = encode_ops.rolling_codes(jnp.asarray(grid), k)
    got = np.asarray(hist_ops.counts_matrix(codes, valid, bins), dtype=np.int64)
    want = oracle.counts_matrix(seqs, k)
    assert np.array_equal(got, want)


def test_distance_square_matches_oracle(make_dna):
    k = 3
    seqs = [make_dna(60 + 11 * i) for i in range(13)]
    counts = jnp.asarray(oracle.counts_matrix(seqs, k).astype(np.int32))
    lengths = jnp.asarray([len(s) for s in seqs], dtype=jnp.int32)
    sq = np.asarray(
        dist_ops.distance_matrix_square(counts, lengths, k, row_block=8)
    )
    from dna_kmeres_parallel.utils.triangular import packed_to_square

    want = packed_to_square(oracle.distance_matrix_packed(seqs, k), len(seqs))
    rows, cols = np.triu_indices(len(seqs), k=1)
    # All-device formula: XLA f32 division may differ from IEEE by 1 ulp.
    np.testing.assert_allclose(sq[rows, cols], want[rows, cols], rtol=3e-7)

    # The bit-exact path: integer min-sums + host float finish.
    sums = np.asarray(dist_ops.min_sum_matrix(counts, row_block=8))
    exact = dist_ops.finish_distances(sums, np.asarray(lengths), k)
    assert np.array_equal(exact[rows, cols], want[rows, cols])


def test_distance_packed_matches_oracle(make_dna):
    k = 3
    seqs = [make_dna(100 + 3 * i, invalid_frac=0.02) for i in range(10)]
    counts = jnp.asarray(oracle.counts_matrix(seqs, k).astype(np.int32))
    lengths = jnp.asarray([len(s) for s in seqs], dtype=jnp.int32)
    got = np.asarray(dist_ops.distance_matrix_packed(counts, lengths, k))
    want = oracle.distance_matrix_packed(seqs, k)
    assert got.dtype == np.float32
    assert np.array_equal(got, want)


def test_histogram_sorted_matches_oracle(make_dna):
    s = make_dna(5000, invalid_frac=0.02)
    for k in (4, 8, 11):
        codes, valid = _codes(s, k)
        got = np.asarray(
            hist_ops.histogram_sorted(codes, valid, 4**k), dtype=np.int64
        )
        assert np.array_equal(got, oracle.count_vector(s, k))


@pytest.mark.parametrize("cmax", [1, 3, 17, 64])
def test_min_sum_matrix_mxu_exact(cmax):
    # The int8 threshold identity sum_p min(a,b) = sum_t [a>=t][b>=t]
    # must be bit-exact against the (min,+) reduction for any counts
    # bounded by cmax, including zero rows and asymmetric panels.
    rng = np.random.default_rng(3)
    counts = rng.integers(0, cmax + 1, (13, 257)).astype(np.int32)
    counts[3] = 0
    other = rng.integers(0, cmax + 1, (21, 257)).astype(np.int32)
    want = np.asarray(
        dist_ops.min_sum_matrix(
            jnp.asarray(counts), counts_other=jnp.asarray(other)
        )
    )
    got = np.asarray(
        dist_ops.min_sum_matrix_int8(
            jnp.asarray(counts), cmax, jnp.asarray(other)
        )
    )
    assert np.array_equal(got, want)
    sym = np.asarray(dist_ops.min_sum_matrix_int8(jnp.asarray(counts), cmax))
    assert np.array_equal(
        sym, np.asarray(dist_ops.min_sum_matrix(jnp.asarray(counts)))
    )
