"""The XLA count programs that serve the dense band (exact equality vs
the oracle): the stream histogram (sort route for small bins, scatter-add
above ops.histogram.SORTED_BINS_LIMIT), the per-sequence counts
matrix, the 2-bit packed wire format, halo ownership masks, and the row
sorts of the sparse path — with the parametrizations (k, canonical,
n_own masks, odd lengths) the device programs are held to.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from dna_kmeres_parallel.models import oracle
from dna_kmeres_parallel.models.engine import (
    _count_batch,
    _count_batch_packed,
    _counts_matrix_batch,
)
from dna_kmeres_parallel.ops import encode as encode_ops
from dna_kmeres_parallel.ops import histogram as hist_ops
from dna_kmeres_parallel.utils import codec


def _grid(seqs):
    L = max(len(s) for s in seqs)
    grid = np.full((len(seqs), L), codec.INVALID_BASE, dtype=np.uint8)
    for i, s in enumerate(seqs):
        grid[i, : len(s)] = codec.encode_bases(s)
    return jnp.asarray(grid)


def _count(s, k, n_own, canonical=False):
    bases = jnp.asarray(codec.encode_bases(s))
    return np.asarray(
        _count_batch(bases, jnp.int32(n_own), k, codec.num_bins(k), canonical),
        dtype=np.int64,
    )


def _packed(s):
    bases = codec.encode_bases(s)
    pad = (-bases.shape[0]) % 16
    bases_p = np.concatenate(
        [bases, np.full(pad, encode_ops.INVALID, dtype=np.uint8)]
    )
    return bases_p


@pytest.mark.parametrize("k,bins", [(3, 64), (4, 256), (5, 1024)])
def test_counts_matrix_xla(make_dna, k, bins):
    seqs = [make_dna(150 + 31 * i, invalid_frac=0.03) for i in range(11)]
    got = np.asarray(
        _counts_matrix_batch(_grid(seqs), k, bins, False), dtype=np.int64
    )
    assert np.array_equal(got, oracle.counts_matrix(seqs, k))


def test_counts_matrix_xla_canonical(make_dna):
    k = 4
    seqs = [make_dna(200) for _ in range(5)]
    got = np.asarray(
        _counts_matrix_batch(_grid(seqs), k, 256, True), dtype=np.int64
    )
    assert np.array_equal(got, oracle.counts_matrix(seqs, k, canonical=True))


@pytest.mark.parametrize("k", [3, 6, 8, 11])
def test_count_batch_matches_oracle(make_dna, k):
    # Both bands: sort route (k = 3) and scatter route (k = 6, 8, 11).
    s = make_dna(20000, invalid_frac=0.02)
    got = _count(s, k, len(s) - k + 1)
    assert np.array_equal(got, oracle.count_vector(s, k))


def test_count_batch_ownership_mask(make_dna):
    # Windows starting at positions >= n_own must not count (halo rule).
    k = 5
    s = make_dna(1000)
    n_own = 400
    got = _count(s, k, n_own)
    assert np.array_equal(got, oracle.count_vector(s[: n_own + k - 1], k))


def test_count_batch_canonical(make_dna):
    k = 6
    s = make_dna(5000)
    got = _count(s, k, len(s) - k + 1, canonical=True)
    assert np.array_equal(got, oracle.count_vector(s, k, canonical=True))


@pytest.mark.parametrize("R,m", [(8, 128), (16, 512), (8, 2048)])
def test_row_sort_matches_np(R, m):
    # The sparse path's row sorts (ops/sparse._sort_words_as_rows): each
    # row ascends, uint32 order including the high-bit extremes.
    from dna_kmeres_parallel.ops import sparse as sparse_ops

    rng = np.random.default_rng(11)
    x = rng.integers(0, 1 << 32, (R, m), dtype=np.uint64).astype(np.uint32)
    x[0, :4] = [0, 0xFFFFFFFF, 0x7FFFFFFF, 0x80000000]
    (got,) = sparse_ops._sort_words_as_rows((jnp.asarray(x.reshape(-1)),), m)
    assert np.array_equal(np.asarray(got), np.sort(x, axis=1))


def test_sort_words_rows_table_matches_flat(make_dna):
    # Row-sorted and flat-sorted words compact to the same table.
    from dna_kmeres_parallel.models.sparse_engine import compact_table
    from dna_kmeres_parallel.ops import sparse as sparse_ops

    s = make_dna(600, invalid_frac=0.02)
    bases = jnp.asarray(codec.encode_bases(s))
    n_own = jnp.int32(len(s) - 13 + 1)
    rows = compact_table(
        sparse_ops.sort_words_rows(bases, n_own, 13, False, row_len=128)
    )
    flat = compact_table(sparse_ops.sort_words(bases, n_own, 13, False))
    assert np.array_equal(rows[0], flat[0])
    assert np.array_equal(rows[1], flat[1])


@pytest.mark.parametrize("k,canonical", [(3, False), (4, False), (4, True), (7, False)])
def test_count_batch_packed_matches_oracle(make_dna, k, canonical):
    s = make_dna(1500, invalid_frac=0.03)
    data, mask, _ = codec.pack_bases(_packed(s))
    got = np.asarray(
        _count_batch_packed(
            jnp.asarray(data), jnp.asarray(mask), jnp.int32(len(s) - k + 1),
            k, codec.num_bins(k), canonical,
        ),
        dtype=np.int64,
    )
    assert np.array_equal(got, oracle.count_vector(s, k, canonical=canonical))


@pytest.mark.parametrize("impl", ["sorted", "scatter"])
@pytest.mark.parametrize(
    "k,canonical",
    [(3, False), (6, False), (6, True), (7, False), (8, False), (8, True)],
)
def test_histogram_impls_match_oracle(make_dna, k, canonical, impl):
    """Both XLA histogram routes agree with the oracle in every band, so
    the crossover (SORTED_BINS_LIMIT) is a speed choice only."""
    s = make_dna(1500, invalid_frac=0.03)
    codes, valid = encode_ops.rolling_codes(
        jnp.asarray(codec.encode_bases(s)), k
    )
    if canonical:
        codes = encode_ops.canonicalize(codes, k)
    fn = {
        "sorted": hist_ops.histogram_sorted,
        "scatter": hist_ops.histogram_scatter,
    }[impl]
    got = np.asarray(fn(codes, valid, codec.num_bins(k)), dtype=np.int64)
    assert np.array_equal(got, oracle.count_vector(s, k, canonical=canonical))


def test_count_batch_n_own_edges(make_dna):
    k = 6
    s = make_dna(900)
    for n_own in (0, 1, 300):
        got = _count(s, k, n_own)
        assert got.sum() == n_own
        want = oracle.count_vector(s[: n_own + k - 1] if n_own else "", k)
        assert np.array_equal(got, want)


def test_count_batch_packed_n_own_mask(make_dna):
    # Windows starting at positions >= n_own must not count (the streaming
    # batch-overlap rule), through the packed wire format.
    k = 4
    s = make_dna(800)
    data, mask, _ = codec.pack_bases(_packed(s))
    n_own = 300
    got = np.asarray(
        _count_batch_packed(
            jnp.asarray(data), jnp.asarray(mask), jnp.int32(n_own), k, 256,
            False,
        ),
        dtype=np.int64,
    )
    assert got.sum() == n_own
    assert np.array_equal(got, oracle.count_vector(s[: n_own + k - 1], k))


@pytest.mark.parametrize("packer", ["numpy", "native"])
@pytest.mark.parametrize(
    "k,canonical",
    [(3, False), (4, False), (4, True), (7, False), (8, False), (8, True)],
)
def test_packed_wire_format_matches_oracle(make_dna, k, canonical, packer):
    """The 2-bit packed wire format from either packer (numpy codec or the
    native kp_pack_2bit) feeds the count program bin-for-bin exactly,
    invalid bases included."""
    from dna_kmeres_parallel import native

    s = make_dna(1500, invalid_frac=0.03)
    bases = _packed(s)
    if packer == "native":
        if not native.available():
            pytest.skip("native library unavailable")
        data, mask, _ = native.pack_2bit_native(bases)
    else:
        data, mask, _ = codec.pack_bases(bases)
    got = np.asarray(
        _count_batch_packed(
            jnp.asarray(data), jnp.asarray(mask), jnp.int32(len(s) - k + 1),
            k, codec.num_bins(k), canonical,
        ),
        dtype=np.int64,
    )
    assert np.array_equal(got, oracle.count_vector(s, k, canonical=canonical))


def test_packed_wire_format_n_own_mask(make_dna):
    k = 6
    s = make_dna(900)
    data, mask, _ = codec.pack_bases(_packed(s))
    for n_own in (0, 1, 300):
        got = np.asarray(
            _count_batch_packed(
                jnp.asarray(data), jnp.asarray(mask), jnp.int32(n_own), k,
                4096, False,
            ),
            dtype=np.int64,
        )
        assert got.sum() == n_own
        want = oracle.count_vector(s[: n_own + k - 1] if n_own else "", k)
        assert np.array_equal(got, want)
