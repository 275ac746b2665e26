"""The Pallas-Triton (min,+) kernel in interpret mode (exact equality vs
XLA's plain (min,+) and the oracle distances).

Interpret mode runs the same kernel body on the CPU, including its tile
padding, the triangle grid and the bins loop; the compiled kernel runs
on the GPU through the engine and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from dna_kmeres_parallel.models import oracle
from dna_kmeres_parallel.ops import distance as dist_ops
from dna_kmeres_parallel.ops import distance_pallas
from dna_kmeres_parallel.utils import codec


def test_min_sum_pallas_matches_jnp(make_dna):
    k = 3
    seqs = [make_dna(70 + 9 * i) for i in range(37)]  # S=37: pad path
    counts = oracle.counts_matrix(seqs, k).astype(np.int32)
    got = np.asarray(
        distance_pallas.min_sum_matrix_pallas(jnp.asarray(counts), interpret=True)
    )
    want = np.asarray(dist_ops.min_sum_matrix(jnp.asarray(counts), row_block=8))
    assert np.array_equal(got, want)


def test_min_sum_pallas_distances_exact(make_dna):
    # Full path: kernel min-sums + host finish == oracle distances, bitwise.
    k = 3
    seqs = [make_dna(100 + 5 * i, invalid_frac=0.02) for i in range(9)]
    counts = oracle.counts_matrix(seqs, k).astype(np.int32)
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    sums = np.asarray(
        distance_pallas.min_sum_matrix_pallas(jnp.asarray(counts), interpret=True)
    )
    sq = dist_ops.finish_distances(sums, lengths, k)
    rows, cols = np.triu_indices(len(seqs), k=1)
    want = oracle.distance_matrix_packed(seqs, k)
    assert np.array_equal(sq[rows, cols], want)


def test_min_sum_tri_matches_full_on_triangle():
    """Triangle grid (counts_other=None) == the rectangular grid over the
    same matrix: the mirror restores every strictly-lower tile."""
    rng = np.random.default_rng(4)
    S, B = 300, 64  # non-multiple of the tiles on purpose
    counts = jnp.asarray(rng.integers(0, 500, (S, B), dtype=np.int32))
    full = np.asarray(
        distance_pallas.min_sum_matrix_pallas(counts, counts, interpret=True)
    )
    tri = np.asarray(distance_pallas.min_sum_matrix_pallas(counts, interpret=True))
    assert np.array_equal(tri, full)


@pytest.mark.parametrize("B", [640, 1024, 4096])
def test_min_sum_pallas_bins_tiled(B):
    """Wide bins run as the in-program loop over BK-bin chunks — exact."""
    rng = np.random.default_rng(7)
    S = 40
    counts = jnp.asarray(rng.integers(0, 300, (S, B), dtype=np.int32))
    got = np.asarray(
        distance_pallas.min_sum_matrix_pallas(counts, interpret=True)
    )
    want = np.asarray(dist_ops.min_sum_matrix(counts, row_block=8))
    assert np.array_equal(got, want)


def test_min_sum_tri_bins_tiled():
    rng = np.random.default_rng(8)
    S, B = 300, 1024
    counts = jnp.asarray(rng.integers(0, 500, (S, B), dtype=np.int32))
    full = np.asarray(
        distance_pallas.min_sum_matrix_pallas(counts, counts, interpret=True)
    )
    tri = np.asarray(
        distance_pallas.min_sum_matrix_pallas(counts, interpret=True)
    )
    assert np.array_equal(tri, full)


def test_min_sum_pallas_k8_distances_exact(make_dna):
    # A wide dense band through the kernel; the distances must stay
    # bit-exact vs the oracle. Keep S tiny: interpret mode walks every bin.
    k = 6
    seqs = [make_dna(200 + 7 * i, invalid_frac=0.02) for i in range(6)]
    counts = oracle.counts_matrix(seqs, k).astype(np.int32)
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    sums = np.asarray(
        distance_pallas.min_sum_matrix_pallas(
            jnp.asarray(counts), interpret=True
        )
    )
    sq = dist_ops.finish_distances(sums, lengths, k)
    rows, cols = np.triu_indices(len(seqs), k=1)
    want = oracle.distance_matrix_packed(seqs, k)
    assert np.array_equal(sq[rows, cols], want)


@pytest.mark.parametrize("B", [1, 5, 13, 70])
def test_min_sum_pallas_bins_not_multiple_of_bk(B):
    """Bin counts that are not a multiple of BK pad with zero bins, which
    add min(., 0) = 0 — exact."""
    assert B % distance_pallas.BK
    rng = np.random.default_rng(B)
    counts = jnp.asarray(rng.integers(0, 50, (19, B), dtype=np.int32))
    other = jnp.asarray(rng.integers(0, 50, (23, B), dtype=np.int32))
    got = np.asarray(
        distance_pallas.min_sum_matrix_pallas(counts, other, interpret=True)
    )
    want = np.asarray(
        dist_ops.min_sum_matrix(counts, row_block=8, counts_other=other)
    )
    assert np.array_equal(got, want)


@pytest.mark.parametrize(
    "S,bm,bn", [(300, 64, 128), (300, 128, 32), (257, 32, 64), (5, 64, 128)]
)
def test_min_sum_pallas_triangle_grid_uneven_tiles(S, bm, bn):
    """The triangle grid picks its tiles from program_id: with BM != BN a
    tile is computed iff its last column reaches its first row. A wrong
    rule would leave zeros that the mirror cannot repair."""
    rng = np.random.default_rng(S + bm)
    counts = jnp.asarray(rng.integers(0, 60, (S, 11), dtype=np.int32))
    got = np.asarray(
        distance_pallas.min_sum_matrix_pallas(
            counts, interpret=True, bm=bm, bn=bn
        )
    )
    want = np.asarray(dist_ops.min_sum_matrix(counts, row_block=8))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("S,S2", [(1, 1), (63, 129), (130, 7)])
def test_min_sum_pallas_panel_tile_padding(S, S2):
    """Row panels against partner matrices whose sizes pad to neither tile
    edge: padded rows and columns are sliced off exactly."""
    rng = np.random.default_rng(S * 1000 + S2)
    panel = jnp.asarray(rng.integers(0, 9, (S, 64), dtype=np.int32))
    other = jnp.asarray(rng.integers(0, 9, (S2, 64), dtype=np.int32))
    got = np.asarray(
        distance_pallas.min_sum_matrix_pallas(panel, other, interpret=True)
    )
    assert got.shape == (S, S2)
    want = np.asarray(
        dist_ops.min_sum_matrix(panel, row_block=1, counts_other=other)
    )
    assert np.array_equal(got, want)


def test_min_sum_pallas_widens_int8():
    # The union route ships int8 counts; the kernel widens on device.
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 100, (40, 96), dtype=np.int32)
    got = np.asarray(
        distance_pallas.min_sum_matrix_pallas(
            jnp.asarray(counts.astype(np.int8)), interpret=True
        )
    )
    want = np.asarray(dist_ops.min_sum_matrix(jnp.asarray(counts), row_block=8))
    assert got.dtype == np.int32
    assert np.array_equal(got, want)


@pytest.mark.gpu
def test_min_sum_pallas_compiled_matches_xla(gpu):
    """The kernel as Triton compiles it for the card, at the k=3 width."""
    rng = np.random.default_rng(5)
    counts = jnp.asarray(rng.integers(0, 200, (1000, 64), dtype=np.int32))
    got = np.asarray(distance_pallas.min_sum_matrix_pallas(counts))
    want = np.asarray(dist_ops.min_sum_matrix(counts))
    assert np.array_equal(got, want)


def test_kernel_tiles_are_powers_of_two():
    # Triton block shapes must be powers of two.
    for t in (distance_pallas.BM, distance_pallas.BN, distance_pallas.BK):
        assert t & (t - 1) == 0
    assert codec.num_bins(3) % distance_pallas.BK == 0
