"""Dense histograms and per-sequence count matrices (XLA).

Replaces the reference's brute-force count kernel — one full sequence rescan
per k-mer, O(L * 4^k) compares (/root/reference/kernels.h:113-144) — with a
single rolling-code pass per base feeding either:

- a sort + bin-edge search (small bins, where scatter-add atomics
  contend on few addresses), or
- a scatter-add (XLA scatter, native atomics on the GPU),

selected by ``bins`` (crossover measured on the H100, PERF.md).

All counts are exact integers (int32 accumulators, like the reference's
``int`` counters), so results are bit-identical regardless of tiling or
device count — integer adds are associative (SURVEY.md §4 determinism).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

#: largest bin count the stream histogram sorts instead of scattering:
#: scatter-add atomics contend on few bins (k <= 5), while the sort costs
#: the same at any bin count (NVIDIA H100 80GB HBM3, 700 W, 16M bases:
#: sorted 1.04/0.92 ms vs scatter 4.70/1.79 ms at k=4/5; scatter wins from
#: k=6 on, 0.86 vs 1.01 ms — PERF.md)
SORTED_BINS_LIMIT = 1024


def histogram_scatter(codes: jax.Array, valid: jax.Array, bins: int) -> jax.Array:
    """Dense histogram via scatter-add. [T] -> [bins] int32.

    Invalid codes are routed to an overflow bucket at index ``bins`` and
    dropped, so no branch is needed in the hot path.
    """
    safe = jnp.where(valid, codes, bins)
    hist = jnp.zeros((bins + 1,), dtype=jnp.int32)
    hist = hist.at[safe].add(1)
    return hist[:bins]


def histogram_sorted(codes: jax.Array, valid: jax.Array, bins: int) -> jax.Array:
    """Dense histogram via sort + vectorized bin-edge search. [T] -> [bins].

    hist[b] = #codes in [b, b+1) = searchsorted(sorted, b+1) - (..., b):
    one device sort plus a batched binary search — no scatter at all, so
    no atomics contend when there are few bins.
    """
    safe = jnp.where(valid, codes, bins)  # invalids beyond the last edge
    sorted_codes = jax.lax.sort(safe)
    edges = jnp.arange(bins + 1, dtype=codes.dtype)
    pos = jnp.searchsorted(sorted_codes, edges)
    return jnp.diff(pos).astype(jnp.int32)


def impl_name(bins: int) -> str:
    """The stream histogram's implementation at this bin count."""
    return "sorted" if bins <= SORTED_BINS_LIMIT else "scatter"


def histogram(codes: jax.Array, valid: jax.Array, bins: int) -> jax.Array:
    """Dense histogram, selecting the implementation by ``bins``."""
    if impl_name(bins) == "sorted":
        return histogram_sorted(codes, valid, bins)
    return histogram_scatter(codes, valid, bins)


def counts_matrix(codes: jax.Array, valid: jax.Array, bins: int) -> jax.Array:
    """Per-sequence count matrix via one scatter-add with 2D (row, col)
    indices. codes: int32 [S, W] window codes; valid: bool [S, W] ->
    int32 [S, bins] (sequence-major: the natural layout for the distance
    engine — the reference's step-1 matrix, kernels.h:142, transposed).

    row * bins + code would overflow int32 once S * bins reaches 2^31
    (512 rows at 4^11 bins), and int64 indices would need global x64
    mode, so each index stays < 2^31; the per-row overflow bucket is
    column ``bins``. The [S, bins] buffer still has to fit device memory
    — the distance CLI's dense_distance_feasible gate bounds that."""
    S, W = codes.shape
    rows = jnp.broadcast_to(
        jnp.arange(S, dtype=jnp.int32)[:, None], codes.shape
    )
    col = jnp.where(valid, codes, bins)  # per-row overflow bucket
    out = jnp.zeros((S, bins + 1), dtype=jnp.int32)
    out = out.at[rows.reshape(-1), col.reshape(-1)].add(1)
    return out[:, :bins]
