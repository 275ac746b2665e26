"""Bucket-sharded sparse counting: each device owns a code range (k >= 16).

The expert-parallel analogue of SURVEY.md §2.5: when 4^k dwarfs any
device's memory (k=21, k=31), k-mer codes are ROUTED to the device that
owns their lexicographic range (the "expert") with a fixed-capacity
``all_to_all``, and each device builds the sorted sub-table for its own
range:

  per device: rolling split codes -> owner = top log2(D) bits
           -> sort by owner -> fixed-capacity [D, cap] send buffer
           -> jax.lax.all_to_all                  (NCCL over NVLink)
           -> local two-key sort + scatter-free RLE        (ops/sparse.py)
           -> per-device sorted sub-table (masked, static shape)

Because owners are the code's top bits, concatenating per-device tables in
device order yields the globally sorted table. Fixed capacity is checked:
an overflow flag (any owner bucket exceeding cap) is returned and must be
asserted false by the host — capacity 2x the uniform share is generous for
genomic data.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from dna_kmeres_parallel.ops import sparse as sparse_ops
from dna_kmeres_parallel.parallel.mesh import DATA_AXIS

_SENTINEL = jnp.uint32(0xFFFFFFFF)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _owner_bits(k: int, n_dev: int) -> tuple[int, int, bool]:
    """(shift, t_bits, use_hi): owner = ((word >> shift) * D) >> t_bits — a
    balanced multiply-shift range partition. Taking t_bits = d_bits + 4
    top bits keeps every owner's share within ~6% of uniform for ANY
    device count, including non-powers of two (a plain bit-shift owner
    would route up to (2^d_bits - D + 1)x the uniform share to the last
    owner after clamping, deterministically overflowing its send bucket).
    """
    d_bits = max(n_dev - 1, 1).bit_length() if n_dev > 1 else 0
    nlo = sparse_ops._lo_bases(k)
    hi_bits = 2 * (k - nlo)
    if hi_bits >= d_bits:
        t = min(hi_bits, d_bits + 4)
        return hi_bits - t, t, True
    lo_bits = 2 * nlo
    t = min(lo_bits, d_bits + 4)
    return lo_bits - t, t, False


def window_minimizers(bases: jax.Array, k: int, m: int) -> jax.Array:
    """Minimizer m-mer code of every k-window. [T] uint8 -> [T-k+1] int32.

    minimizer(i) = min of the k-m+1 m-mer codes inside window [i, i+k) —
    adjacent windows usually share their minimizer, so minimizer-routed
    k-mers land on the same owner in runs (the KMC-style partitioning named
    by the k=31 target config). Windows touching invalid bases get INT32_MAX
    (callers mask them via their own validity anyway).
    """
    return window_minimizers_pos(bases, k, m)[0]


def window_minimizers_pos(
    bases: jax.Array, k: int, m: int
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """(minimizer code, minimizer POSITION, window validity) per k-window.

    Position is the absolute base index of the leftmost minimal m-mer in
    the window (garbage for invalid windows). Ties break leftmost, so as
    the window slides the position is non-decreasing and the windows
    sharing one position form a contiguous run of at most k-m+1 windows —
    the SUPER-K-MER runs the compressed exchange ships as one record each.
    Validity is the AND of all k-m+1 m-mer validities (their union covers
    all k bases) — NOT derivable from the minimizer value: invalid m-mers
    carry the +inf sentinel, which the min hides whenever any other m-mer
    in the window is valid.
    """
    from dna_kmeres_parallel.ops import encode as encode_ops

    big = jnp.int32(2**31 - 1)
    mcodes, mvalid = encode_ops.rolling_codes(bases, m)
    mcodes = jnp.where(mvalid, mcodes, big)
    n = bases.shape[0] - k + 1
    mini = jnp.full((n,), big, jnp.int32)
    pos = jnp.zeros((n,), jnp.int32)
    vwin = jnp.ones((n,), bool)
    idx = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1)
    for j in range(k - m + 1):  # static unroll
        cand = jax.lax.slice_in_dim(mcodes, j, j + n, axis=0)
        take = cand < mini  # strict: earlier (leftmost) occurrence wins ties
        mini = jnp.where(take, cand, mini)
        pos = jnp.where(take, idx + j, pos)
        vwin = vwin & jax.lax.slice_in_dim(mvalid, j, j + n, axis=0)
    return mini, pos, vwin


def _capacity(n_windows: int, D: int, canonical: bool) -> int:
    """Fixed all_to_all send capacity per owner. Canonical folding
    concentrates the code space in its lower half (~2x skew: double the
    slack); +64 fixed slack covers binomial tails on small shards."""
    cap_mult = 4 if canonical else 2
    return min(-(-cap_mult * n_windows // D) + 64, n_windows)


def _hash_owner(mini, D: int):
    """Fibonacci hash of a minimizer value, range-partitioned by
    multiply-shift (balanced for any D)."""
    h32 = mini.astype(jnp.uint32) * jnp.uint32(0x9E3779B1)
    return (((h32 >> 16) * jnp.uint32(D)) >> 16).astype(jnp.int32)


def _route_owner(b, hi, lo, valid, k, D, owner_mode, minimizer_m,
                 shift, t_bits, use_hi):
    """Owner id per window (D for invalid) — shared by the aggregated and
    raw exchanges so they route identically by construction."""
    if owner_mode == "minimizer":
        # KMC-style routing: positional minimizer scan over the base
        # stream (the encode keeps stream order).
        owner = _hash_owner(window_minimizers(b, k, minimizer_m), D)
    else:
        # hi is None in the single-word band; there use_hi only arises at
        # D=1 (where every owner is 0 regardless of the source word).
        owner_src = hi if (use_hi and hi is not None) else lo
        top = (owner_src >> shift).astype(jnp.uint32)
        owner = ((top * jnp.uint32(D)) >> t_bits).astype(jnp.int32)
    return jnp.where(valid, owner, jnp.int32(D))


def _encode_shard_words(b, n_own, k, canonical):
    """One shard's encode for the bucketed exchanges: the SAME program as
    the single-card path (ops/sparse._encode_words).

    Returns (hi, lo, valid): hi in its native width (None for k <= 15,
    uint16 for 16 <= k <= 23, else uint32), lo uint32, both holding
    all-ones sentinels at invalid/unowned windows; valid is the mask.
    Plane length is T-k+1."""
    words = sparse_ops._encode_words(b, n_own, k, canonical)
    if len(words) == 1:
        lo = words[0]
        # k <= 15: codes < 2^30, so the sentinel cannot collide with a code.
        return None, lo, lo != _SENTINEL
    hi, lo = words
    return hi, lo, hi != sparse_ops.word_sentinel(hi.dtype)


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "canonical", "mesh", "axis", "owner_mode", "minimizer_m",
    ),
)
def count_bucket_sharded(
    bases,
    n_own_per_shard: jax.Array,
    k: int,
    canonical: bool,
    mesh: jax.sharding.Mesh,
    axis: str = DATA_AXIS,
    owner_mode: str = "prefix",
    minimizer_m: int = 7,
):
    """Bucket-sharded sparse count of a sharded base stream.

    bases: [D, T + k - 1] uint8 — one stream shard per device, each carrying
      its own k-1 halo (host-prepared; see models/pipeline.py feeder).
    n_own_per_shard: [D] int32 — windows owned by each shard.
    owner_mode: 'prefix' routes by the code's top bits (per-device tables
      concatenate globally sorted); 'minimizer' routes by a multiplicative
      hash of the window's minimizer m-mer (KMC-style; smoother load under
      skew, tables merged by the host gather).

    Returns (hi, lo, counts, starts, overflow):
      hi/lo/counts/starts: [D, cap * D] masked RLE sub-tables, device d
        holding only codes routed to d;
      overflow: [] bool — True if any send bucket exceeded capacity
        (results invalid; re-run with a larger batch split).
    """
    D = mesh.shape[axis]
    n_windows = bases.shape[1] - k + 1
    # Capacity is in DISTINCT codes per owner (local RLE collapses duplicates
    # before routing, so skewed data like homopolymers can't overflow on
    # multiplicity).
    cap = _capacity(n_windows, D, canonical)
    shift, t_bits, use_hi = _owner_bits(k, D)

    def _rle(owner_s, hi_s, lo_s, cnt_s=None):
        """Sorted (owner, hi, lo) with per-element counts -> (starts, totals).
        totals[i] = sum of cnt over the run starting at i (garbage off-start).
        Scatter-free: reverse min-scan for run extents + prefix sums.
        cnt_s=None means one per element: totals are the run lengths, with
        no prefix sum (XLA's GPU compiler constant-folds a cumsum of
        constant ones as an O(n^2) reduce-window, which never finishes
        compiling at millions of windows)."""
        m = hi_s.shape[0]

        def shift1(x, fill):
            return jnp.concatenate([jnp.full((1,), fill, x.dtype), x[:-1]])

        is_valid = hi_s != _SENTINEL
        run_starts = (
            (owner_s != shift1(owner_s, D))
            | (hi_s != shift1(hi_s, _SENTINEL))
            | (lo_s != shift1(lo_s, _SENTINEL))
        ) & is_valid
        idx = jax.lax.broadcasted_iota(jnp.int32, (m, 1), 0).squeeze(-1)
        flagged = jnp.where(run_starts | ~is_valid, idx, m)
        # cummin, not associative_scan — see ops/sparse.py compile-time note.
        nxt = jax.lax.cummin(flagged, reverse=True)
        after = jnp.concatenate([nxt[1:], jnp.full((1,), m, jnp.int32)])
        if cnt_s is None:
            return run_starts, after - idx
        csum = jnp.cumsum(cnt_s)  # inclusive prefix sum
        csum_at_end = jnp.take(csum, jnp.clip(after - 1, 0, m - 1))
        totals = csum_at_end - (csum - cnt_s)
        return run_starts, totals

    def shard_fn(b, n_own):
        n_own = n_own.reshape(())
        b = b.reshape(-1)
        hi_n, lo, valid = _encode_shard_words(b, n_own, k, canonical)
        # This path's sorts and searchsorted edges work in u32 hi space;
        # widen the native-width plane (sentinel-preserving).
        if hi_n is None:
            hi = jnp.where(valid, jnp.uint32(0), _SENTINEL)
        elif hi_n.dtype == jnp.uint16:
            hi = jnp.where(valid, hi_n.astype(jnp.uint32), _SENTINEL)
        else:
            hi = hi_n
        n = hi.shape[0]

        # In prefix mode with owner = the TOP bits of hi, owner order is
        # monotone in the (hi, lo) sort key, so the owner word need not be
        # a sort operand at all (each extra 32-bit operand costs ~28% of
        # the sort, and this local sort dominates the path); segment bounds
        # come from searchsorted on hi against the owners' code edges.
        prefix_fast = owner_mode != "minimizer" and use_hi

        owner = _route_owner(b, hi, lo, valid, k, D, owner_mode,
                             minimizer_m, shift, t_bits, use_hi)

        # Local pre-aggregation: group by (owner, code) and collapse
        # duplicates, so only DISTINCT (code, count) pairs are exchanged.
        if prefix_fast:
            hi_s, lo_s = jax.lax.sort((hi, lo), num_keys=2)
            owner_s = jnp.zeros((n,), jnp.int32)  # subsumed by the hi compare
        else:
            owner_s, hi_s, lo_s = jax.lax.sort((owner, hi, lo), num_keys=3)
        starts_mask, totals = _rle(owner_s, hi_s, lo_s)
        # Non-starts become sentinels so they compress to nothing downstream.
        hi_u = jnp.where(starts_mask, hi_s, _SENTINEL)
        lo_u = jnp.where(starts_mask, lo_s, _SENTINEL)
        cnt_u = jnp.where(starts_mask, totals, 0)

        # Re-sort pulls the masked non-starts (sentinels) out of the way.
        targets = jax.lax.broadcasted_iota(jnp.int32, (D, 1), 0).squeeze(-1)
        if prefix_fast:
            hi_u, lo_u, cnt_u = jax.lax.sort((hi_u, lo_u, cnt_u), num_keys=2)
            # Owner d owns top values in [ceil(d*2^t/D), ceil((d+1)*2^t/D))
            # (the multiply-shift partition's inverse); the last owner's
            # end edge is the sentinel boundary (valid hi < 2^30 <
            # 0xFFFFFFFF, so searchsorted at the sentinel finds the first
            # invalid entry).
            edge_vals = [
                ((d << t_bits) + D - 1) // D << shift for d in range(D)
            ]
            edges = jnp.asarray(edge_vals, jnp.uint32)
            end_edges = jnp.concatenate(
                [edges[1:], jnp.full((1,), 0xFFFFFFFF, jnp.uint32)]
            )
            starts = jnp.searchsorted(hi_u, edges)
            ends = jnp.searchsorted(hi_u, end_edges)
        else:
            own_u = jnp.where(starts_mask, owner_s, jnp.int32(D))
            owner, hi_u, lo_u, cnt_u = jax.lax.sort(
                (own_u, hi_u, lo_u, cnt_u), num_keys=3
            )
            starts = jnp.searchsorted(owner, targets)
            ends = jnp.searchsorted(owner, targets, side="right")
        seg_len = ends - starts
        overflow = jnp.any(seg_len > cap)

        # Fixed-capacity send buffers: [D, cap] per plane. Pad by cap
        # sentinels so slices never clamp/misalign.
        pad_u = jnp.full((cap,), _SENTINEL, jnp.uint32)
        pad_i = jnp.zeros((cap,), jnp.int32)
        hi_p = jnp.concatenate([hi_u, pad_u])
        lo_p = jnp.concatenate([lo_u, pad_u])
        cnt_p = jnp.concatenate([cnt_u, pad_i])

        def take(start):
            return (
                jax.lax.dynamic_slice(hi_p, (start,), (cap,)),
                jax.lax.dynamic_slice(lo_p, (start,), (cap,)),
                jax.lax.dynamic_slice(cnt_p, (start,), (cap,)),
            )

        send_hi, send_lo, send_cnt = jax.vmap(take)(starts)
        col = jax.lax.broadcasted_iota(jnp.int32, (D, cap), 1)
        in_seg = col < jnp.minimum(seg_len, cap)[:, None]
        send_hi = jnp.where(in_seg, send_hi, _SENTINEL)
        send_lo = jnp.where(in_seg, send_lo, _SENTINEL)
        send_cnt = jnp.where(in_seg, send_cnt, 0)

        # Exchange: row d goes to device d; we receive one row per peer.
        recv_hi = jax.lax.all_to_all(send_hi, axis, 0, 0, tiled=True)
        recv_lo = jax.lax.all_to_all(send_lo, axis, 0, 0, tiled=True)
        recv_cnt = jax.lax.all_to_all(send_cnt, axis, 0, 0, tiled=True)

        # Merge the <= D pre-aggregated tables: sort and sum run counts.
        hi2, lo2, cnt2 = jax.lax.sort(
            (recv_hi.reshape(-1), recv_lo.reshape(-1), recv_cnt.reshape(-1)),
            num_keys=2,
        )
        zero_owner = jnp.zeros_like(cnt2)
        run_starts, counts = _rle(zero_owner, hi2, lo2, cnt2)

        ov = jax.lax.pmax(overflow.astype(jnp.int32), axis)
        return (
            hi2[None],
            lo2[None],
            counts[None],
            run_starts[None],
            ov[None],
        )

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis)),
        out_specs=(P(axis, None), P(axis, None), P(axis, None), P(axis, None), P(axis)),
        check_vma=False,
    )
    hi, lo, counts, starts, ov = fn(bases, n_own_per_shard)
    return hi, lo, counts, starts, jnp.any(ov > 0)


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "canonical", "mesh", "axis", "owner_mode", "minimizer_m",
    ),
)
def exchange_words_bucket_sharded(
    bases,
    n_own_per_shard: jax.Array,
    k: int,
    canonical: bool,
    mesh: jax.sharding.Mesh,
    axis: str = DATA_AXIS,
    owner_mode: str = "prefix",
    minimizer_m: int = 7,
):
    """RAW-exchange variant of count_bucket_sharded for the no-device-sort
    era: each chip sorts its windows by OWNER ONLY (one sort key + the
    word payloads — vs the aggregated path's two full multi-key sorts plus
    a receive-side merge sort), routes the RAW words over the fixed-cap
    all_to_all, and ships the received planes to its host UNSORTED; the
    host radix compactor (sparse_engine.compact_unsorted) builds each
    owner's sub-table in constant passes, exactly as in the single-chip
    no-sort path.

    Trade-off vs the 'agg' path: no local RLE pre-aggregation, so (a) the
    exchange moves one word-pair per WINDOW rather than per distinct code (equal on
    low-duplication data; worse under heavy duplication), and (b) the send
    capacity is in windows — skewed data (e.g. homopolymers, where every
    window shares one owner) overflows sooner. Overflow is detected and
    returned exactly as in the aggregated path; callers fall back to
    owner_mode='minimizer' or the aggregated exchange.

    Returns (words, overflow): words = per-k word-plane tuple, each
    [D, D * cap] with all-ones sentinels padding unused capacity; device d
    holds only codes owned by d.
    """
    D = mesh.shape[axis]
    n_windows = bases.shape[1] - k + 1
    cap = _capacity(n_windows, D, canonical)
    shift, t_bits, use_hi = _owner_bits(k, D)
    single = k <= sparse_ops.MAX_SINGLE_WORD_K
    narrow16 = (not single) and k <= sparse_ops.MAX_U16_HI_K

    def shard_fn(b, n_own):
        n_own = n_own.reshape(())
        # Native-width planes (hi u16 for 16 <= k <= 23 — already narrowed
        # by _encode_words, halving both the sort payload and the exchange).
        b = b.reshape(-1)
        hi, lo, valid = _encode_shard_words(b, n_own, k, canonical)
        owner = _route_owner(b, hi, lo, valid, k, D, owner_mode,
                             minimizer_m, shift, t_bits, use_hi)

        payloads = (lo,) if single else (hi, lo)
        sents = (_SENTINEL,) if single else (
            hi.dtype.type(0xFFFF if narrow16 else 0xFFFFFFFF), _SENTINEL
        )
        # The sort below is the main cost of this device program, so its
        # operand count matters most.
        #
        # PREFIX-FAST: in prefix mode the owner is a multiply-shift
        # of the routing word's top bits — MONOTONE in that word — so the
        # owner need not be a sort operand at all: sort by the routing
        # word itself and find segments by searchsorted at the owners'
        # code edges (the same trick the aggregated path uses). Valid
        # routing words sort strictly below their all-ones sentinel
        # (hi < 2^(2k-32) when use_hi; lo < 2^30 for k <= 15), so the
        # sentinel tail lands past every real segment. Minimizer mode and
        # the use_hi=False mid band (where a valid lo can equal the
        # sentinel) keep the owner-key sort.
        prefix_fast = owner_mode != "minimizer" and (use_hi or single)
        if prefix_fast:
            # The routing word is payloads[0] either way: hi when use_hi,
            # lo in the single-word band (owner = its top bits).
            sorted_ops = jax.lax.sort(payloads, num_keys=1)
            payl_s = sorted_ops
            route_s = sorted_ops[0]
            rdt = route_s.dtype
            edges = jnp.asarray(
                [((d << t_bits) + D - 1) // D << shift for d in range(D)],
                rdt,
            )
            end_edges = jnp.concatenate(
                [edges[1:],
                 jnp.full((1,), jnp.iinfo(rdt).max, rdt)]
            )
            starts = jnp.searchsorted(route_s, edges)
            ends = jnp.searchsorted(route_s, end_edges)
        else:
            # Owner-key sort: invalid windows route to pseudo-owner D past
            # every real segment.
            sorted_ops = jax.lax.sort((owner, *payloads), num_keys=1)
            owner_s, payl_s = sorted_ops[0], sorted_ops[1:]
            targets = jax.lax.broadcasted_iota(
                jnp.int32, (D, 1), 0
            ).squeeze(-1)
            starts = jnp.searchsorted(owner_s, targets)
            ends = jnp.searchsorted(owner_s, targets, side="right")
        seg_len = ends - starts
        col = jax.lax.broadcasted_iota(jnp.int32, (D, cap), 1)
        in_seg = col < jnp.minimum(seg_len, cap)[:, None]

        def take(buf, start):
            return jax.lax.dynamic_slice(buf, (start,), (cap,))

        send_bufs = []
        for p, sent in zip(payl_s, sents):
            p_pad = jnp.concatenate([p, jnp.full((cap,), sent, p.dtype)])
            sp = jax.vmap(take, in_axes=(None, 0))(p_pad, starts)
            send_bufs.append(jnp.where(in_seg, sp, sent))
        overflow = jnp.any(seg_len > cap)
        recvs = [
            jax.lax.all_to_all(sb, axis, 0, 0, tiled=True)
            for sb in send_bufs
        ]
        ov = jax.lax.pmax(overflow.astype(jnp.int32), axis)
        if single:
            recv_lo = recvs[0]
            return recv_lo.reshape(-1)[None], recv_lo.reshape(-1)[None], ov[None]
        return recvs[0].reshape(-1)[None], recvs[1].reshape(-1)[None], ov[None]

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis)),
        out_specs=(P(axis, None), P(axis, None), P(axis)),
        check_vma=False,
    )
    hi, lo, ov = fn(bases, n_own_per_shard)
    # Adaptive word tuple matching ops/sparse._encode_words so the host
    # compactor treats both paths identically (hi already narrowed to u16
    # before the exchange for 16 <= k <= 23).
    if k <= sparse_ops.MAX_SINGLE_WORD_K:
        words = (lo,)
    else:
        words = (hi, lo)
    return words, jnp.any(ov > 0)


def _stage_shards(shards, n_own, mesh, axis):
    """Host shards straight to one slice per device (jnp.asarray would
    commit the whole array to the first device, then reshard)."""
    return (
        jax.device_put(shards, NamedSharding(mesh, P(axis, None))),
        jax.device_put(n_own, NamedSharding(mesh, P(axis))),
    )


def count_bucket_sharded_raw(
    flat,
    k: int,
    canonical: bool,
    mesh: jax.sharding.Mesh,
    axis: str = DATA_AXIS,
    owner_mode: str = "prefix",
    minimizer_m: int = 7,
    total_own=None,
):
    """Host-driver convenience for the raw exchange: shard with halos,
    exchange unsorted words, radix-compact each device's plane on host,
    merge. Raises on send-capacity overflow (see
    exchange_words_bucket_sharded for the skew trade-off)."""
    from dna_kmeres_parallel.models.sparse_engine import (
        compact_unsorted,
        fetch_words,
        merge_sparse_tables,
    )

    shards, n_own = shard_stream_with_halo(flat, k, mesh, axis, total_own)
    words, overflow = exchange_words_bucket_sharded(
        *_stage_shards(shards, n_own, mesh, axis),
        k,
        canonical,
        mesh,
        axis,
        owner_mode,
        minimizer_m,
    )
    if bool(overflow):
        raise OverflowError(
            "bucketed raw exchange: an owner's window share exceeded the "
            "send capacity (skewed data) — use the aggregated exchange "
            "(count_bucket_sharded) or owner_mode='minimizer'"
        )
    words = fetch_words(words)
    D = words[-1].shape[0]
    tables = [
        compact_unsorted(tuple(w[d] for w in words), k) for d in range(D)
    ]
    return merge_sparse_tables(tables)


def count_bucket_auto(
    flat,
    k: int,
    canonical: bool,
    mesh: jax.sharding.Mesh,
    axis: str = DATA_AXIS,
    owner_mode: str = "prefix",
    minimizer_m: int = 7,
    total_own=None,
    exchange: str = "auto",
) -> tuple[np.ndarray, np.ndarray]:
    """Policy driver for the bucket-sharded count (the EP analogue,
    SURVEY.md §2.5): route through the cheapest exchange that fits.

    exchange='auto' (default) runs the DE-SORTED raw exchange — one
    owner-key device sort + host radix compaction, the same no-device-sort
    design that won 13x on the single-chip path — and falls back to the
    AGGREGATED exchange (two multi-key sorts but local RLE pre-aggregation,
    so send capacity is in DISTINCT codes: skew-proof on duplicated data
    like homopolymers) if any raw send bucket overflows. 'raw', 'agg' and
    'super' force one exchange (super = compressed minimizer-run records,
    the lowest exchange volume; raises on pathological run density).
    """
    if exchange not in ("auto", "raw", "agg", "super"):
        raise ValueError(f"unknown exchange {exchange!r}")
    if exchange == "super":
        return count_bucket_sharded_super(
            flat, k, canonical, mesh, axis, minimizer_m, total_own
        )
    if exchange in ("auto", "raw"):
        try:
            return count_bucket_sharded_raw(
                flat, k, canonical, mesh, axis, owner_mode, minimizer_m,
                total_own,
            )
        except OverflowError:
            if exchange == "raw":
                raise
    # Aggregated fallback (or exchange='agg'): RLE pre-aggregation bounds
    # any owner's share by its DISTINCT codes, which the skewed inputs that
    # overflow the raw path (few distinct codes, many copies) cannot exceed.
    shards, n_own = shard_stream_with_halo(flat, k, mesh, axis, total_own)
    hi, lo, counts, starts, overflow = count_bucket_sharded(
        *_stage_shards(shards, n_own, mesh, axis),
        k,
        canonical,
        mesh,
        axis,
        owner_mode,
        minimizer_m,
    )
    if bool(overflow):
        raise OverflowError(
            "bucketed aggregated exchange: an owner's distinct-code share "
            "exceeded the send capacity — split the stream into smaller "
            "batches (capacity scales with windows per shard)"
        )
    return gather_table(hi, lo, counts, starts)


def superkmer_geometry(k: int, m: int) -> tuple[int, int]:
    """(max record bases, u32 words per record) of the super-k-mer exchange.

    A super-k-mer run holds at most k-m+1 windows (one minimizer position
    supports exactly that many overlapping windows), i.e. 2k-m bases; bases
    pack 16 per u32 word (2 bits each, little-endian within the word).
    """
    if not 1 <= m < k:
        raise ValueError(f"minimizer m must satisfy 1 <= m < k, got m={m} k={k}")
    skmax = 2 * k - m
    return skmax, -(-skmax // 16)


def _superkmer_capacity(n_windows: int, D: int, k: int, m: int) -> int:
    """Records-per-owner send capacity: expected records = 2/(k-m+2) per
    window (the super-k-mer density of random sequence), x2 slack for
    routing variance, +64 for binomial tails on small shards."""
    exp_per_owner = -(-2 * n_windows // ((k - m + 2) * D))
    return min(2 * exp_per_owner + 64, max(n_windows, 1))


@functools.partial(
    jax.jit, static_argnames=("k", "mesh", "axis", "minimizer_m")
)
def exchange_superkmers_bucket_sharded(
    bases: jax.Array,
    n_own_per_shard: jax.Array,
    k: int,
    mesh: jax.sharding.Mesh,
    axis: str = DATA_AXIS,
    minimizer_m: int = 7,
):
    """SUPER-K-MER compressed exchange: ship minimizer runs, not windows.

    The raw exchange (exchange_words_bucket_sharded) moves one split word
    pair per WINDOW through the exchange — 6-8 B/window. But consecutive windows
    sharing a minimizer route to the same owner by construction, so this
    variant ships each such run ONCE as a fixed-size record: the run's
    2k-m-base extent packed 2-bit into W = ceil((2k-m)/16) u32 words plus
    an i32 run-length word. At the random-sequence run density 2/(k-m+2)
    that is (W+1)*8/(k-m+2) B/window — e.g. k=31/m=7: 1.5 B vs 8 B raw
    (5.4x); k=21/m=11: 1.9 B vs 6 B (3.2x). The receiving host expands
    records back to a sentinel-separated base stream and counts it with
    the fused rolling-encoder radix engine (native kp_count_sparse_host),
    so no per-window data ever crosses the interconnect or PCIe.

    The device program is also lighter than the raw exchange's: no k-wide
    rolling encode, no canonicalization (both happen on the receiving
    host), only the m-mer minimizer scan, the 2-bit packing ladder, and
    ONE owner-key sort over (W+2)-operand records.

    Owner = Fibonacci hash of the run's minimizer VALUE (equal k-mers have
    equal minimizers, so every copy of a code lands on one owner; the same
    'minimizer' owner mode the aggregated/raw paths offer). Runs break
    where the minimizer POSITION moves (leftmost-tie argmin), bounding
    records to k-m+1 windows.

    Returns (planes, meta, overflow): planes = W uint32 arrays [D, D*cap]
    of packed record bases, meta = int32 [D, D*cap] run lengths in windows
    (0 = unused capacity), overflow as in the other exchanges.
    """
    D = mesh.shape[axis]
    n_windows = bases.shape[1] - k + 1
    skmax, W = superkmer_geometry(k, minimizer_m)
    cap = _superkmer_capacity(n_windows, D, k, minimizer_m)

    def shard_fn(b, n_own):
        b = b.reshape(-1)
        n_own = n_own.reshape(())
        n = b.shape[0] - k + 1
        mini, pos, vwin = window_minimizers_pos(b, k, minimizer_m)
        idx = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1)
        valid = vwin & (idx < n_own)

        h32 = mini.astype(jnp.uint32) * jnp.uint32(0x9E3779B1)
        owner = (((h32 >> 16) * jnp.uint32(D)) >> 16).astype(jnp.int32)

        def shift1(x, fill):
            return jnp.concatenate([jnp.full((1,), fill, x.dtype), x[:-1]])

        # Run breaks: minimizer position moved, or validity flipped (the
        # first window always breaks). Positions of invalid windows are
        # garbage but every valid run is bounded by the validity terms.
        brk = (
            (pos != shift1(pos, jnp.int32(-1)))
            | (valid != shift1(valid, False))
        )
        run_start = brk & valid
        flagged = jnp.where(brk, idx, n)
        nxt = jax.lax.cummin(flagged, reverse=True)
        after = jnp.concatenate([nxt[1:], jnp.full((1,), n, jnp.int32)])
        run_len = after - idx  # windows in the run starting here

        # Pack the record extent (skmax bases from the run start; bases
        # past the true length are masked by meta on the host). Pad the
        # stream so the last window's record slice stays in bounds.
        from dna_kmeres_parallel.ops.encode import INVALID

        bp = jnp.concatenate(
            [b, jnp.full((k - minimizer_m,), INVALID, jnp.uint8)]
        )
        b2 = (bp & 3).astype(jnp.uint32)
        planes = []
        for w in range(W):
            acc = jnp.zeros((n,), jnp.uint32)
            for t in range(16):
                j = w * 16 + t
                if j >= skmax:
                    break
                acc = acc | (
                    jax.lax.slice_in_dim(b2, j, j + n, axis=0) << (2 * t)
                )
            planes.append(acc)

        meta = jnp.where(run_start, run_len, 0)
        owner_rec = jnp.where(run_start, owner, jnp.int32(D))
        sorted_ops = jax.lax.sort((owner_rec, meta, *planes), num_keys=1)
        owner_s, meta_s = sorted_ops[0], sorted_ops[1]
        planes_s = sorted_ops[2:]

        targets = jax.lax.broadcasted_iota(jnp.int32, (D, 1), 0).squeeze(-1)
        starts = jnp.searchsorted(owner_s, targets)
        ends = jnp.searchsorted(owner_s, targets, side="right")
        seg_len = ends - starts
        overflow = jnp.any(seg_len > cap)

        col = jax.lax.broadcasted_iota(jnp.int32, (D, cap), 1)
        in_seg = col < jnp.minimum(seg_len, cap)[:, None]

        def take(buf, start):
            return jax.lax.dynamic_slice(buf, (start,), (cap,))

        pad_i = jnp.zeros((cap,), jnp.int32)
        send_meta = jax.vmap(take, in_axes=(None, 0))(
            jnp.concatenate([meta_s, pad_i]), starts
        )
        send_meta = jnp.where(in_seg, send_meta, 0)
        recv_meta = jax.lax.all_to_all(send_meta, axis, 0, 0, tiled=True)
        recv_planes = []
        pad_u = jnp.zeros((cap,), jnp.uint32)
        for p in planes_s:
            send_p = jax.vmap(take, in_axes=(None, 0))(
                jnp.concatenate([p, pad_u]), starts
            )
            recv_planes.append(
                jax.lax.all_to_all(send_p, axis, 0, 0, tiled=True)
            )
        ov = jax.lax.pmax(overflow.astype(jnp.int32), axis)
        return (
            tuple(p.reshape(-1)[None] for p in recv_planes),
            recv_meta.reshape(-1)[None],
            ov[None],
        )

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis)),
        out_specs=(
            tuple(P(axis, None) for _ in range(W)),
            P(axis, None),
            P(axis),
        ),
        check_vma=False,
    )
    planes, meta, ov = fn(bases, n_own_per_shard)
    return planes, meta, jnp.any(ov > 0)


def expand_superkmers(
    planes, meta: np.ndarray, k: int, m: int
) -> np.ndarray:
    """Received super-k-mer records -> sentinel-separated u8 base stream.

    Each record with run length r > 0 contributes its r+k-1 bases followed
    by one INVALID separator, so a rolling window scan of the stream yields
    exactly r windows per record — the stream is directly the input format
    of the fused host engine (native.count_sparse_host_native) and of the
    NumPy fallback. Vectorized: one shift/mask per base column.
    """
    skmax, W = superkmer_geometry(k, m)
    meta = np.asarray(meta).reshape(-1)
    sel = meta > 0
    r = meta[sel].astype(np.int64)
    if r.size and int(r.max()) > k - m + 1:
        raise AssertionError(
            f"super-k-mer run length {int(r.max())} exceeds k-m+1={k-m+1}"
        )
    out = np.empty((r.size, skmax + 1), np.uint8)
    out[:, skmax] = 0xFF
    for j in range(skmax):
        w, t = divmod(j, 16)
        plane = np.asarray(planes[w]).reshape(-1)[sel]
        out[:, j] = ((plane >> np.uint32(2 * t)) & np.uint32(3)).astype(np.uint8)
    cols = np.arange(skmax + 1, dtype=np.int64)[None, :]
    out[cols >= (r + k - 1)[:, None]] = 0xFF
    return out.reshape(-1)


def _count_stream_host(
    stream: np.ndarray, k: int, canonical: bool
) -> tuple[np.ndarray, np.ndarray]:
    """Sorted-unique (codes_u64, counts_i64) of a sentinel-separated base
    stream: the fused native rolling-encoder radix engine when built, a
    NumPy rolling count otherwise."""
    from dna_kmeres_parallel import native

    if native.available():
        return native.count_sparse_host_native(stream, k, canonical)
    from dna_kmeres_parallel.utils import codec

    codes, valid = codec.kmer_codes(stream, k)
    codes = codes[valid]
    if canonical:
        codes = codec.canonical_code(codes, k)
    codes, counts = np.unique(np.asarray(codes, np.uint64), return_counts=True)
    return codes.astype(np.uint64), counts.astype(np.int64)


@functools.partial(jax.jit, static_argnames=("k", "minimizer_m"))
def superkmer_records_device(
    bases: jax.Array,
    n_own: jax.Array,
    k: int,
    minimizer_m: int = 7,
):
    """SINGLE-CHIP super-k-mer D2H compaction (r4): the compressed record
    format of the bucketed exchange, applied to the plain device->host
    stream (KmerConfig.compact='device-super').

    The words D2H modes ship 6-8 B per WINDOW; here consecutive windows
    sharing a minimizer position collapse to ONE fixed-size record (the
    run's 2k-m-base extent packed 2-bit into W u32 words + an i32 run
    length), compacted to the array FRONT by a single-key sort so the
    host fetches only the ceil(records) prefix — at random-sequence run
    density 2/(k-m+2) that is (W+1)*4*2/(k-m+2) B/window, e.g. k=21/m=11:
    1.9 B vs 6 (3.2x); k=31/m=7: 1.5 B vs 8 (5.4x). The receiving host
    expands records to a sentinel-separated base stream and counts with
    the fused rolling-encoder radix engine — the same consumer as the
    super-k-mer exchange (expand_superkmers/_count_stream_host), so
    canonicalization happens host-side and any k <= 31 is exact.

    The device program is LIGHTER than the words modes' (no k-wide
    rolling encode, no canonicalization — just the m-mer minimizer scan,
    the packing ladder, and one single-key sort), trading host re-encode
    work for a ~3-5x smaller transfer: the mode for D2H-bound streams.

    Returns (planes tuple [W] of u32 [n], meta i32 [n], n_records i32);
    records occupy the first n_records entries, the tail is zeros.
    """
    b = bases
    n = b.shape[0] - k + 1
    skmax, W = superkmer_geometry(k, minimizer_m)
    mini, pos, vwin = window_minimizers_pos(b, k, minimizer_m)
    del mini  # single chip: no owner to route to
    idx = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1)
    valid = vwin & (idx < n_own)

    def shift1(x, fill):
        return jnp.concatenate([jnp.full((1,), fill, x.dtype), x[:-1]])

    brk = (
        (pos != shift1(pos, jnp.int32(-1)))
        | (valid != shift1(valid, False))
    )
    run_start = brk & valid
    flagged = jnp.where(brk, idx, n)
    nxt = jax.lax.cummin(flagged, reverse=True)
    after = jnp.concatenate([nxt[1:], jnp.full((1,), n, jnp.int32)])
    run_len = after - idx

    from dna_kmeres_parallel.ops.encode import INVALID

    bp = jnp.concatenate(
        [b, jnp.full((k - minimizer_m,), INVALID, jnp.uint8)]
    )
    b2 = (bp & 3).astype(jnp.uint32)
    planes = []
    for w in range(W):
        acc = jnp.zeros((n,), jnp.uint32)
        for t in range(16):
            j = w * 16 + t
            if j >= skmax:
                break
            acc = acc | (
                jax.lax.slice_in_dim(b2, j, j + n, axis=0) << (2 * t)
            )
        planes.append(acc)
    meta = jnp.where(run_start, run_len, 0)
    # Distinct-first compaction: records sort to the front by stream
    # position (their natural order), zeros behind — the host fetches
    # only the prefix.
    key = jnp.where(run_start, idx, jnp.int32(n))
    parts = jax.lax.sort((key, meta, *planes), num_keys=1)
    meta_s = parts[1]
    planes_s = parts[2:]
    n_records = jnp.sum(run_start.astype(jnp.int32))
    return tuple(planes_s), meta_s, n_records


def table_from_superkmers(
    planes, meta, n_records, k: int, minimizer_m: int, canonical: bool
) -> tuple[np.ndarray, np.ndarray]:
    """superkmer_records_device output -> sorted-unique (codes, counts).

    Fetches ONLY the record prefix (power-of-two shape bucket, like
    table_from_rle), expands to the sentinel-separated stream, counts
    with the fused host engine."""
    m = int(np.asarray(n_records))
    if m == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    n = int(meta.shape[0])
    mp = min(max(1 << (m - 1).bit_length(), 128), n)
    meta_h = np.asarray(meta[:mp])[:m]
    planes_h = [np.asarray(p[:mp])[:m] for p in planes]
    stream = expand_superkmers(planes_h, meta_h, k, minimizer_m)
    return _count_stream_host(stream, k, canonical)


def count_bucket_sharded_super(
    flat,
    k: int,
    canonical: bool,
    mesh: jax.sharding.Mesh,
    axis: str = DATA_AXIS,
    minimizer_m: int = 7,
    total_own=None,
):
    """Host driver for the super-k-mer exchange: shard with halos, route
    minimizer runs over the compressed all_to_all, expand each device's
    received records on its host, count with the fused rolling engine,
    merge. Raises on send-capacity overflow (pathological run density —
    fall back to count_bucket_sharded)."""
    from dna_kmeres_parallel.models.sparse_engine import (
        merge_sparse_tables,
    )

    shards, n_own = shard_stream_with_halo(flat, k, mesh, axis, total_own)
    planes, meta, overflow = exchange_superkmers_bucket_sharded(
        *_stage_shards(shards, n_own, mesh, axis),
        k,
        mesh,
        axis,
        minimizer_m,
    )
    if bool(overflow):
        raise OverflowError(
            "super-k-mer exchange: an owner's record share exceeded the "
            "send capacity (pathological minimizer-run density) — use the "
            "aggregated exchange (count_bucket_sharded)"
        )
    planes = [np.asarray(p) for p in planes]
    meta = np.asarray(meta)
    D = meta.shape[0]
    tables = []
    for d in range(D):
        stream = expand_superkmers(
            [p[d] for p in planes], meta[d], k, minimizer_m
        )
        tables.append(_count_stream_host(stream, k, canonical))
    return merge_sparse_tables(tables)


def shard_stream_with_halo(
    flat: np.ndarray, k: int, mesh, axis: str = DATA_AXIS, total_own=None
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side feeder: split a flat stream into [D, T + k - 1] shards with
    per-shard halos (tail windows completed by the next shard's head) and
    the per-shard owned-window counts. Pads with INVALID.

    total_own (optional): only windows starting at global positions <
    total_own are owned — the streaming pipeline's batch rule (the batch's
    trailing k-1 overlap bases complete windows but start none)."""
    from dna_kmeres_parallel.ops.encode import INVALID

    D = mesh.shape[axis]
    total = flat.shape[0]
    if total_own is None:
        total_own = total
    # Floor T at 1 so an EMPTY stream still yields k-wide all-INVALID
    # shards (counting them returns an empty table) instead of [D, k-1]
    # shards that crash the encoder's window math.
    T = max(-(-total // D), 1)
    halo = k - 1
    out = np.full((D, T + halo), INVALID, dtype=np.uint8)
    n_own = np.zeros(D, dtype=np.int32)
    for d in range(D):
        start = d * T
        end = min(start + T + halo, total)
        if start < total:
            seg = flat[start:end]
            out[d, : seg.shape[0]] = seg
            n_own[d] = max(min(T, total_own - start), 0)
    return out, n_own


def gather_table(hi, lo, counts, starts) -> tuple[np.ndarray, np.ndarray]:
    """Host-side compaction of the per-device masked RLE outputs into one
    globally sorted (codes_u64, counts) table. Owners partition the code
    space, so a sorted-merge of the per-device tables is exact (and also
    covers the k~16 case where owner bits are not the code's top bits)."""
    from dna_kmeres_parallel.models.sparse_engine import merge_sparse_tables

    hi = np.asarray(hi)
    lo = np.asarray(lo)
    counts = np.asarray(counts)
    starts = np.asarray(starts)
    tables = []
    for d in range(hi.shape[0]):
        idx = np.flatnonzero(starts[d])
        tables.append(
            (
                sparse_ops.merged_code64(hi[d][idx], lo[d][idx]),
                counts[d][idx].astype(np.int64),
            )
        )
    return merge_sparse_tables(tables)
