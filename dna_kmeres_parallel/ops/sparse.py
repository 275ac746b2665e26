"""Sparse (sorted) k-mer counting for large k (13 <= k <= 31).

4^k dwarfs HBM for k >= 16 (4^21 ~ 4.4e12 bins), so the dense-histogram
representation gives way to the sorted sparse table — the device
formulation of what CPU/GPU counters (KMC, Gerbil) do with disk buckets:

  bases -> rolling SPLIT-WORD codes (hi, lo)             (k <= 31: 2k bits)
        -> optional RC canonicalization (lexicographic min of split words)
        -> multi-key XLA sort (lexicographic)
        -> run-START flags by neighbor-compare (no scatter)

Run *lengths* are NOT computed on device: consecutive start indices encode
them for free, so the host compactor (native/fastaparse.cpp kp_compact_*)
derives counts while compacting — this removes both a device scan
(lax.cummin) and a 4-bytes-per-window device->host transfer.

The sort dominates the device path when it runs on device, and every
additional 32-bit operand adds to it, so the key layout adapts to k:

  k <= 15:       one u32 key (code < 2^30; sentinel 0xFFFFFFFF is safe)
  16 <= k <= 23: (u16 hi, u32 lo) — hi holds the first 2k-32 <= 14 bits
                 (k=16's all-T code IS 0xFFFFFFFF, hence the hi word even
                 though it is zero: the u16 sentinel 0xFFFF disambiguates)
  24 <= k <= 31: (u32 hi, u32 lo)

lo always holds the last min(k,16) bases; (hi, lo) compares
lexicographically identically to the 2k-bit code.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

MIN_SPARSE_K = 13
MAX_SPARSE_K = 31

_LO_BASES = 16  # bases held in the lo word

#: largest k whose codes fit a single u32 strictly below the sentinel
MAX_SINGLE_WORD_K = 15
#: largest k whose hi word fits strictly below the u16 sentinel
MAX_U16_HI_K = 23


def _lo_bases(k: int) -> int:
    return min(k, _LO_BASES)


def key_words(k: int) -> int:
    """Number of sort-key words for this k (1 or 2)."""
    return 1 if k <= MAX_SINGLE_WORD_K else 2


def hi_dtype(k: int):
    """Dtype of the hi sort word (None if single-word)."""
    if k <= MAX_SINGLE_WORD_K:
        return None
    return jnp.uint16 if k <= MAX_U16_HI_K else jnp.uint32


def rolling_codes_split(bases: jax.Array, k: int):
    """[T] uint8 base codes -> ((hi, lo) uint32 [T-k+1], valid bool).

    hi holds the first k-16 bases (0 if k <= 16), lo the last min(k,16);
    (hi, lo) compares lexicographically identically to the 2k-bit code.
    """
    if not (1 <= k <= MAX_SPARSE_K):
        raise ValueError(f"k must be in [1, {MAX_SPARSE_K}]")
    T = bases.shape[-1]
    n = T - k + 1
    if n <= 0:
        raise ValueError(f"window axis too short: T={T} < k={k}")
    nlo = _lo_bases(k)
    nhi = k - nlo
    hi = jnp.zeros(bases.shape[:-1] + (n,), jnp.uint32)
    lo = jnp.zeros(bases.shape[:-1] + (n,), jnp.uint32)
    valid = jnp.ones(bases.shape[:-1] + (n,), jnp.bool_)
    for t in range(k):  # static unroll
        w = jax.lax.slice_in_dim(bases, t, t + n, axis=-1)
        valid = valid & (w < 4)
        b = (w & 3).astype(jnp.uint32)
        if t < nhi:
            hi = (hi << 2) | b
        else:
            lo = (lo << 2) | b
    return (hi, lo), valid


def revcomp_split(hi: jax.Array, lo: jax.Array, k: int):
    """Reverse complement of split codes (digit-reverse + complement)."""
    nlo = _lo_bases(k)
    nhi = k - nlo
    # Walk digits from least significant (end of k-mer) to most significant,
    # emitting complemented digits into the rc accumulator most-significant
    # first — i.e. plain rolling accumulation of complemented digits.
    rc_hi = jnp.zeros_like(hi)
    rc_lo = jnp.zeros_like(lo)
    src_hi, src_lo = hi, lo

    def next_digit(sh, sl):
        d = sl & 3
        sl = (sl >> 2) | ((sh & 3) << (2 * (nlo - 1)))
        sh = sh >> 2
        return d, sh, sl

    for i in range(k):  # static
        d, src_hi, src_lo = next_digit(src_hi, src_lo)
        comp = d ^ 3
        if i < nhi:
            rc_hi = (rc_hi << 2) | comp
        else:
            rc_lo = (rc_lo << 2) | comp
    return rc_hi, rc_lo


def canonicalize_split(hi: jax.Array, lo: jax.Array, k: int):
    """Lexicographic min of (hi, lo) and its reverse complement."""
    rc_hi, rc_lo = revcomp_split(hi, lo, k)
    take_rc = (rc_hi < hi) | ((rc_hi == hi) & (rc_lo < lo))
    return jnp.where(take_rc, rc_hi, hi), jnp.where(take_rc, rc_lo, lo)


def _encode_words(bases: jax.Array, n_own: jax.Array, k: int, canonical: bool):
    """Encode to the adaptive UNSORTED key-word tuple: (lo,) for k <= 15,
    (hi_u16, lo) for k <= 23, else (hi_u32, lo), in stream order; invalid
    and unowned windows hold the all-ones sentinel in every word."""
    sentinel32 = jnp.uint32(0xFFFFFFFF)
    (hi, lo), valid = rolling_codes_split(bases, k)
    n = hi.shape[0]
    own = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1) < n_own
    valid = valid & own
    if canonical:
        hi, lo = canonicalize_split(hi, lo, k)
    hi = jnp.where(valid, hi, sentinel32)
    lo = jnp.where(valid, lo, sentinel32)
    if k <= MAX_SINGLE_WORD_K:
        # hi is all zeros for valid windows; the sentinel lives in lo and
        # cannot collide (codes < 2^30 < 0xFFFFFFFF).
        return (lo,)
    if k <= MAX_U16_HI_K:
        # hi fits 14 bits; the u16 sentinel 0xFFFF disambiguates even when
        # lo is all-ones (the k=16 all-T k-mer). Narrower key word -> fewer
        # bytes through every sort pass and every transfer.
        hi16 = jnp.where(
            hi == sentinel32, jnp.uint16(0xFFFF), hi.astype(jnp.uint16)
        )
        return (hi16, lo)
    return (hi, lo)


def _encode_words_packfmt(
    data: jax.Array,
    mask: jax.Array,
    n_own: jax.Array,
    k: int,
    canonical: bool,
):
    """_encode_words over the 2-bit packed transfer format: the unpack
    fuses into the device program."""
    from dna_kmeres_parallel.ops import encode as encode_ops

    bases = encode_ops.unpack_stream(data, mask)
    return _encode_words(bases, n_own, k, canonical)


def word_sentinel(dtype):
    """All-ones sentinel of a sort-word dtype."""
    return jnp.asarray(0xFFFF if dtype == jnp.uint16 else 0xFFFFFFFF, dtype)


def _encode_and_sort(bases, n_own, k: int, canonical: bool):
    words = _encode_words(bases, n_own, k, canonical)
    return tuple(jax.lax.sort(words, num_keys=len(words)))


def _sort_words_as_rows(words, row_len: int):
    n = words[-1].shape[0]
    rows = max(1, -(-n // row_len))
    npad = rows * row_len
    shaped = []
    for w in words:
        if npad != n:
            w = jnp.pad(w, (0, npad - n), constant_values=word_sentinel(w.dtype))
        shaped.append(w.reshape(rows, npad // rows))
    return tuple(jax.lax.sort(shaped, num_keys=len(shaped), dimension=-1))


@functools.partial(jax.jit, static_argnames=("k", "canonical"))
def sort_words(
    bases: jax.Array,
    n_own: jax.Array,
    k: int,
    canonical: bool = False,
):
    """Flat [T] base stream -> tuple of SORTED code words (encode ->
    [canonicalize] -> sort, nothing else).

    Words are lexicographic-major first — (lo_u32,) for k <= 15,
    (hi_u16, lo_u32) for k <= 23, else (hi_u32, lo_u32). Invalid windows
    sort to an all-ones sentinel tail. N = T-k+1.

    Run boundaries and lengths are NOT computed on device: the host
    compactor (native.compact_sorted_native) derives both from neighbor
    compares in the single pass it makes anyway.
    """
    return _encode_and_sort(bases, n_own, k, canonical)


@functools.partial(jax.jit, static_argnames=("k", "canonical", "row_len"))
def sort_words_rows(
    bases: jax.Array,
    n_own: jax.Array,
    k: int,
    canonical: bool = False,
    row_len: int = 2048,
):
    """Row-sorted variant of sort_words: encode, then sort [rows, row_len]
    SEGMENTS of the window stream independently (lax.sort dimension=-1).
    The R-way merge the device skips moves to the host compactor
    (native.compact_rows_native), which walks every entry once anyway.

    Returns the same word tuple as sort_words but 2-D [rows, row_len]; each
    row ascends with an all-ones sentinel tail (padding windows join the
    sentinels). The stream is padded up to a row multiple, so rows =
    ceil(n_windows / row_len).
    """
    words = _encode_words(bases, n_own, k, canonical)
    return _sort_words_as_rows(words, row_len)


@functools.partial(jax.jit, static_argnames=("k", "canonical"))
def sort_words_packed(
    data: jax.Array,
    mask: jax.Array,
    n_own: jax.Array,
    k: int,
    canonical: bool = False,
):
    """sort_words over the 2-bit packed transfer format (data [T/4] +
    validity mask [T/8]; see models/engine.stage_batch): 4x less H2D, the
    unpack fuses into the device program."""
    words = _encode_words_packfmt(data, mask, n_own, k, canonical)
    return tuple(jax.lax.sort(words, num_keys=len(words)))


@functools.partial(jax.jit, static_argnames=("k", "canonical", "row_len"))
def sort_words_rows_packed(
    data: jax.Array,
    mask: jax.Array,
    n_own: jax.Array,
    k: int,
    canonical: bool = False,
    row_len: int = 2048,
):
    """sort_words_rows over the 2-bit packed transfer format."""
    words = _encode_words_packfmt(data, mask, n_own, k, canonical)
    return _sort_words_as_rows(words, row_len)


@functools.partial(jax.jit, static_argnames=("k", "canonical"))
def encode_words(
    bases: jax.Array,
    n_own: jax.Array,
    k: int,
    canonical: bool = False,
):
    """Encode-ONLY device program: UNSORTED adaptive code words.

    The device half of the no-device-sort sparse path: windows become the
    same split-word tuple sort_words produces — (lo,) / (hi_u16, lo) /
    (hi_u32, lo) with all-ones sentinels for invalid or padding windows —
    but are shipped in stream order with NO device sort. The host radix
    compactor (native.compact_unsorted_native) builds the sorted-unique
    table in a constant number of passes.
    """
    return _encode_words(bases, n_own, k, canonical)


@functools.partial(jax.jit, static_argnames=("k", "canonical"))
def encode_words_packed(
    data: jax.Array,
    mask: jax.Array,
    n_own: jax.Array,
    k: int,
    canonical: bool = False,
):
    """encode_words over the 2-bit packed transfer format."""
    return _encode_words_packfmt(data, mask, n_own, k, canonical)


@functools.partial(jax.jit, static_argnames=("k", "canonical"))
def sort_unique_starts(
    bases: jax.Array,
    n_own: jax.Array,
    k: int,
    canonical: bool = False,
):
    """sort_words plus device-computed run-start flags.

    Returns (words, starts); starts[i] is True at the first element of
    each distinct run (False throughout the sentinel tail). Prefer
    sort_words + host compaction in pipelines; this variant serves
    device-resident consumers of the flags (and benches).
    """
    words = _encode_and_sort(bases, n_own, k, canonical)
    n = words[-1].shape[0]
    major = words[0]
    major_sent = jnp.asarray(
        0xFFFF if major.dtype == jnp.uint16 else 0xFFFFFFFF, major.dtype
    )
    is_valid = major != major_sent
    neq = jnp.zeros((n - 1,), jnp.bool_)
    for w in words:
        neq = neq | (w[1:] != w[:-1])
    starts = jnp.concatenate([is_valid[:1], neq & is_valid[1:]])
    return words, starts


def sort_unique_counts(
    bases: jax.Array,
    n_own: jax.Array,
    k: int,
    canonical: bool = False,
):
    """Back-compat wrapper: (hi, lo, counts, starts) with device-computed
    run lengths. Prefer sort_unique_starts + host-side counts (the counts
    array costs a device scan and 4 bytes/window of D2H for information the
    start indices already encode)."""
    words, starts = sort_unique_starts(bases, n_own, k, canonical)
    return _with_counts(words, starts, k)


@functools.partial(jax.jit, static_argnames=("k",))
def _with_counts(words, starts, k: int):
    lo_s = words[-1]
    n = lo_s.shape[0]
    if len(words) == 1:
        is_valid = lo_s != jnp.uint32(0xFFFFFFFF)
        hi_s = jnp.where(is_valid, jnp.uint32(0), jnp.uint32(0xFFFFFFFF))
    else:
        hi_s = words[0].astype(jnp.uint32)
        sent = jnp.asarray(
            0xFFFF if words[0].dtype == jnp.uint16 else 0xFFFFFFFF,
            words[0].dtype,
        )
        is_valid = words[0] != sent
        hi_s = jnp.where(is_valid, hi_s, jnp.uint32(0xFFFFFFFF))
    idx = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1)
    flagged = jnp.where(starts | ~is_valid, idx, n)
    # next_start_at_or_after[i] = min(flagged[i:]) — reverse cumulative min.
    # lax.cummin (native scan primitive) — not associative_scan, whose
    # generic slice/concat tree compiles far slower at millions of
    # elements.
    next_start = jax.lax.cummin(flagged, reverse=True)
    after = jnp.concatenate([next_start[1:], jnp.full((1,), n, jnp.int32)])
    counts = after - idx
    return hi_s, lo_s, counts, starts


def merged_code64(hi, lo):
    """Pack split words into one uint64 (host-side convenience)."""
    import numpy as np

    return (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(
        lo, dtype=np.uint64
    )


@functools.partial(jax.jit, static_argnames=("k", "canonical"))
def sort_words_rle(
    bases: jax.Array,
    n_own: jax.Array,
    k: int,
    canonical: bool = False,
):
    """Device sort + RLE compaction to DISTINCT (code, count) pairs — the
    high-duplication D2H mode (KmerConfig.compact='device-rle').

    Sequencing reads carry 30-50x coverage: most windows are duplicates.
    The words paths ship every window (6-8 B each) and leave dedup to the
    host radix (~50 Melem/s); here the device collapses runs after its
    sort, so D2H and host work scale with DISTINCT codes — ~(10/dup)
    B/window — and the host merge consumes already-sorted-unique tables
    through the two-pointer ladder (~100 Melem/s), with no radix pass.

    Device cost: the usual multi-key sort plus ONE extra single-key sort
    (the distinct-first compaction permutes run starts to the front by
    their stream position, which is code order). Low-duplication inputs
    should prefer the no-sort encode path — the device sort only pays
    when dup is high.

    Returns (words_compact, counts_i32, n_distinct_i32): entries past
    n_distinct are sentinel garbage; counts[j] is the j-th distinct
    code's multiplicity.
    """
    words, starts = sort_unique_starts(bases, n_own, k, canonical)
    n = words[-1].shape[0]
    idx = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1)
    key = jnp.where(starts, idx, jnp.int32(n))
    parts = jax.lax.sort((key, *words), num_keys=1)
    pos = parts[0]
    words_c = parts[1:]
    n_distinct = jnp.sum(starts.astype(jnp.int32))
    major = words[0]
    major_sent = jnp.asarray(
        0xFFFF if major.dtype == jnp.uint16 else 0xFFFFFFFF, major.dtype
    )
    n_valid = jnp.sum((major != major_sent).astype(jnp.int32))
    nxt = jnp.concatenate([pos[1:], jnp.full((1,), n, jnp.int32)])
    counts = jnp.where(nxt == n, n_valid, nxt) - pos
    return words_c, counts, n_distinct
