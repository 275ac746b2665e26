"""ctypes loader for the native FASTA parser / 2-bit packer.

Builds ``libfastaparse.so`` on demand with the Makefile (g++ is in the
image; pybind11 is not, hence the plain C ABI + ctypes). Every entry point
has a pure-Python fallback (utils/fasta.py, utils/codec.py) and the native
results are differential-tested against those fallbacks.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from dataclasses import dataclass

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libfastaparse.so")

_lib = None
_build_error: str | None = None


class _KpFasta(ctypes.Structure):
    _fields_ = [
        ("n_seqs", ctypes.c_int64),
        ("stream_len", ctypes.c_int64),
        ("stream", ctypes.POINTER(ctypes.c_uint8)),
        ("offsets", ctypes.POINTER(ctypes.c_int64)),
        ("lengths", ctypes.POINTER(ctypes.c_int64)),
        ("ids", ctypes.POINTER(ctypes.c_char)),
        ("ids_len", ctypes.c_int64),
        ("total_bases", ctypes.c_int64),
        ("invalid_bases", ctypes.c_int64),
    ]


def _build() -> str | None:
    """Compile the shared library if missing/stale. Returns error or None."""
    src = os.path.join(_DIR, "fastaparse.cpp")
    try:
        if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(src):
            return None
        proc = subprocess.run(
            ["make", "-C", _DIR, "-s"], capture_output=True, text=True, timeout=120
        )
        if proc.returncode != 0:
            return proc.stderr[-2000:]
        return None
    except Exception as e:  # pragma: no cover
        return repr(e)


def _load():
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    _build_error = _build()
    if _build_error is not None:
        return None
    lib = ctypes.CDLL(_SO)
    lib.kp_parse_fasta.restype = ctypes.c_int
    lib.kp_parse_fasta.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(_KpFasta)),
    ]
    lib.kp_parse_fasta_range.restype = ctypes.c_int
    lib.kp_parse_fasta_range.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(_KpFasta)),
    ]
    lib.kp_free_fasta.argtypes = [ctypes.POINTER(_KpFasta)]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.kp_pack_2bit.argtypes = [u8p, ctypes.c_int64, u8p, u8p]
    lib.kp_unpack_2bit.argtypes = [u8p, u8p, ctypes.c_int64, u8p]
    lib.kp_count_dense.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int, i64p
    ]
    lib.kp_count_starts.restype = ctypes.c_int64
    lib.kp_count_starts.argtypes = [u8p, ctypes.c_int64]
    lib.kp_compact_rle.restype = ctypes.c_int64
    lib.kp_compact_rle.argtypes = [
        u32p, u32p, i32p, u8p, ctypes.c_int64, u64p, i64p
    ]
    lib.kp_compact_starts.restype = ctypes.c_int64
    lib.kp_compact_starts.argtypes = [
        ctypes.c_void_p, ctypes.c_int, u32p, u8p, ctypes.c_int64, u64p, i64p
    ]
    lib.kp_count_distinct.restype = ctypes.c_int64
    lib.kp_count_distinct.argtypes = [
        ctypes.c_void_p, ctypes.c_int, u32p, ctypes.c_int64
    ]
    lib.kp_compact_sorted.restype = ctypes.c_int64
    lib.kp_compact_sorted.argtypes = [
        ctypes.c_void_p, ctypes.c_int, u32p, ctypes.c_int64, u64p, i64p
    ]
    lib.kp_rows_valid.restype = ctypes.c_int64
    lib.kp_rows_valid.argtypes = [
        ctypes.c_void_p, ctypes.c_int, u32p, ctypes.c_int64, ctypes.c_int64
    ]
    lib.kp_compact_rows.restype = ctypes.c_int64
    lib.kp_compact_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_int, u32p, ctypes.c_int64, ctypes.c_int64,
        u64p, i64p,
    ]
    lib.kp_count_windows_valid.restype = ctypes.c_int64
    lib.kp_count_windows_valid.argtypes = [u8p, ctypes.c_int64, ctypes.c_int]
    lib.kp_count_sparse_host.restype = ctypes.c_int64
    lib.kp_count_sparse_host.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, u64p, i64p
    ]
    lib.kp_count_valid.restype = ctypes.c_int64
    lib.kp_count_valid.argtypes = [
        ctypes.c_void_p, ctypes.c_int, u32p, ctypes.c_int64, ctypes.c_int
    ]
    lib.kp_compact_unsorted.restype = ctypes.c_int64
    lib.kp_compact_unsorted.argtypes = [
        ctypes.c_void_p, ctypes.c_int, u32p, ctypes.c_int64, ctypes.c_int,
        u64p, i64p,
    ]
    lib.kp_merge_tables.restype = ctypes.c_int64
    lib.kp_merge_tables.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p),
        i64p,
        u64p,
        i64p,
    ]
    lib.kp_format_f6.restype = ctypes.c_int64
    lib.kp_format_f6.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_char_p,
        ctypes.c_int64,
    ]
    lib.kp_min_sum_pairs.restype = ctypes.c_int64
    lib.kp_min_sum_pairs.argtypes = [u64p, i64p, i64p, ctypes.c_int64, i64p]
    lib.kp_min_sum_panel.restype = ctypes.c_int64
    lib.kp_min_sum_panel.argtypes = [
        u64p,
        i64p,
        i64p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        i64p,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


@dataclass
class ParsedFasta:
    """Native parse result: the device-ready flat stream plus metadata."""

    n_seqs: int
    stream: np.ndarray  # uint8 [stream_len], 0xFF = invalid/sentinel
    offsets: np.ndarray  # int64 [n_seqs + 1]
    lengths: np.ndarray  # int64 [n_seqs]
    ids: list[str]
    total_bases: int
    invalid_bases: int

    def sequence_codes(self, i: int) -> np.ndarray:
        return self.stream[self.offsets[i] : self.offsets[i] + self.lengths[i]]


def parse_fasta_native(
    path: str,
    max_seqs: int | None = None,
    byte_range: tuple[int, int] | None = None,
) -> ParsedFasta:
    """Parse a FASTA file with the C++ parser into a flat encoded stream.

    byte_range=(start, end) parses only records starting in that range —
    the multi-host input-sharding path (ranges must be record-aligned; see
    parallel/multihost.split_fasta_byte_ranges).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native parser unavailable: {_build_error}")
    if max_seqs == 0:
        # The C side treats <= 0 as "no cap"; the Python parser returns no
        # records for an explicit 0 — honor that here for parser parity.
        return ParsedFasta(
            n_seqs=0, stream=np.zeros(0, np.uint8),
            offsets=np.zeros(1, np.int64), lengths=np.zeros(0, np.int64),
            ids=[], total_bases=0, invalid_bases=0,
        )
    out = ctypes.POINTER(_KpFasta)()
    start, end = byte_range if byte_range is not None else (0, -1)
    rc = lib.kp_parse_fasta_range(
        os.fspath(path).encode(),
        ctypes.c_int64(start),
        ctypes.c_int64(end),
        ctypes.c_int64(max_seqs or 0),
        ctypes.byref(out),
    )
    if rc == 1:
        raise FileNotFoundError(path)
    if rc != 0:
        raise IOError(f"native FASTA parse failed with code {rc}")
    r = out.contents
    try:
        n = int(r.n_seqs)
        stream = np.ctypeslib.as_array(r.stream, shape=(int(r.stream_len),)).copy() if r.stream_len else np.zeros(0, np.uint8)
        offsets = np.ctypeslib.as_array(r.offsets, shape=(n + 1,)).copy()
        lengths = (
            np.ctypeslib.as_array(r.lengths, shape=(n,)).copy()
            if n
            else np.zeros(0, np.int64)
        )
        raw_ids = ctypes.string_at(r.ids, int(r.ids_len)) if r.ids_len else b""
        ids = [s.decode("ascii", "replace") for s in raw_ids.split(b"\0") if s]
        return ParsedFasta(
            n_seqs=n,
            stream=stream,
            offsets=offsets.astype(np.int64),
            lengths=lengths.astype(np.int64),
            ids=ids,
            total_bases=int(r.total_bases),
            invalid_bases=int(r.invalid_bases),
        )
    finally:
        lib.kp_free_fasta(out)


def pack_2bit_native(bases: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """uint8 base codes -> (packed data 4/byte, validity mask 8/byte, length)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native packer unavailable: {_build_error}")
    bases = np.ascontiguousarray(bases, dtype=np.uint8)
    n = bases.shape[0]
    data = np.zeros((n + 3) // 4, dtype=np.uint8)
    mask = np.zeros((n + 7) // 8, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.kp_pack_2bit(
        bases.ctypes.data_as(u8p), n, data.ctypes.data_as(u8p), mask.ctypes.data_as(u8p)
    )
    return data, mask, n


def count_dense_native(
    stream: np.ndarray, k: int, n_own: int | None = None, canonical: bool = False
) -> np.ndarray:
    """Native dense k-mer count of an encoded stream (0xFF sentinels) —
    the fast host golden engine for validating device results at scale."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native counter unavailable: {_build_error}")
    if not (1 <= k <= 15):
        raise ValueError("native dense counter supports k <= 15")
    stream = np.ascontiguousarray(stream, dtype=np.uint8)
    n = stream.shape[0]
    if n_own is None:
        n_own = n
    out = np.zeros(1 << (2 * k), dtype=np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.kp_count_dense(
        stream.ctypes.data_as(u8p), n, n_own, k, int(canonical),
        out.ctypes.data_as(i64p),
    )
    return out


def compact_rle_native(
    hi: np.ndarray, lo: np.ndarray, counts: np.ndarray, starts: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Compact masked RLE device output into (codes_u64, counts_i64)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native compactor unavailable: {_build_error}")
    hi = np.ascontiguousarray(hi, dtype=np.uint32)
    lo = np.ascontiguousarray(lo, dtype=np.uint32)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    starts_u8 = np.ascontiguousarray(starts, dtype=np.uint8)
    n = hi.shape[0]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    m = lib.kp_count_starts(starts_u8.ctypes.data_as(u8p), n)
    out_code = np.zeros(m, dtype=np.uint64)
    out_cnt = np.zeros(m, dtype=np.int64)
    w = lib.kp_compact_rle(
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        starts_u8.ctypes.data_as(u8p),
        n,
        out_code.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out_cnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    assert w == m
    return out_code, out_cnt


def compact_starts_native(
    words: tuple[np.ndarray, ...], starts: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Sorted code words + run-start flags -> (codes_u64, counts_i64).

    Run lengths come from consecutive start indices (the device never
    computes them). words is (lo_u32,) for k <= 15 or (hi_u16|u32, lo_u32).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native compactor unavailable: {_build_error}")
    lo = np.ascontiguousarray(words[-1], dtype=np.uint32)
    if len(words) == 1:
        hi_ptr, hi_width = None, 0
        hi = None
    else:
        hi = np.ascontiguousarray(words[0])
        if hi.dtype == np.uint16:
            hi_width = 2
        elif hi.dtype == np.uint32:
            hi_width = 4
        else:
            raise ValueError(f"hi word dtype {hi.dtype} unsupported")
        hi_ptr = hi.ctypes.data_as(ctypes.c_void_p)
    starts_u8 = np.ascontiguousarray(starts, dtype=np.uint8)
    n = lo.shape[0]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    m = lib.kp_count_starts(starts_u8.ctypes.data_as(u8p), n)
    out_code = np.zeros(m, dtype=np.uint64)
    out_cnt = np.zeros(m, dtype=np.int64)
    w = lib.kp_compact_starts(
        hi_ptr,
        hi_width,
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        starts_u8.ctypes.data_as(u8p),
        n,
        out_code.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out_cnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    assert w == m, (w, m)
    return out_code, out_cnt


def _hi_layout(words: tuple[np.ndarray, ...]):
    """(hi_ptr, hi_width, lo) for the sorted-word layouts."""
    lo = np.ascontiguousarray(words[-1], dtype=np.uint32)
    if len(words) == 1:
        return None, 0, lo
    hi = np.ascontiguousarray(words[0])
    if hi.dtype == np.uint16:
        width = 2
    elif hi.dtype == np.uint32:
        width = 4
    else:
        raise ValueError(f"hi word dtype {hi.dtype} unsupported")
    # Keep a reference alive via the returned array.
    return hi, width, lo


def compact_sorted_native(
    words: tuple[np.ndarray, ...]
) -> tuple[np.ndarray, np.ndarray]:
    """Sorted code words -> (codes_u64, counts_i64); run boundaries AND
    lengths derive from neighbor compares — no device-side flags at all."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native compactor unavailable: {_build_error}")
    hi, hi_width, lo = _hi_layout(words)
    hi_ptr = hi.ctypes.data_as(ctypes.c_void_p) if hi is not None else None
    n = lo.shape[0]
    u32p = ctypes.POINTER(ctypes.c_uint32)
    m = lib.kp_count_distinct(hi_ptr, hi_width, lo.ctypes.data_as(u32p), n)
    out_code = np.zeros(m, dtype=np.uint64)
    out_cnt = np.zeros(m, dtype=np.int64)
    w = lib.kp_compact_sorted(
        hi_ptr,
        hi_width,
        lo.ctypes.data_as(u32p),
        n,
        out_code.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out_cnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    assert w == m, (w, m)
    return out_code, out_cnt


def compact_rows_native(
    words: tuple[np.ndarray, ...]
) -> tuple[np.ndarray, np.ndarray]:
    """Row-sorted code words [R, m] -> merged (codes_u64, counts_i64).

    The host half of ops/sparse.sort_words_rows: each row is sorted with an
    all-ones sentinel tail; a code-range-partitioned multiway heap merge
    produces the single sorted-unique table in one pass.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native compactor unavailable: {_build_error}")
    lo = np.ascontiguousarray(words[-1], dtype=np.uint32)
    assert lo.ndim == 2, "compact_rows_native expects [rows, m] words"
    rows, m = lo.shape
    if len(words) == 1:
        hi, hi_ptr, hi_width = None, None, 0
    else:
        hi = np.ascontiguousarray(words[0])
        if hi.dtype == np.uint16:
            hi_width = 2
        elif hi.dtype == np.uint32:
            hi_width = 4
        else:
            raise ValueError(f"hi word dtype {hi.dtype} unsupported")
        hi_ptr = hi.ctypes.data_as(ctypes.c_void_p)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    cap = lib.kp_rows_valid(hi_ptr, hi_width, lo.ctypes.data_as(u32p), rows, m)
    out_code = np.zeros(cap, dtype=np.uint64)
    out_cnt = np.zeros(cap, dtype=np.int64)
    w = lib.kp_compact_rows(
        hi_ptr,
        hi_width,
        lo.ctypes.data_as(u32p),
        rows,
        m,
        out_code.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out_cnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out_code[:w].copy(), out_cnt[:w].copy()


def count_sparse_host_native(
    stream: np.ndarray, k: int, canonical: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """Host-only sparse k-mer count: u8 base stream (0..3 codes, 0xFF
    sequence sentinels) -> sorted-unique (codes_u64, counts_i64).

    The CPU engine for k >= 13 at GB scale (the role the reference's
    sequentialKmerCount2 plays at main.cu:587-621, generalized): a rolling
    2k-bit encoder (forward + reverse-complement tracked in O(1) per base)
    fused directly into the MSD+LSD radix compactor — no intermediate word
    arrays, ~1 byte read per base plus the compactor's constant passes.
    Same index space and canonicalization as the device path, so tables
    are bit-identical to the device engines'.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native counter unavailable: {_build_error}")
    if not (1 <= k <= 31):
        raise ValueError(f"k must be in [1, 31], got {k}")
    stream = np.ascontiguousarray(stream, dtype=np.uint8)
    n = stream.shape[0]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    cap = lib.kp_count_windows_valid(stream.ctypes.data_as(u8p), n, k)
    out_code = np.zeros(cap, dtype=np.uint64)
    out_cnt = np.zeros(cap, dtype=np.int64)
    w = lib.kp_count_sparse_host(
        stream.ctypes.data_as(u8p),
        n,
        k,
        1 if canonical else 0,
        out_code.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out_cnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if w < 0:
        raise MemoryError("native radix compactor: scratch allocation failed")
    assert w <= cap, (w, cap)
    return out_code[:w].copy(), out_cnt[:w].copy()


def min_sum_pairs_native(
    codes: np.ndarray, counts: np.ndarray, offs: np.ndarray
) -> np.ndarray:
    """Per-sequence sorted sparse tables -> packed strict-upper-triangle
    pairwise min-sums (the k >= 16 distance core; see kp_min_sum_pairs).

    codes/counts: concatenated per-sequence sorted-unique tables;
    offs: int64 [S+1] fences. Returns int64 [S*(S-1)/2]."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native engine unavailable: {_build_error}")
    i64p = ctypes.POINTER(ctypes.c_int64)
    codes = np.ascontiguousarray(codes, dtype=np.uint64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    S = offs.shape[0] - 1
    out = np.zeros(max(S * (S - 1) // 2, 1), dtype=np.int64)
    w = lib.kp_min_sum_pairs(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        counts.ctypes.data_as(i64p),
        offs.ctypes.data_as(i64p),
        S,
        out.ctypes.data_as(i64p),
    )
    return out[: max(w, 0)]


def min_sum_panel_native(
    codes: np.ndarray,
    counts: np.ndarray,
    offs: np.ndarray,
    r0: int,
    r1: int,
) -> np.ndarray:
    """Row-panel variant of min_sum_pairs_native: pair min-sums for rows
    [r0, r1) only, panel-locally packed (the streamed sparse distance
    engine's unit of work; see kp_min_sum_panel)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native engine unavailable: {_build_error}")
    i64p = ctypes.POINTER(ctypes.c_int64)
    codes = np.ascontiguousarray(codes, dtype=np.uint64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    S = offs.shape[0] - 1
    r0 = max(int(r0), 0)
    r1 = min(int(r1), max(S - 1, 0))
    if r0 >= r1:
        return np.zeros(0, dtype=np.int64)
    n = (r1 - r0) * (S - 1) - (r1 * (r1 - 1) - r0 * (r0 - 1)) // 2
    out = np.zeros(max(n, 1), dtype=np.int64)
    w = lib.kp_min_sum_panel(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        counts.ctypes.data_as(i64p),
        offs.ctypes.data_as(i64p),
        S,
        r0,
        r1,
        out.ctypes.data_as(i64p),
    )
    assert w == n, (w, n)
    return out[:n]


def format_f6(values: np.ndarray) -> bytes:
    """float32 values -> the reference's one-float-per-line CSV bytes
    ("%f\\n" each, main.cu:199-202) via the multithreaded native snprintf
    formatter — same libc %f digits as the Python "%f" loop it replaces
    (byte-parity preserved), ~10x faster at design scale (1.46G pairs).
    """
    lib = _load()
    values = np.ascontiguousarray(values, dtype=np.float32)
    if lib is None:
        return ("".join("%f\n" % v for v in values)).encode("ascii")
    n = values.shape[0]
    if n == 0:
        return b""
    buf = ctypes.create_string_buffer(16 * n)
    m = lib.kp_format_f6(
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, buf, 16 * n
    )
    assert m >= 0
    return buf.raw[:m]


def compact_unsorted_native(
    words: tuple[np.ndarray, ...], kbits: int
) -> tuple[np.ndarray, np.ndarray]:
    """UNSORTED window words -> merged sorted-unique (codes_u64, counts_i64).

    The host half of the NO-DEVICE-SORT sparse path: the device runs the
    encode kernel alone (ops/sparse.encode_words) and ships the word stream
    as-is (all-ones sentinel words where windows were invalid); this MSD+LSD
    radix compactor (native kp_compact_unsorted) builds the table in ~6
    memory touches per element regardless of batch size — measured ~2x the
    AVX-512 merge ladder and ~3.5x the loser tree that the row-sorted path
    needs (native/bench_merge.cpp). kbits = significant code bits (2k).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native compactor unavailable: {_build_error}")
    lo = np.ascontiguousarray(np.asarray(words[-1]).reshape(-1), dtype=np.uint32)
    n = lo.shape[0]
    if len(words) == 1:
        hi, hi_ptr, hi_width = None, None, 0
    else:
        hi = np.ascontiguousarray(np.asarray(words[0]).reshape(-1))
        if hi.dtype == np.uint16:
            hi_width = 2
        elif hi.dtype == np.uint32:
            hi_width = 4
        else:
            raise ValueError(f"hi word dtype {hi.dtype} unsupported")
        hi_ptr = hi.ctypes.data_as(ctypes.c_void_p)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    cap = lib.kp_count_valid(hi_ptr, hi_width, lo.ctypes.data_as(u32p), n, kbits)
    out_code = np.zeros(cap, dtype=np.uint64)
    out_cnt = np.zeros(cap, dtype=np.int64)
    w = lib.kp_compact_unsorted(
        hi_ptr,
        hi_width,
        lo.ctypes.data_as(u32p),
        n,
        kbits,
        out_code.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out_cnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if w < 0:
        raise MemoryError("native radix compactor: scratch allocation failed")
    assert w <= cap, (w, cap)
    return out_code[:w].copy(), out_cnt[:w].copy()


def merge_tables_native(
    tables: list[tuple[np.ndarray, np.ndarray]]
) -> tuple[np.ndarray, np.ndarray]:
    """Merge sorted-unique (codes_u64, counts_i64) tables, summing counts
    of equal codes.

    m > 2 reduces as a binary tree of pair merges: the two-pointer pair
    merge sustains ~107M entries/s/2 cores vs ~10M for the m-way heap, so
    log2(m) fast passes beat one slow pass for any realistic m."""
    tables = [t for t in tables if t[0].size]
    if not tables:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    while len(tables) > 2:
        nxt = [
            _merge_tables_native_kway(tables[i : i + 2])
            for i in range(0, len(tables) - 1, 2)
        ]
        if len(tables) % 2:
            nxt.append(tables[-1])
        tables = nxt
    return _merge_tables_native_kway(tables)


def _merge_tables_native_kway(
    tables: list[tuple[np.ndarray, np.ndarray]]
) -> tuple[np.ndarray, np.ndarray]:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native merge unavailable: {_build_error}")
    if len(tables) == 1:
        return tables[0]
    m = len(tables)
    codes = [np.ascontiguousarray(t[0], dtype=np.uint64) for t in tables]
    cnts = [np.ascontiguousarray(t[1], dtype=np.int64) for t in tables]
    lens = np.array([c.shape[0] for c in codes], dtype=np.int64)
    total = int(lens.sum())
    out_code = np.zeros(total, dtype=np.uint64)
    out_cnt = np.zeros(total, dtype=np.int64)
    code_ptrs = (ctypes.c_void_p * m)(
        *[c.ctypes.data_as(ctypes.c_void_p).value for c in codes]
    )
    cnt_ptrs = (ctypes.c_void_p * m)(
        *[c.ctypes.data_as(ctypes.c_void_p).value for c in cnts]
    )
    w = lib.kp_merge_tables(
        m,
        code_ptrs,
        cnt_ptrs,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_code.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out_cnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out_code[:w], out_cnt[:w]


def unpack_2bit_native(data: np.ndarray, mask: np.ndarray, n: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native packer unavailable: {_build_error}")
    data = np.ascontiguousarray(data, dtype=np.uint8)
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    out = np.zeros(n, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.kp_unpack_2bit(
        data.ctypes.data_as(u8p), mask.ctypes.data_as(u8p), n, out.ctypes.data_as(u8p)
    )
    return out
