"""Native C++ parser/packer vs the pure-Python implementations."""

import numpy as np
import pytest

from dna_kmeres_parallel import native
from dna_kmeres_parallel.utils import codec, fasta

pytestmark = pytest.mark.skipif(
    not native.available(), reason=f"native lib unavailable: {native.build_error()}"
)


def _write(tmp_path, records, width=60):
    path = tmp_path / "t.fasta"
    fasta.write_fasta(path, records, width=width)
    return str(path)


def test_parse_matches_python(tmp_path, make_dna):
    records = [(f">r{i} desc {i}", make_dna(100 + 37 * i, invalid_frac=0.05)) for i in range(12)]
    path = _write(tmp_path, records)
    got = native.parse_fasta_native(path)
    want = fasta.parse_fasta(path)
    assert got.n_seqs == len(want) == len(records)
    assert got.ids == [r.id for r in want]
    for i, r in enumerate(want):
        codes = got.sequence_codes(i)
        assert np.array_equal(codes, codec.encode_bases(r.seq))
        assert got.lengths[i] == len(r.seq)
    assert got.total_bases == sum(len(r.seq) for r in want)


def test_stream_sentinels(tmp_path):
    path = _write(tmp_path, [(">a", "AAAA"), (">b", "TTTT")])
    got = native.parse_fasta_native(path)
    # Exactly one INVALID sentinel between sequences.
    assert got.stream_len if hasattr(got, "stream_len") else True
    assert got.stream.shape[0] == 9
    assert got.stream[4] == codec.INVALID_BASE
    assert np.array_equal(got.stream[:4], [0, 0, 0, 0])
    assert np.array_equal(got.stream[5:], [3, 3, 3, 3])
    assert got.offsets.tolist() == [0, 5, 9]


def test_max_seqs_cap(tmp_path, make_dna):
    records = [(f">r{i}", make_dna(50)) for i in range(10)]
    path = _write(tmp_path, records)
    got = native.parse_fasta_native(path, max_seqs=3)
    assert got.n_seqs == 3
    assert got.ids == [f">r{i}" for i in range(3)]


def test_no_trailing_newline(tmp_path, make_dna):
    s = make_dna(83)
    path = tmp_path / "nt.fasta"
    path.write_text(f">only\n{s[:40]}\n{s[40:]}")  # no trailing newline
    got = native.parse_fasta_native(str(path))
    assert got.n_seqs == 1
    assert np.array_equal(got.sequence_codes(0), codec.encode_bases(s))


def test_crlf(tmp_path, make_dna):
    s = make_dna(64)
    path = tmp_path / "crlf.fasta"
    path.write_bytes(f">w\r\n{s[:32]}\r\n{s[32:]}\r\n".encode())
    got = native.parse_fasta_native(str(path))
    assert got.n_seqs == 1
    assert np.array_equal(got.sequence_codes(0), codec.encode_bases(s))


def test_missing_file():
    with pytest.raises(FileNotFoundError):
        native.parse_fasta_native("/definitely/not/here.fasta")


def test_invalid_count(tmp_path):
    path = _write(tmp_path, [(">x", "ACGTNNNacgt")])
    got = native.parse_fasta_native(path)
    assert got.invalid_bases == 7  # 3 Ns + 4 lowercase
    assert got.total_bases == 11


def test_pack_unpack_native_matches_python(make_dna):
    for L in (0, 1, 7, 8, 9, 1000):
        bases = codec.encode_bases(make_dna(L, invalid_frac=0.1))
        nd, nm, n = native.pack_2bit_native(bases)
        pd, pm, pn = codec.pack_bases(bases)
        assert n == pn == L
        assert np.array_equal(nd, pd)
        assert np.array_equal(nm, pm)
        assert np.array_equal(native.unpack_2bit_native(nd, nm, n), bases)


def test_large_multiline_stream(tmp_path, make_dna):
    # Cross-chunk line assembly: the C parser reads 1 MB chunks; force lines
    # spanning chunk boundaries with a ~3 MB file of short lines.
    records = [(f">big{i}", make_dna(150_000)) for i in range(8)]
    path = _write(tmp_path, records, width=61)
    got = native.parse_fasta_native(path)
    assert got.n_seqs == 8
    for i, (_, s) in enumerate(records):
        assert np.array_equal(got.sequence_codes(i), codec.encode_bases(s))


def test_count_dense_native_matches_oracle(make_dna):
    from dna_kmeres_parallel.models import oracle
    from dna_kmeres_parallel.models.engine import KmerEngine
    from dna_kmeres_parallel.utils.config import KmerConfig

    seqs = [make_dna(400, invalid_frac=0.03) for _ in range(5)]
    engine = KmerEngine(KmerConfig(k=5))
    flat, _ = engine._flat_stream(seqs)
    for k, canonical in ((3, False), (5, False), (5, True), (11, False)):
        got = native.count_dense_native(flat, k, canonical=canonical)
        want = sum(
            (oracle.count_vector(s, k, canonical) for s in seqs),
            np.zeros(4**k, np.int64),
        )
        assert np.array_equal(got, want), (k, canonical)


def test_count_dense_native_n_own(make_dna):
    from dna_kmeres_parallel.models import oracle

    s = make_dna(500)
    stream = codec.encode_bases(s)
    k = 7
    got = native.count_dense_native(stream, k, n_own=100)
    want = oracle.count_vector(s[: 100 + k - 1], k)
    assert np.array_equal(got, want)


def test_compact_rle_native_matches_python():
    hi = np.array([1, 1, 2, 7], np.uint32)
    lo = np.array([9, 9, 0, 3], np.uint32)
    counts = np.array([5, 99, 2, 1], np.int32)
    starts = np.array([True, False, True, True])
    codes, cnts = native.compact_rle_native(hi, lo, counts, starts)
    assert codes.tolist() == [(1 << 32) | 9, (2 << 32) | 0, (7 << 32) | 3]
    assert cnts.tolist() == [5, 2, 1]


def _python_compact_starts(words, starts):
    from dna_kmeres_parallel.models import sparse_engine
    from dna_kmeres_parallel.ops import sparse as sparse_ops

    major = words[0]
    sent = major.dtype.type(np.iinfo(major.dtype).max)
    end = int(np.searchsorted(major, sent))
    idx = np.flatnonzero(starts[:end])
    counts = np.diff(np.append(idx, end)).astype(np.int64)
    if len(words) == 1:
        codes = words[0][idx].astype(np.uint64)
    else:
        codes = sparse_ops.merged_code64(words[0][idx], words[1][idx])
    return codes, counts


@pytest.mark.parametrize("layout", ["single", "u16", "u32"])
def test_compact_starts_native_matches_python(layout):
    # Large enough to exercise the multithreaded two-pass path, with runs
    # spanning thread-range boundaries.
    rng = np.random.default_rng(3)
    n = 1 << 16
    n_valid = n - 500
    lo = np.sort(rng.integers(0, 1 << 20, n_valid).astype(np.uint32))
    lo = np.concatenate([lo, np.full(500, 0xFFFFFFFF, np.uint32)])
    if layout == "single":
        words = (lo,)
    elif layout == "u16":
        hi = np.zeros(n, np.uint16)
        hi[n_valid:] = 0xFFFF
        words = (hi, lo)
    else:
        hi = np.zeros(n, np.uint32)
        hi[n_valid:] = 0xFFFFFFFF
        words = (hi, lo)
    starts = np.zeros(n, bool)
    starts[0] = True
    starts[1:n_valid] = lo[1:n_valid] != lo[:n_valid - 1]
    got_c, got_n = native.compact_starts_native(words, starts)
    want_c, want_n = _python_compact_starts(words, starts)
    assert np.array_equal(got_c, want_c)
    assert np.array_equal(got_n, want_n)
    assert int(got_n.sum()) == n_valid


@pytest.mark.parametrize("layout", ["single", "u16", "u32"])
def test_compact_sorted_native_matches_python(layout):
    rng = np.random.default_rng(5)
    n = 1 << 16
    n_valid = n - 300
    lo = np.sort(rng.integers(0, 1 << 18, n_valid).astype(np.uint32))
    lo = np.concatenate([lo, np.full(300, 0xFFFFFFFF, np.uint32)])
    if layout == "single":
        words = (lo,)
    else:
        dt = np.uint16 if layout == "u16" else np.uint32
        hi = np.zeros(n, dt)
        hi[n_valid:] = np.iinfo(dt).max
        # give some valid entries a nonzero hi, keeping (hi, lo) sorted
        hi[n_valid // 2 : n_valid] = 1
        lo[n_valid // 2 : n_valid] = np.sort(
            rng.integers(0, 1 << 18, n_valid - n_valid // 2).astype(np.uint32)
        )
        words = (hi, lo)
    got_c, got_n = native.compact_sorted_native(words)
    # direct python reference
    major = words[0]
    sent = major.dtype.type(np.iinfo(major.dtype).max)
    end = int(np.searchsorted(major, sent))
    if len(words) == 1:
        codes_all = words[0][:end].astype(np.uint64)
    else:
        codes_all = (words[0][:end].astype(np.uint64) << np.uint64(32)) | words[1][
            :end
        ].astype(np.uint64)
    starts = np.concatenate([[True], codes_all[1:] != codes_all[:-1]])
    idx = np.flatnonzero(starts)
    want_n = np.diff(np.append(idx, end)).astype(np.int64)
    assert np.array_equal(got_c, codes_all[idx])
    assert np.array_equal(got_n, want_n)
    assert int(got_n.sum()) == n_valid


def test_merge_tables_native_matches_python():
    rng = np.random.default_rng(11)
    tables = []
    for _ in range(13):
        m = int(rng.integers(1, 5000))
        codes = np.unique(rng.integers(0, 1 << 40, m).astype(np.uint64))
        cnts = rng.integers(1, 100, codes.shape[0]).astype(np.int64)
        tables.append((codes, cnts))
    got_c, got_n = native.merge_tables_native(tables)
    # numpy reference
    allc = np.concatenate([t[0] for t in tables])
    alln = np.concatenate([t[1] for t in tables])
    order = np.argsort(allc, kind="stable")
    allc, alln = allc[order], alln[order]
    uniq = np.concatenate([[True], allc[1:] != allc[:-1]])
    want_c = allc[uniq]
    want_n = np.zeros(want_c.shape[0], np.int64)
    np.add.at(want_n, np.cumsum(uniq) - 1, alln)
    assert np.array_equal(got_c, want_c)
    assert np.array_equal(got_n, want_n)


def test_merge_tables_native_extreme_codes():
    # Codes at the extremes (0 and UINT64_MAX) survive pivot partitioning.
    t1 = (np.array([0, 2**64 - 1], np.uint64), np.array([1, 2], np.int64))
    t2 = (np.array([0, 5], np.uint64), np.array([7, 1], np.int64))
    codes, cnts = native.merge_tables_native([t1, t2])
    assert codes.tolist() == [0, 5, 2**64 - 1]
    assert cnts.tolist() == [8, 1, 2]


@pytest.mark.parametrize("layout", ["single", "u16", "u32"])
def test_compact_rows_native_matches_python(layout):
    # Row-sorted [R, m] words with per-row sentinel tails: the native
    # multiway merge must equal a flat sort + RLE of the valid entries.
    rng = np.random.default_rng(17)
    R, m = 37, 512
    lo = np.empty((R, m), np.uint32)
    hi = None
    if layout != "single":
        dt = np.uint16 if layout == "u16" else np.uint32
        hi = np.empty((R, m), dt)
    for r in range(R):
        nv = int(rng.integers(0, m + 1))
        # duplicate-heavy codes so runs span rows
        lo_r = np.sort(rng.integers(0, 1 << 10, nv).astype(np.uint32))
        lo[r, :nv] = lo_r
        lo[r, nv:] = 0xFFFFFFFF
        if hi is not None:
            hv = rng.integers(0, 3, nv).astype(hi.dtype)
            hv.sort()
            # keep (hi, lo) lexicographically sorted within the row
            order = np.lexsort((lo_r, hv))
            hi[r, :nv] = hv[order]
            lo[r, :nv] = lo_r[order]
            hi[r, nv:] = np.iinfo(hi.dtype).max
    words = (lo,) if hi is None else (hi, lo)
    got_c, got_n = native.compact_rows_native(words)
    # python reference: flatten valid, sort, RLE
    if hi is None:
        valid = lo != 0xFFFFFFFF
        codes = lo[valid].astype(np.uint64)
    else:
        valid = hi != np.iinfo(hi.dtype).max
        codes = (hi[valid].astype(np.uint64) << np.uint64(32)) | lo[valid].astype(
            np.uint64
        )
    codes = np.sort(codes)
    if codes.size == 0:
        assert got_c.size == 0
        return
    starts = np.concatenate([[True], codes[1:] != codes[:-1]])
    idx = np.flatnonzero(starts)
    want_n = np.diff(np.append(idx, codes.size)).astype(np.int64)
    assert np.array_equal(got_c, codes[idx])
    assert np.array_equal(got_n, want_n)


def test_compact_rows_native_empty_and_full():
    lo = np.full((4, 128), 0xFFFFFFFF, np.uint32)
    c, n = native.compact_rows_native((lo,))
    assert c.size == 0 and n.size == 0
    lo = np.tile(np.arange(128, dtype=np.uint32), (4, 1))  # no sentinels
    c, n = native.compact_rows_native((lo,))
    assert np.array_equal(c, np.arange(128, dtype=np.uint64))
    assert np.array_equal(n, np.full(128, 4, np.int64))


def test_parse_range_native_matches_python(tmp_path, make_dna):
    # Record-aligned byte ranges: native range parse == python range parse,
    # and the concatenation of all ranges covers every record exactly once.
    from dna_kmeres_parallel.parallel import multihost

    records = [(f">r{i} extra", make_dna(50 + 37 * i, invalid_frac=0.05)) for i in range(13)]
    path = _write(tmp_path, records, width=23)
    for parts in (1, 2, 3, 5):
        ranges = multihost.split_fasta_byte_ranges(path, parts)
        tot_seqs = 0
        tot_bases = 0
        for start, end in ranges:
            parsed = native.parse_fasta_native(path, byte_range=(start, end))
            py = multihost.read_range_records(path, start, end)
            assert parsed.n_seqs == len(py)
            assert [i.split()[0] for i in parsed.ids] == [
                r.id.split()[0] for r in py
            ]
            for j, r in enumerate(py):
                got = parsed.sequence_codes(j)
                want = codec.encode_bases(r.seq)
                assert np.array_equal(got, want)
            tot_seqs += parsed.n_seqs
            tot_bases += parsed.total_bases
        assert tot_seqs == len(records)
        assert tot_bases == sum(len(s) for _, s in records)


def test_parse_range_mid_record_ignores_partial(tmp_path, make_dna):
    # A range starting mid-record must not count the partial record (bases
    # before the first '>' in range are skipped).
    records = [(">a", "ACGT" * 30), (">b", "TTTT" * 25)]
    path = _write(tmp_path, records, width=16)
    size = __import__("os").path.getsize(path)
    parsed = native.parse_fasta_native(path, byte_range=(5, size))
    assert parsed.n_seqs == 1
    assert parsed.ids[0].startswith(">b")


@pytest.mark.parametrize("layout", ["single", "u16"])
def test_compact_rows_native_two_stage(layout):
    # Fan-in >= 384 streams per partition engages the hierarchical
    # (bundle -> runs) merge; duplicate-heavy codes so counts accumulate
    # across bundles.
    rng = np.random.default_rng(23)
    R, m = 1024, 64
    lo = np.sort(rng.integers(0, 1 << 9, (R, m)).astype(np.uint32), axis=1)
    if layout == "single":
        words = (lo,)
    else:
        hi = np.zeros((R, m), np.uint16)
        words = (hi, lo)
    got_c, got_n = native.compact_rows_native(words)
    codes = np.sort(lo.ravel().astype(np.uint64))
    starts = np.concatenate([[True], codes[1:] != codes[:-1]])
    idx = np.flatnonzero(starts)
    want_n = np.diff(np.append(idx, codes.size)).astype(np.int64)
    assert np.array_equal(got_c, codes[idx])
    assert np.array_equal(got_n, want_n)
    assert int(got_n.sum()) == R * m


def test_compact_rows_native_two_stage_sentinels():
    # Two-stage path with ragged sentinel tails across many rows.
    rng = np.random.default_rng(29)
    R, m = 768, 32
    lo = np.full((R, m), 0xFFFFFFFF, np.uint32)
    total = 0
    for r in range(R):
        nv = int(rng.integers(0, m + 1))
        lo[r, :nv] = np.sort(rng.integers(0, 1 << 8, nv).astype(np.uint32))
        total += nv
    got_c, got_n = native.compact_rows_native((lo,))
    valid = lo[lo != 0xFFFFFFFF].astype(np.uint64)
    assert int(got_n.sum()) == total == valid.size
    codes = np.sort(valid)
    if codes.size:
        starts = np.concatenate([[True], codes[1:] != codes[:-1]])
        idx = np.flatnonzero(starts)
        assert np.array_equal(got_c, codes[idx])
        assert np.array_equal(
            got_n, np.diff(np.append(idx, codes.size)).astype(np.int64)
        )


@pytest.mark.parametrize("k", [4, 13, 16, 21, 31])
@pytest.mark.parametrize("canonical", [False, True])
def test_count_sparse_host_native_matches_oracle(make_dna, k, canonical):
    """The C++ host engine (rolling encoder fused into the radix core)
    must be exact vs the NumPy oracle across key layouts and canonical."""
    from dna_kmeres_parallel.models import oracle
    from dna_kmeres_parallel.utils import codec

    if not native.available():
        pytest.skip("native lib unavailable")
    seqs = [make_dna(90 + 17 * i, invalid_frac=0.04) for i in range(4)]
    parts = []
    for i, s in enumerate(seqs):
        if i:
            parts.append(np.array([codec.INVALID_BASE], np.uint8))
        parts.append(codec.encode_bases(s))
    stream = np.concatenate(parts)
    codes, counts = native.count_sparse_host_native(stream, k, canonical)
    want = oracle.count_table_any_k(seqs, k, canonical)
    got = {codec.code_to_kmer(int(c), k): int(n) for c, n in zip(codes, counts)}
    assert got == want
    assert np.all(np.diff(codes.astype(np.int64)) > 0)


def test_count_sparse_host_native_edges():
    from dna_kmeres_parallel.utils import codec

    if not native.available():
        pytest.skip("native lib unavailable")
    # shorter than k
    c, n = native.count_sparse_host_native(codec.encode_bases("ACG"), 21)
    assert c.size == 0 and n.size == 0
    # all-invalid stream
    c, n = native.count_sparse_host_native(
        np.full(100, 0xFF, np.uint8), 13
    )
    assert c.size == 0
    # homopolymer: one distinct code, count L-k+1
    c, n = native.count_sparse_host_native(codec.encode_bases("A" * 50), 21)
    assert c.tolist() == [0] and n.tolist() == [30]


def test_parse_fasta_native_max_seqs_zero(tmp_path):
    """max_seqs=0 must yield zero records (review regression: the falsy
    zero was forwarded as 'no cap' to the C side)."""
    if not native.available():
        pytest.skip("native lib unavailable")
    p = tmp_path / "z.fasta"
    p.write_text(">a\nACGT\n>b\nGGTT\n")
    parsed = native.parse_fasta_native(str(p), max_seqs=0)
    assert parsed.n_seqs == 0 and parsed.total_bases == 0
    full = native.parse_fasta_native(str(p))
    assert full.n_seqs == 2


def test_format_f6_byte_parity():
    """Native %f formatter must produce byte-identical CSV bytes to the
    Python '%f' loop it replaces (reference format, main.cu:199-202) —
    including edge values and values outside [0, 1]."""
    from dna_kmeres_parallel import native

    rng = np.random.default_rng(3)
    vals = np.concatenate(
        [
            rng.random(50000, dtype=np.float32),
            np.array(
                [0.0, 1.0, 0.5, 0.9999995, 1e-7, 0.1234565, 2.5, -0.25,
                 123456.78],
                np.float32,
            ),
        ]
    )
    got = native.format_f6(vals)
    want = ("".join("%f\n" % v for v in vals)).encode("ascii")
    assert got == want
    assert native.format_f6(np.empty(0, np.float32)) == b""
