#!/usr/bin/env python
"""ASan/UBSan drive of every native entry point.

Build the sanitized library and run this under LD_PRELOAD:

    g++ -O1 -g -march=native -std=c++17 -pthread -fPIC -shared \
        -fsanitize=address,undefined -fno-sanitize-recover=all \
        -o bench_out/libfasta_asan.so dna_kmeres_parallel/native/fastaparse.cpp -lz
    LD_PRELOAD=$(gcc -print-file-name=libasan.so) ASAN_OPTIONS=detect_leaks=0 \
        python scripts/asan_drive.py

Covers: rolling host engine, radix compactor (all widths + sentinel
densities + empty/edge sizes), row merge (ladder + tree fan-ins),
table merge, parser, packers, dense counter, sorted compactors.
"""
import ctypes, sys
import numpy as np

os.makedirs("bench_out", exist_ok=True)
lib = ctypes.CDLL("bench_out/libfasta_asan.so")
u8p = ctypes.POINTER(ctypes.c_uint8)
u32p = ctypes.POINTER(ctypes.c_uint32)
u64p = ctypes.POINTER(ctypes.c_uint64)
i64p = ctypes.POINTER(ctypes.c_int64)

rng = np.random.default_rng(0)

# host sparse engine across k and shapes (rolling + radix + RLE)
lib.kp_count_windows_valid.restype = ctypes.c_int64
lib.kp_count_sparse_host.restype = ctypes.c_int64
for k in (1, 2, 13, 16, 21, 31):
    for n in (0, 1, k - 1, k, k + 1, 1000, 100003):
        stream = rng.integers(0, 6, n, dtype=np.uint8)  # some invalid (4,5)
        stream[stream >= 4] = 0xFF
        s = np.ascontiguousarray(stream)
        cap = lib.kp_count_windows_valid(s.ctypes.data_as(u8p), n, k)
        oc = np.zeros(max(cap, 1), np.uint64)
        on = np.zeros(max(cap, 1), np.int64)
        for canon in (0, 1):
            w = lib.kp_count_sparse_host(
                s.ctypes.data_as(u8p), n, k, canon,
                oc.ctypes.data_as(u64p), on.ctypes.data_as(i64p))
            assert 0 <= w <= max(cap, 1) or (cap == 0 and w == 0), (k, n, w, cap)
print("host engine OK", flush=True)

# compact_unsorted across widths + sentinel densities
lib.kp_count_valid.restype = ctypes.c_int64
lib.kp_compact_unsorted.restype = ctypes.c_int64
for k, hw in ((13, 0), (21, 2), (31, 4)):
    kbits = 2 * k
    for n in (0, 1, 7, 4096, 100001):
        codes = rng.integers(0, 1 << kbits, n, dtype=np.uint64)
        sent = rng.random(n) < 0.3
        lo = np.where(sent, np.uint32(0xFFFFFFFF), (codes & 0xFFFFFFFF).astype(np.uint32))
        lo = np.ascontiguousarray(lo)
        if hw == 0:
            lo = np.ascontiguousarray(np.where(sent, np.uint32(0xFFFFFFFF), codes.astype(np.uint32)))
            hi_ptr = None
        elif hw == 2:
            hi = np.ascontiguousarray(np.where(sent, np.uint64(0xFFFF), codes >> np.uint64(32)).astype(np.uint16))
            hi_ptr = hi.ctypes.data_as(ctypes.c_void_p)
        else:
            hi = np.ascontiguousarray(np.where(sent, np.uint64(0xFFFFFFFF), codes >> np.uint64(32)).astype(np.uint32))
            hi_ptr = hi.ctypes.data_as(ctypes.c_void_p)
        cap = lib.kp_count_valid(hi_ptr, hw, lo.ctypes.data_as(u32p), n, kbits)
        oc = np.zeros(max(cap, 1), np.uint64)
        on = np.zeros(max(cap, 1), np.int64)
        w = lib.kp_compact_unsorted(hi_ptr, hw, lo.ctypes.data_as(u32p), n, kbits,
                                    oc.ctypes.data_as(u64p), on.ctypes.data_as(i64p))
        assert w <= max(cap, 1), (k, n, w, cap)
print("compact_unsorted OK", flush=True)

# compact_rows (ladder + loser tree) across fan-ins
lib.kp_rows_valid.restype = ctypes.c_int64
lib.kp_compact_rows.restype = ctypes.c_int64
import os
for rows, m in ((1, 128), (3, 64), (700, 256), (64, 2048)):
    n = rows * m
    codes = np.sort(rng.integers(0, 1 << 42, (rows, m), dtype=np.uint64), axis=1)
    # sentinel tails
    tail = rng.integers(0, m, rows)
    for r in range(rows):
        codes[r, m - tail[r]:] = (0xFFFF << 32) | 0xFFFFFFFF
    hi = np.ascontiguousarray((codes >> 32).astype(np.uint16))
    lo = np.ascontiguousarray((codes & 0xFFFFFFFF).astype(np.uint32))
    cap = lib.kp_rows_valid(hi.ctypes.data_as(ctypes.c_void_p), 2, lo.ctypes.data_as(u32p), rows, m)
    oc = np.zeros(max(cap, 1), np.uint64)
    on = np.zeros(max(cap, 1), np.int64)
    w = lib.kp_compact_rows(hi.ctypes.data_as(ctypes.c_void_p), 2, lo.ctypes.data_as(u32p), rows, m,
                            oc.ctypes.data_as(u64p), on.ctypes.data_as(i64p))
    assert 0 <= w <= max(cap, 1)
print("compact_rows OK", flush=True)

# merge_tables
lib.kp_merge_tables.restype = ctypes.c_int64
ts = []
for i in range(5):
    c = np.unique(rng.integers(0, 1 << 40, 5000 + i, dtype=np.uint64))
    ts.append((c, np.ones(c.size, np.int64)))
codes_arr = (ctypes.c_void_p * 5)(*[t[0].ctypes.data for t in ts])
cnts_arr = (ctypes.c_void_p * 5)(*[t[1].ctypes.data for t in ts])
lens = np.array([t[0].size for t in ts], np.int64)
tot = int(lens.sum())
oc = np.zeros(tot, np.uint64); on = np.zeros(tot, np.int64)
w = lib.kp_merge_tables(5, codes_arr, cnts_arr, lens.ctypes.data_as(i64p),
                        oc.ctypes.data_as(u64p), on.ctypes.data_as(i64p))
assert 0 < w <= tot
print("merge_tables OK", flush=True)
print("ASAN DRIVE COMPLETE", flush=True)

# parser + packers + dense counter + sorted compactors
class _KpFasta(ctypes.Structure):
    _fields_ = [
        ("n_seqs", ctypes.c_int64), ("stream_len", ctypes.c_int64),
        ("stream", ctypes.POINTER(ctypes.c_uint8)),
        ("offsets", ctypes.POINTER(ctypes.c_int64)),
        ("lengths", ctypes.POINTER(ctypes.c_int64)),
        ("ids", ctypes.POINTER(ctypes.c_char)), ("ids_len", ctypes.c_int64),
        ("total_bases", ctypes.c_int64), ("invalid_bases", ctypes.c_int64),
    ]

lib.kp_parse_fasta_range.restype = ctypes.c_int
with open("bench_out/asan.fasta", "w") as f:
    for i in range(5):
        f.write(f">s{i}\n")
        f.write("".join(np.random.default_rng(i).choice(list("ACGTN"), 173)) + "\n\n")
out = ctypes.POINTER(_KpFasta)()
rc = lib.kp_parse_fasta_range(b"bench_out/asan.fasta", 0, -1, 0, ctypes.byref(out))
assert rc == 0 and out.contents.n_seqs == 5
stream = np.ctypeslib.as_array(out.contents.stream, shape=(int(out.contents.stream_len),)).copy()
lib.kp_free_fasta(out)
print("parser OK", flush=True)

n = stream.shape[0]
packed = np.zeros((n + 3) // 4, np.uint8)
maskb = np.zeros((n + 7) // 8, np.uint8)
lib.kp_pack_2bit(stream.ctypes.data_as(u8p), n, packed.ctypes.data_as(u8p), maskb.ctypes.data_as(u8p))
unp = np.zeros(n, np.uint8)
lib.kp_unpack_2bit(packed.ctypes.data_as(u8p), maskb.ctypes.data_as(u8p), n, unp.ctypes.data_as(u8p))
assert np.array_equal(np.where(unp == 0xFF, 0xFF, unp), np.where(stream > 3, 0xFF, stream))
hist = np.zeros(4 ** 5, np.int64)
lib.kp_count_dense(stream.ctypes.data_as(u8p), n, 5, 0, 0, hist.ctypes.data_as(i64p))
print("pack/dense OK", flush=True)

# sorted compactors (kp_compact_sorted / kp_count_distinct / kp_compact_starts)
lib.kp_count_distinct.restype = ctypes.c_int64
lib.kp_compact_sorted.restype = ctypes.c_int64
lib.kp_compact_starts.restype = ctypes.c_int64
for n2 in (0, 1, 100000):
    codes = np.sort(rng.integers(0, 1 << 42, n2, dtype=np.uint64))
    sent_tail = n2 // 5
    if sent_tail:
        codes[-sent_tail:] = (0xFFFF << 32) | 0xFFFFFFFF
        codes = np.sort(codes)
    hi = np.ascontiguousarray((codes >> 32).astype(np.uint16))
    lo = np.ascontiguousarray((codes & 0xFFFFFFFF).astype(np.uint32))
    m = lib.kp_count_distinct(hi.ctypes.data_as(ctypes.c_void_p), 2, lo.ctypes.data_as(u32p), n2)
    oc = np.zeros(max(m, 1), np.uint64); on = np.zeros(max(m, 1), np.int64)
    w = lib.kp_compact_sorted(hi.ctypes.data_as(ctypes.c_void_p), 2, lo.ctypes.data_as(u32p), n2,
                              oc.ctypes.data_as(u64p), on.ctypes.data_as(i64p))
    assert w == m
    starts = np.ones(max(n2, 1), np.uint8)
    w2 = lib.kp_compact_starts(hi.ctypes.data_as(ctypes.c_void_p), 2, lo.ctypes.data_as(u32p),
                               starts.ctypes.data_as(u8p), n2,
                               np.zeros(max(n2,1), np.uint64).ctypes.data_as(u64p),
                               np.zeros(max(n2,1), np.int64).ctypes.data_as(i64p))
    assert 0 <= w2 <= max(n2, 1)
print("sorted compactors OK", flush=True)
print("ASAN FULL DRIVE COMPLETE", flush=True)
