"""Randomized differential fuzz (fixed seeds for CI): native compactors
and merges vs NumPy groundtruth; the v2 packed encoder (interpret) vs
the XLA split-code encoder across random k/lengths/ownership/canonical/
minimizer draws. Heavier sweeps (200+300 checks / 24 encoder trials)
ran clean during r4; these keep a reduced always-on net."""

import jax.numpy as jnp
import numpy as np
import pytest

from dna_kmeres_parallel import native
from dna_kmeres_parallel.ops import sparse as sp


def test_fuzz_native_compact_and_merge():
    if not native.available():
        pytest.skip("native engine unavailable")
    rng = np.random.default_rng(99)
    for trial in range(40):
        k = int(rng.integers(13, 32))
        n = int(rng.integers(0, 20000))
        kbits = 2 * k
        space = 1 << min(kbits, 40)
        dup = rng.random() < 0.5
        pool = (
            rng.integers(0, space, max(n // 50, 1), dtype=np.uint64)
            if dup
            else None
        )
        codes = (
            pool[rng.integers(0, pool.shape[0], n)]
            if dup
            else rng.integers(0, space, n, dtype=np.uint64)
        )
        sent = rng.random(n) < rng.choice([0.0, 0.05, 0.9])
        if k <= 15:
            lo = np.where(
                sent, np.uint32(0xFFFFFFFF), codes.astype(np.uint32)
            )
            words = (lo,)
            true = lo[~sent].astype(np.uint64)
        else:
            hdt = np.uint16 if k <= 23 else np.uint32
            hs = hdt(0xFFFF) if k <= 23 else np.uint32(0xFFFFFFFF)
            hi = np.where(sent, hs, (codes >> np.uint64(32)).astype(hdt))
            lo = np.where(
                sent,
                np.uint32(0xFFFFFFFF),
                (codes & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            )
            words = (hi, lo)
            true = (
                hi[~sent].astype(np.uint64) << np.uint64(32)
            ) | lo[~sent].astype(np.uint64)
        got_c, got_n = native.compact_unsorted_native(words, kbits)
        want_c, want_n = (
            np.unique(true, return_counts=True)
            if true.size
            else (np.zeros(0, np.uint64), np.zeros(0, np.int64))
        )
        assert np.array_equal(got_c, want_c.astype(np.uint64)), (trial, k, n)
        assert np.array_equal(got_n, want_n.astype(np.int64)), (trial, k, n)
    for trial in range(20):
        tables = []
        for _ in range(int(rng.integers(1, 9))):
            c = np.unique(
                rng.integers(0, 1 << 40, int(rng.integers(0, 3000)),
                             dtype=np.uint64)
            )
            tables.append(
                (c, rng.integers(1, 100, c.shape[0]).astype(np.int64))
            )
        got = native.merge_tables_native(tables)
        allc = np.concatenate([t[0] for t in tables])
        alln = np.concatenate([t[1] for t in tables])
        want_c = np.unique(allc)
        want_n = np.zeros(want_c.shape[0], np.int64)
        np.add.at(want_n, np.searchsorted(want_c, allc), alln)
        assert np.array_equal(got[0], want_c), trial
        assert np.array_equal(got[1], want_n), trial


def test_fuzz_packed_encoder_vs_xla():
    # The encode program over the 2-bit packed wire format vs the split
    # codes computed straight from the bases, at random k, lengths,
    # invalid densities, ownership cuts and strand folding.
    from dna_kmeres_parallel.utils import codec

    rng = np.random.default_rng(7)
    for trial in range(8):
        k = int(rng.integers(2, 32))
        T = int(rng.integers(k + 1, 5000))
        Tp = -(-T // 16) * 16
        bases = rng.integers(0, 4, Tp).astype(np.uint8)
        bases[rng.random(Tp) < rng.choice([0.0, 0.03, 0.5])] = 0xFF
        bases[T:] = 0xFF
        n_own = int(rng.integers(0, T + 1))
        canonical = bool(rng.integers(0, 2))
        data, mask, _ = codec.pack_bases(bases)
        words = sp.encode_words_packed(
            jnp.asarray(data), jnp.asarray(mask), jnp.int32(n_own), k,
            canonical,
        )
        if len(words) == 1:
            lo = np.asarray(words[0])
            valid = lo != 0xFFFFFFFF
            codes = lo.astype(np.uint64)
        else:
            hi = np.asarray(words[0])
            lo = np.asarray(words[1])
            valid = hi != np.iinfo(hi.dtype).max
            codes = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(
                np.uint64
            )
        (rh, rl), rvalid = sp.rolling_codes_split(jnp.asarray(bases), k)
        if canonical:
            rh, rl = sp.canonicalize_split(rh, rl, k)
        rcodes = (
            np.asarray(rh).astype(np.uint64) << np.uint64(32)
        ) | np.asarray(rl).astype(np.uint64)
        rvalid = np.asarray(rvalid).copy()
        rvalid[n_own:] = False
        got = np.sort(codes[valid])
        want = np.sort(rcodes[rvalid])
        assert np.array_equal(got, want), (trial, k, T, n_own, canonical)


def test_fuzz_union_min_sums_vs_python(monkeypatch):
    """Union-indexed dense min-sums vs the pure-NumPy pairwise
    intersection, over random table STRUCTURES (not sequences): empty
    segments, singleton unions, counts straddling the int8 ship
    boundary (127/128), every sub-route. 40 trials, fixed seed."""
    from dna_kmeres_parallel.models import sparse_engine

    monkeypatch.setenv("KMER_DIST_UNION", "1")
    rng = np.random.default_rng(0xD15C0)
    for trial in range(40):
        S = int(rng.integers(2, 10))
        universe = np.unique(
            rng.integers(0, 60, size=40).astype(np.uint64)
        )
        parts, cnts = [], []
        offs = np.zeros(S + 1, dtype=np.int64)
        cmax = int(rng.choice([1, 3, 5, 127, 128, 300]))
        for i in range(S):
            n_i = int(rng.integers(0, min(12, universe.size) + 1))
            c = np.sort(
                rng.choice(universe, size=n_i, replace=False)
            ).astype(np.uint64)
            parts.append(c)
            cnts.append(
                rng.integers(1, cmax + 1, size=n_i).astype(np.int64)
            )
            offs[i + 1] = offs[i] + n_i
        codes = (
            np.concatenate(parts) if parts else np.zeros(0, np.uint64)
        )
        counts = (
            np.concatenate(cnts) if cnts else np.zeros(0, np.int64)
        )
        impl = rng.choice(["jnp", "int8", "pallas", "auto"])
        if impl == "pallas":
            monkeypatch.setenv("KMER_PALLAS_INTERPRET", "1")
        else:
            monkeypatch.delenv(
                "KMER_PALLAS_INTERPRET", raising=False
            )
        if impl != "auto":
            monkeypatch.setenv("KMER_UNION_IMPL", impl)
        else:
            monkeypatch.delenv("KMER_UNION_IMPL", raising=False)
        plan = sparse_engine.union_dense_plan(codes, counts, offs)
        if codes.size == 0:
            assert plan is None
            continue
        assert plan is not None, f"trial {trial}: plan refused"
        got = sparse_engine.union_dense_min_sums(
            codes, counts, offs, plan
        )
        want = sparse_engine.min_sum_pairs_python(codes, counts, offs)
        assert np.array_equal(got, want), (
            f"trial {trial}: impl={plan['impl']} cmax={cmax} S={S}"
        )


def test_fuzz_union_mxu_int8_boundary(monkeypatch):
    """Pin the int8-ship / t=128 threshold boundary ON the int8
    sub-route: counts in 65..127 bucket cmax to 128, which the default
    KMER_INT8_CMAX=64 would drop from the candidate set — raise the
    cap to 128 and force impl=int8 so the dtype choice (must be int32:
    int8 (>= 128) wraps to all-True) is actually executed (advisor r4
    finding: the generic fuzz never reached this path). 12 trials."""
    from dna_kmeres_parallel.models import sparse_engine

    monkeypatch.setenv("KMER_DIST_UNION", "1")
    monkeypatch.setenv("KMER_UNION_IMPL", "int8")
    monkeypatch.setenv("KMER_INT8_CMAX", "128")
    monkeypatch.delenv("KMER_PALLAS_INTERPRET", raising=False)
    rng = np.random.default_rng(0x1281281)
    for trial in range(12):
        S = int(rng.integers(2, 8))
        universe = np.unique(
            rng.integers(0, 50, size=30).astype(np.uint64)
        )
        parts, cnts = [], []
        offs = np.zeros(S + 1, dtype=np.int64)
        for i in range(S):
            n_i = int(rng.integers(1, min(10, universe.size) + 1))
            c = np.sort(
                rng.choice(universe, size=n_i, replace=False)
            ).astype(np.uint64)
            parts.append(c)
            cnts.append(
                rng.integers(65, 128, size=n_i).astype(np.int64)
            )
            offs[i + 1] = offs[i] + n_i
        codes = np.concatenate(parts)
        counts = np.concatenate(cnts)
        plan = sparse_engine.union_dense_plan(codes, counts, offs)
        assert plan is not None, f"trial {trial}: plan refused"
        assert plan["impl"] == "int8" and plan["cmax"] == 128, plan
        got = sparse_engine.union_dense_min_sums(
            codes, counts, offs, plan
        )
        want = sparse_engine.min_sum_pairs_python(codes, counts, offs)
        assert np.array_equal(got, want), f"trial {trial}"
