"""Self-calibrating routing constants.

The distance and transfer routing gates run on time models
(ops/distance.py, sparse_engine's host-rate and H2D defaults). This
module measures the machine it runs on, once per backend fingerprint,
and persists the result beside the XLA compile cache (utils/cache.py):

- **link calibration** (automatic, cheap — no compiles): H2D and D2H
  bytes/sec via a two-size differential (the fixed dispatch+fetch
  roundtrip cancels), plus the small-fetch roundtrip floor that bounds
  any device job. Runs the first time a gate asks on an accelerator;
  cached after.
- **compute calibration** (explicit — `kmers calibrate`): measured
  pair rates for the int8 threshold / Pallas (min,+) / XLA (min,+)
  routes and the native host two-pointer, stored as the same model
  constants the built-in defaults provide.

Consumers read through ``get_calibration()`` and fall back to the
built-in constants for any missing key.

Env:
- KMER_CALIBRATE=0 disables measurement (cached files still load);
  =1 forces link measurement on the CPU too (tests).
- KMER_CALIBRATION_FILE points at an explicit calibration JSON
  (tests inject fakes to pin gate decisions both ways).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

_CAL: dict | None = None  # per-process cache
_CAL_KEY: str | None = None


def cache_dir() -> str:
    from dna_kmeres_parallel.utils.cache import cache_dir as _dir

    return _dir()


def backend_fingerprint() -> str:
    """Stable per-backend identity: platform + device kind + device
    count (link rates differ between one-card and multi-card hosts)."""
    import jax

    d = jax.devices()[0]
    kind = getattr(d, "device_kind", "?")
    return (
        f"{d.platform}_{kind}_{len(jax.devices())}dev".replace(" ", "-")
        .replace("/", "-")
    )


def _cal_path() -> str:
    explicit = os.environ.get("KMER_CALIBRATION_FILE")
    if explicit:
        return explicit
    return os.path.join(
        cache_dir(), f"calibration_{backend_fingerprint()}.json"
    )


def reset() -> None:
    """Drop the per-process cache (tests)."""
    global _CAL, _CAL_KEY
    _CAL = None
    _CAL_KEY = None


def measure_link(size_bytes: int = 16 << 20, reps: int = 2) -> dict:
    """H2D/D2H bytes/sec + small-fetch roundtrip, two-size differential.

    Timing ends in a host fetch (np.asarray / int()), so every transfer
    has landed when the clock stops."""
    import jax
    import jax.numpy as jnp

    n_hi = max(size_bytes // 4, 1 << 16)
    n_lo = max(n_hi // 4, 1 << 14)
    rng = np.random.default_rng(0xCA1)

    def h2d_once(n: int) -> float:
        a = rng.integers(0, 1 << 31, size=n, dtype=np.int32)
        t0 = time.perf_counter()
        x = jax.device_put(a)
        # Consume via a scalar fetch so the transfer provably landed.
        int(np.asarray(jnp.sum(x[:: max(n // 128, 1)], dtype=jnp.int32)))
        return time.perf_counter() - t0

    def d2h_once(n: int) -> float:
        a = rng.integers(0, 1 << 31, size=n, dtype=np.int32)
        x = jax.device_put(a)
        int(np.asarray(jnp.sum(x[:: max(n // 128, 1)], dtype=jnp.int32)))
        t0 = time.perf_counter()
        b = np.asarray(x)
        dt = time.perf_counter() - t0
        assert b.shape[0] == n
        return dt

    def best(fn, n):
        return min(fn(n) for _ in range(reps))

    h2d_hi, h2d_lo = best(h2d_once, n_hi), best(h2d_once, n_lo)
    d2h_hi, d2h_lo = best(d2h_once, n_hi), best(d2h_once, n_lo)
    # Small-fetch roundtrip: the dispatch+fetch floor every device job
    # pays at least once.
    rt = []
    for _ in range(3):
        a = rng.integers(0, 1 << 31, size=256, dtype=np.int32)
        t0 = time.perf_counter()
        int(np.asarray(jnp.sum(jax.device_put(a), dtype=jnp.int32)))
        rt.append(time.perf_counter() - t0)
    dbytes = (n_hi - n_lo) * 4
    out = {
        "fingerprint": backend_fingerprint(),
        "roundtrip_s": min(rt),
    }
    if h2d_hi > h2d_lo:
        out["h2d_bps"] = dbytes / (h2d_hi - h2d_lo)
    if d2h_hi > d2h_lo:
        out["d2h_bps"] = dbytes / (d2h_hi - d2h_lo)
    return out


def measure_compute() -> dict:
    """Measured pair rates for the dense (min,+) routes and the native
    host two-pointer — the explicit `kmers calibrate` step (one
    compile per route, cached by the XLA compile cache).

    Each device rate is a TWO-SIZE differential with scalar-sum
    consumption: differencing two compute sizes cancels the
    dispatch+fetch roundtrip (the gates model link legs separately), and
    a non-positive delta drops the key (built-in constant fallback).
    Fits the single dominant constant of each ops/distance time model at
    wide shapes (the per-pair overhead terms stay fixed — they only
    matter at skinny shapes where the routes are within noise)."""
    import jax.numpy as jnp

    from dna_kmeres_parallel.ops import distance as dist_ops
    from dna_kmeres_parallel.ops import distance_pallas, runtime

    rng = np.random.default_rng(0xCA2)
    out: dict = {}

    def rate(fn_big, fn_small, work_delta) -> float | None:
        """median of 3 paired (big - small) wall deltas, through a
        device scalar-sum fetch; None when jitter swamps the delta."""
        consume = lambda f: int(
            np.asarray(jnp.sum(f(), dtype=jnp.int32))
        )
        consume(fn_big)  # warm/compile
        consume(fn_small)
        deltas = []
        for _ in range(3):
            t0 = time.perf_counter()
            consume(fn_big)
            tb = time.perf_counter() - t0
            t0 = time.perf_counter()
            consume(fn_small)
            ts = time.perf_counter() - t0
            deltas.append(tb - ts)
        d = float(np.median(deltas))
        return work_delta / d if d > 0 else None

    be = runtime.backend()
    # Threshold probe: marginal-threshold differential at the model's
    # fit shape (S=2048, 64K bins). The per-threshold cost the model's
    # single constant amortizes is the matmul PLUS the [S, bins]
    # threshold-plane builds, so probing at the shape the gates decide
    # over keeps the fitted constant meaning what the model spends it
    # as. The CPU (tests) uses small shapes.
    S, bins = (2048, 65536) if be.accelerator else (256, 1024)
    cmax_hi = 8
    counts = jnp.asarray(
        rng.integers(0, cmax_hi + 1, size=(S, bins), dtype=np.int32)
    )
    r = rate(
        lambda: dist_ops.min_sum_matrix_int8(counts, cmax_hi),
        lambda: dist_ops.min_sum_matrix_int8(counts, 2),
        S * S * bins * (cmax_hi - 2),
    )
    if r:
        out["int8_macs_per_sec"] = r
    Sb = 1024 if be.accelerator else 256
    big = jnp.asarray(
        rng.integers(0, 64, size=(Sb, bins), dtype=np.int32)
    )
    r = rate(
        lambda: dist_ops.min_sum_matrix(big),
        lambda: dist_ops.min_sum_matrix(big[: Sb // 4]),
        (Sb * Sb - (Sb // 4) ** 2) * bins,
    )
    if r:
        out["dense_bin_pairs_per_sec"] = r
    if be.kernel == "compiled":
        tb = jnp.asarray(
            rng.integers(0, 64, size=(2048, 16384), dtype=np.int32)
        )
        r = rate(
            lambda: distance_pallas.min_sum_matrix_pallas(tb),
            lambda: distance_pallas.min_sum_matrix_pallas(tb[:512]),
            (2048 * 2049 / 2 - 512 * 513 / 2) * 16384,
        )
        if r:
            out["tri_bin_pairs_per_sec"] = r
    from dna_kmeres_parallel import native

    if native.available():
        # Host two-pointer: per-thread entry-pairs/sec (the threaded
        # engine's scaling unit) on ~1e3-entry tables — the size of a
        # 1-Kbase read's table, where the union gate decides (larger
        # tables fall out of cache and fit a several-fold lower rate).
        Sh, table = 256, 1024
        codes = np.sort(
            rng.choice(1 << 40, size=(Sh, table), replace=False), axis=1
        ).astype(np.uint64)
        cnts = rng.integers(1, 8, size=(Sh, table)).astype(np.int64)
        offs = np.arange(Sh + 1, dtype=np.int64) * table
        t0 = time.perf_counter()
        native.min_sum_pairs_native(
            codes.reshape(-1), cnts.reshape(-1), offs
        )
        dt = time.perf_counter() - t0
        threads = max(os.cpu_count() or 1, 1)
        pairs = Sh * (Sh - 1) / 2
        out["sparse_entry_pairs_per_sec_per_thread"] = (
            pairs * table / dt / threads
        )
    return out


def _should_measure_link() -> bool:
    flag = os.environ.get("KMER_CALIBRATE")
    if flag == "0":
        return False
    if flag == "1":
        return True
    from dna_kmeres_parallel.ops import runtime

    return runtime.backend().accelerator


def get_calibration() -> dict:
    """The effective calibration dict ({} = built-in constants only).

    Loads the persisted per-backend file when present; otherwise, on an
    accelerator (or KMER_CALIBRATE=1), measures the LINK once
    (seconds) and persists. Compute rates are only ever added by the
    explicit `kmers calibrate` command."""
    global _CAL, _CAL_KEY
    path = _cal_path()
    if _CAL is not None and _CAL_KEY == path:
        return _CAL
    cal: dict = {}
    if os.path.exists(path):
        try:
            with open(path, "r", encoding="ascii") as f:
                cal = json.load(f)
        except Exception:
            cal = {}
    elif _should_measure_link():
        try:
            cal = measure_link()
            save_calibration(cal)
        except Exception:
            cal = {}
    _CAL = cal
    _CAL_KEY = path
    return cal


def save_calibration(cal: dict) -> str:
    path = _cal_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="ascii") as f:
        json.dump(cal, f, indent=1)
    os.replace(tmp, path)
    reset()
    return path
