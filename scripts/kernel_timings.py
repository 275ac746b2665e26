"""Time each device kernel of the count and distance paths on the card.

Compares the Pallas-Triton (min,+) kernel with XLA's plain
``ops.distance.min_sum_matrix`` (and the int8 threshold route), the XLA
encoder on the packed wire format, and the XLA histogram routes, at the
shapes PERF.md reports. Every timing ends in ``block_until_ready``;
compile time is reported apart from the steady-state median.

    python scripts/kernel_timings.py [--quick] [--out chiprun_out/kernel_timings.json]

Needs a GPU: it exits non-zero on any other platform.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dna_kmeres_parallel.ops import distance as dist_ops  # noqa: E402
from dna_kmeres_parallel.ops import distance_pallas  # noqa: E402
from dna_kmeres_parallel.ops import encode as encode_ops  # noqa: E402
from dna_kmeres_parallel.ops import histogram as hist_ops  # noqa: E402
from dna_kmeres_parallel.ops import sparse as sparse_ops  # noqa: E402
from dna_kmeres_parallel.utils import codec  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def timed(fn, *args, reps=5):
    """(compile_plus_first_s, median_steady_s, result) of fn(*args)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts)), out


def record(results, name, fn, *args, reps=5, extra=None):
    try:
        first, steady, out = timed(fn, *args, reps=reps)
    except Exception as e:  # report the failure, keep measuring the rest
        line = {"name": name, "error": f"{type(e).__name__}: {str(e)[:400]}"}
        out = None
    else:
        line = {"name": name, "first_s": first, "steady_s": steady}
        if extra:
            line.update(extra(steady))
    results.append(line)
    print(json.dumps(line), flush=True)
    return out


def min_sum_phase(results, S, bins, configs, seed):
    rng = np.random.default_rng(seed)
    counts = jnp.asarray(rng.integers(0, 200, (S, bins), dtype=np.int32))
    pairs = S * (S - 1) / 2

    def rate(steady):
        return {"pairs_per_s": pairs / steady,
                "bin_pairs_per_s": pairs * bins / steady}

    ref = record(results, f"xla_min_sum S={S} bins={bins}",
                 lambda c: dist_ops.min_sum_matrix(c), counts, reps=3,
                 extra=rate)
    for bm, bn, bk, nw, ns in configs:
        fn = (lambda c, bm=bm, bn=bn, bk=bk, nw=nw, ns=ns:
              distance_pallas.min_sum_matrix_pallas(
                  c, bm=bm, bn=bn, bk=bk, num_warps=nw, num_stages=ns))
        got = record(results,
                     f"triton_tri S={S} bins={bins} bm={bm} bn={bn} bk={bk} "
                     f"warps={nw} stages={ns}",
                     fn, counts, reps=3, extra=rate)
        if got is not None and ref is not None:
            ok = bool(np.array_equal(np.asarray(got), np.asarray(ref)))
            results[-1]["exact"] = ok
            print(json.dumps({"exact": ok}), flush=True)
    small = jnp.asarray(rng.integers(0, 5, (S, bins), dtype=np.int32))
    record(results, f"int8_threshold cmax=4 S={S} bins={bins}",
           lambda c: dist_ops.min_sum_matrix_int8(c, 4), small, reps=3,
           extra=rate)


def packed_batch(n_bases, seed):
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, n_bases, dtype=np.uint8)
    bases[rng.random(n_bases) < 0.001] = codec.INVALID_BASE
    data, mask, _ = codec.pack_bases(bases)
    return jnp.asarray(data), jnp.asarray(mask)


def encoder_phase(results, n_bases, seed):
    data, mask = packed_batch(n_bases, seed)
    for k in (11, 21, 31):
        n_own = jnp.int32(n_bases - k + 1)
        out_bytes = 4 if k <= 15 else (6 if k <= 23 else 8)
        moved = n_bases * (0.25 + 0.125) + n_bases * out_bytes

        def extra(steady, moved=moved):
            return {"gbase_per_s": n_bases / steady / 1e9,
                    "bytes_moved": moved,
                    "hbm_share": moved / steady / HBM_BYTES_PER_S}

        record(results, f"xla_encode_packed k={k} bases={n_bases}",
               lambda d, m, k=k, n_own=n_own: sparse_ops.encode_words_packed(
                   d, m, n_own, k, False),
               data, mask, extra=extra)


def histogram_phase(results, n_bases, seed):
    data, mask = packed_batch(n_bases, seed)
    impls = {"scatter": hist_ops.histogram_scatter,
             "sorted": hist_ops.histogram_sorted}
    for k in (4, 5, 6, 7, 8):
        bins = 4**k
        want = None
        for name, impl in impls.items():
            @jax.jit
            def prog(d, m, impl=impl, k=k, bins=bins):
                codes, valid = encode_ops.rolling_codes(
                    encode_ops.unpack_stream(d, m), k)
                return impl(codes, valid, bins)

            got = record(
                results, f"stream_hist {name} k={k} bases={n_bases}",
                prog, data, mask,
                extra=lambda s: {"gbase_per_s": n_bases / s / 1e9})
            if got is not None:
                got = np.asarray(got)
                if want is None:
                    want = got
                results[-1]["agrees"] = bool(np.array_equal(got, want))


def counts_matrix_phase(results, seed):
    rng = np.random.default_rng(seed)
    for k, S, L in ((3, 8192, 16384), (4, 8192, 16384), (8, 2048, 1024)):
        bins = 4**k
        grid = jnp.asarray(rng.integers(0, 4, (S, L), dtype=np.uint8))

        @jax.jit
        def prog(g, k=k, bins=bins):
            codes, valid = encode_ops.rolling_codes(g, k)
            return hist_ops.counts_matrix(codes, valid, bins)

        record(results, f"counts_matrix scatter k={k} S={S} L={L}", prog,
               grid, extra=lambda s: {"gbase_per_s": S * L / s / 1e9})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="one (min,+) tile config, for a compile check")
    ap.add_argument("--only", default="min_sum,encode,hist,counts_matrix")
    ap.add_argument("--out", default="chiprun_out/kernel_timings.json")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU (platform {dev.platform})", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    head = {"nvidia_smi": smi.stdout.strip(), "device_kind": dev.device_kind,
            "jax": jax.__version__}
    print(json.dumps(head), flush=True)
    results: list[dict] = [head]
    only = set(args.only.split(","))
    if "min_sum" in only:
        d = distance_pallas
        configs = [(d.BM, d.BN, d.BK, d.NUM_WARPS, d.NUM_STAGES)]
        if not args.quick:
            configs += [(32, 32, 8, 4, 2), (64, 64, 8, 4, 2),
                        (64, 128, 16, 4, 3), (128, 128, 8, 8, 2)]
        min_sum_phase(results, 8192, 64, configs, args.seed)
        min_sum_phase(results, 2048, 65536, configs[:3], args.seed)
    if "encode" in only:
        encoder_phase(results, 16 << 20, args.seed)
    if "hist" in only:
        histogram_phase(results, 16 << 20, args.seed)
    if "counts_matrix" in only:
        counts_matrix_phase(results, args.seed)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
