#!/usr/bin/env python
"""Benchmark: single-card k-mer counting throughput.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Headline metric: giga-bases/second/chip through the device count path at
k=21 — BASELINE.json's north-star configuration ("Giga-bases/sec/chip at
k=21"), served by the no-device-sort route (the XLA encode program alone;
the host radix compactor builds the table — KmerConfig.device_sort;
BENCH_DEVICE_SORT=1 measures the row-sorted fallback). The reference
publishes no throughput numbers (BASELINE.md: "published": {}); the
baseline denominator is 1.0 Gbase/s, a generous estimate of an A100-class
CUDA k-mer counter (Gerbil-era GPU counters sustain ~0.5-1.5 Gbase/s), so
vs_baseline == achieved Gbase/s. BASELINE.json's stated target is >=10x.

BENCH_K <= 8 instead measures the dense-histogram path (config-1 shapes);
k >= 9 mirrors production routing through the sparse path. Every timing
ends in block_until_ready. Details (compile time, device, exactness
check) go to stderr.
"""

import json
import os
import sys


def main() -> int:
    import jax

    from dna_kmeres_parallel.utils.cache import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        # A device benchmark measures the card; it never falls back.
        print(f"no GPU (JAX platform {jax.devices()[0].platform!r})",
              file=sys.stderr)
        return 2
    enable_compile_cache()

    from dna_kmeres_parallel.models.benchmarks import (
        run_count_bench,
        run_distance_bench,
        run_sparse_bench,
    )

    # BENCH_METRIC=distance: pairwise-distance throughput (the reference's
    # step-2, kernels.h:85-109, as one tiled (min,+) program). BENCH_K
    # selects the band; low-multiplicity counts route the int8 threshold
    # matmuls. BENCH_DIST_IMPL=jnp|pallas|int8 forces a path for A/B.
    # vs_baseline is
    # value / 1e6 pairs/s — an indicative denominator (the reference's own
    # per-query-launch step 2 is launch-latency-bound; it publishes no
    # pairs/s).
    if os.environ.get("BENCH_METRIC") == "distance":
        k = int(os.environ.get("BENCH_K", "8"))
        n_seqs = int(os.environ.get("BENCH_DIST_SEQS", "2048"))
        seq_len = int(os.environ.get("BENCH_DIST_LEN", "1024"))
        impl = os.environ.get("BENCH_DIST_IMPL", "auto")
        report = run_distance_bench(
            n_seqs=n_seqs, seq_len=seq_len, k=k, impl=impl
        )
        print(json.dumps(report), file=sys.stderr)
        value = report["pairs_per_sec"]
        print(
            json.dumps(
                {
                    "metric": f"distance_pairs_k{k}",
                    "value": value,
                    "unit": "pairs/s",
                    "vs_baseline": round(value / 1e6, 4),
                }
            )
        )
        return 0

    # BENCH_METRIC=realistic: end-to-end streamed count over a
    # sequencing-shaped input (reads at BENCH_COVERAGE-x coverage of one
    # synthetic genome — high k-mer duplication, the distribution the
    # adversarial all-distinct default cannot exercise) through the
    # production StreamingCounter with compact routing BENCH_COMPACT
    # (default 'auto': the EWMA race picks the route). Records
    # END-TO-END Gbase/s (host + D2H + device), not device-only.
    if os.environ.get("BENCH_METRIC") == "realistic":
        import time

        import numpy as np

        from dna_kmeres_parallel.models.pipeline import StreamingCounter
        from dna_kmeres_parallel.utils import datagen
        from dna_kmeres_parallel.utils.config import KmerConfig

        k = int(os.environ.get("BENCH_K", "21"))
        total = int(os.environ.get("BENCH_BASES", str(64 << 20)))
        coverage = float(os.environ.get("BENCH_COVERAGE", "30"))
        compact = os.environ.get("BENCH_COMPACT", "auto")
        path = os.environ.get(
            "BENCH_REALISTIC_PATH",
            os.path.join(
                os.path.dirname(os.path.abspath(__file__)),
                "bench_out",
                f"realistic_{total}.fasta",
            ),
        )
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if not (
            os.path.exists(path) and os.path.getsize(path) >= total
        ):
            datagen.realistic_fasta(
                path,
                genome_len=max(int(total / coverage), 10_000),
                coverage=coverage,
                read_len=150,
                seed=11,
            )
        sc = StreamingCounter(
            KmerConfig(
                k=k,
                compact=compact,
                batch_bases=int(os.environ.get("BENCH_BATCH", str(16 << 20))),
            )
        )
        t0 = time.perf_counter()
        res = sc.run(path)
        wall = time.perf_counter() - t0
        rep = sc.metrics.report()
        # k <= 12 streams return the dense CountResult (hist), k >= 13
        # the sparse one (codes/counts) — normalize.
        if hasattr(res, "codes"):
            total_kmers = int(res.counts.sum())
            distinct = int(res.codes.shape[0])
        else:
            total_kmers = int(res.hist.sum())
            distinct = int(np.count_nonzero(res.hist))
        # Exactness spot-check: total windows must equal the per-read sum
        # of valid windows, which the native host engine recomputes
        # independently from the same file.
        from dna_kmeres_parallel import native

        exact = None
        if native.available():
            parsed = native.parse_fasta_native(path)
            _, host_counts = native.count_sparse_host_native(
                parsed.stream, k, False
            )
            exact = int(host_counts.sum()) == total_kmers and (
                distinct == host_counts.shape[0]
            )
        value = round(res.total_bases / wall / 1e9, 4)
        print(
            json.dumps(
                {
                    "bench": "realistic",
                    "k": k,
                    "coverage": coverage,
                    "compact": compact,
                    "total_bases": int(res.total_bases),
                    "distinct": distinct,
                    "dup_factor": round(
                        float(total_kmers) / max(distinct, 1), 2
                    ),
                    "wall_s": round(wall, 2),
                    "exact_vs_host_engine": exact,
                    "counters": rep["counters"],
                }
            ),
            file=sys.stderr,
        )
        print(
            json.dumps(
                {
                    "metric": f"realistic_e2e_k{k}",
                    "value": value,
                    "unit": "Gbase/s/device",
                    "vs_baseline": round(value / 1.0, 4),
                }
            )
        )
        return 0 if exact is not False else 1

    k = int(os.environ.get("BENCH_K", "21"))
    total = int(os.environ.get("BENCH_BASES", str(64 << 20)))
    batch = int(os.environ.get("BENCH_BATCH", str(16 << 20)))
    row_len = int(os.environ.get("BENCH_ROW_LEN", "2048"))
    # Device-sort routing mirrors production (KmerConfig.device_sort=None):
    # with the native radix compactor present the device runs the encode
    # alone. BENCH_DEVICE_SORT=1/0 forces either route.
    ds_env = os.environ.get("BENCH_DEVICE_SORT", "auto")
    if ds_env == "auto":
        from dna_kmeres_parallel.models.sparse_engine import (
            resolve_device_sort,
        )
        from dna_kmeres_parallel.utils.config import KmerConfig

        device_sort = resolve_device_sort(KmerConfig(k=max(k, 13)))
    else:
        device_sort = ds_env == "1"

    # k <= 8: the dense histogram (production routing); k >= 9 routes
    # through the sparse path in production (engine.py), so the bench
    # mirrors that.
    if k <= 8:
        report = run_count_bench(
            k=k, canonical=False, total_bases=total, batch_bases=batch
        )
    else:
        report = run_sparse_bench(
            k=k,
            canonical=False,
            total_bases=total,
            batch_bases=batch,
            row_len=row_len,
            device_sort=device_sort,
        )
    print(json.dumps(report), file=sys.stderr)

    exact = report["windows_counted"] == report["windows_expected"]
    if not exact:
        print("WINDOW COUNT MISMATCH — benchmark invalid", file=sys.stderr)

    value = report["gbases_per_sec"]
    baseline_gbps = 1.0
    extra = {}
    # The graded config-2 band — canonical k=11 — rides along in the
    # headline JSON line. BENCH_CANONICAL=0 skips it.
    if k >= 9 and os.environ.get("BENCH_CANONICAL") != "0":
        rep11 = run_sparse_bench(
            k=11,
            canonical=True,
            total_bases=total,
            batch_bases=batch,
            row_len=row_len,
            device_sort=False,
        )
        print(json.dumps(rep11), file=sys.stderr)
        if rep11["windows_counted"] == rep11["windows_expected"]:
            extra["canonical_k11_gbases"] = rep11["gbases_per_sec"]
    print(
        json.dumps(
            {
                "metric": f"count_throughput_k{k}",
                "value": value,
                "unit": "Gbase/s/device",
                "vs_baseline": round(value / baseline_gbps, 4),
                **extra,
            }
        )
    )
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
