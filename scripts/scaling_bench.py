#!/usr/bin/env python
"""Scaling-efficiency harness: sharded counting at 1..N devices.

Measures bases/s of the data-parallel sharded counter (ppermute halos +
integer psum merge) at every mesh size available, reporting parallel
efficiency vs the 1-device run — the BASELINE.json "reads/s scaling
efficiency 1->N hosts" harness. On a multi-host pod, launch one process
per host with jax.distributed env vars (parallel/multihost.py); the mesh
then spans hosts and the same numbers measure DCN+ICI scaling.

Usage: python scripts/scaling_bench.py [k] [total_bases]
       (on CPU: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8)
"""

import json
import os
import sys
import time


def main():
    k = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    total = int(sys.argv[2]) if len(sys.argv) > 2 else 16 << 20
    import jax

    from dna_kmeres_parallel.utils.cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    from dna_kmeres_parallel.parallel import sharded_count as sc
    from dna_kmeres_parallel.parallel.mesh import make_mesh
    from dna_kmeres_parallel.utils import codec

    n_dev = len(jax.devices())
    sizes = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_dev]
    bins = codec.num_bins(k)

    rng = np.random.default_rng(0)
    flat = rng.integers(0, 4, size=total).astype(np.uint8)

    base_rate = None
    for d in sizes:
        mesh = make_mesh(d)
        stream = sc.device_put_sharded_stream(flat, mesh)
        h = sc.count_sharded(stream, k, bins, False, mesh)
        h.block_until_ready()  # compile + warmup
        t0 = time.perf_counter()
        reps = 3
        accs = []
        for i in range(reps):
            stream_i = sc.device_put_sharded_stream(flat ^ np.uint8(i % 3), mesh)
            accs.append(sc.count_sharded(stream_i, k, bins, False, mesh))
        jax.block_until_ready(accs)
        dt = (time.perf_counter() - t0) / reps
        rate = total / dt
        if base_rate is None:
            base_rate = rate
        print(
            json.dumps(
                {
                    "devices": d,
                    "bases_per_sec": round(rate, 1),
                    "speedup": round(rate / base_rate, 3),
                    "efficiency": round(rate / base_rate / d, 3),
                }
            ),
            flush=True,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
