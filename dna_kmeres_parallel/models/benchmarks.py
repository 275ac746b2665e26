"""Throughput microbenchmarks of the device programs (bases/sec/device).

The framework's replacement for the reference's ad-hoc cudaEvent timing
(/root/reference/main.cu:262-300,326-350): wall timers around jitted
device programs that end in ``block_until_ready``, with compile time
reported apart (a warmup call on a reserved input) and every timed call
fed a distinct device-resident input, reporting structured JSON.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from dna_kmeres_parallel.models.engine import _count_batch
from dna_kmeres_parallel.utils import codec


def _random_batches(n: int, batch_bases: int, seed: int) -> list[jax.Array]:
    """n distinct device-resident [batch_bases] uint8 base batches."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return [
        jax.random.randint(kk, (batch_bases,), 0, 4, jnp.int32).astype(
            jnp.uint8
        )
        for kk in keys
    ]


def _timed(fn, warm_input, inputs) -> tuple[float, float, list]:
    """(compile_plus_first_s, median_steady_s, outputs) of fn over inputs;
    every call ends in block_until_ready."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(warm_input))
    first = time.perf_counter() - t0
    outs, ts = [], []
    for x in inputs:
        t0 = time.perf_counter()
        outs.append(jax.block_until_ready(fn(x)))
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts)), outs


def _device() -> dict:
    d = jax.devices()[0]
    return {
        "platform": d.platform,
        "kind": d.device_kind,
        "count": len(jax.devices()),
    }


def run_count_bench(
    k: int = 8,
    canonical: bool = False,
    total_bases: int = 64 << 20,
    batch_bases: int = 16 << 20,
    seed: int = 0,
) -> dict:
    """Time the dense count program (encode + histogram) over synthetic
    random bases pre-staged on device — the reference's step-1 analogue."""
    bins = codec.num_bins(k)
    batch_bases = min(batch_bases, total_bases)
    n_batches = max(total_bases // batch_bases, 1)
    inputs = _random_batches(n_batches + 1, batch_bases, seed)
    n_own = jnp.int32(batch_bases - k + 1)

    def fn(b):
        return _count_batch(b, n_own, k, bins, canonical)

    first, steady, outs = _timed(fn, inputs[-1], inputs[:-1])
    counted = sum(int(np.asarray(h, dtype=np.int64).sum()) for h in outs)
    return {
        "bench": "count",
        "k": k,
        "canonical": canonical,
        "bins": bins,
        "total_bases": n_batches * batch_bases,
        "batch_bases": batch_bases,
        "compile_s": round(first - steady, 4),
        "steady_s_per_batch": steady,
        "gbases_per_sec": batch_bases / steady / 1e9,
        "windows_counted": counted,
        "windows_expected": n_batches * (batch_bases - k + 1),
        "device": _device(),
    }


def run_sparse_bench(
    k: int = 21,
    canonical: bool = False,
    total_bases: int = 64 << 20,
    batch_bases: int = 16 << 20,
    seed: int = 0,
    row_len: int = 0,
    device_sort: bool = False,
) -> dict:
    """Throughput of the sparse count path's DEVICE program at large k.
    Device work only (compaction and cross-batch merge excluded; see
    StreamingCounter metrics for the full pipeline split).
    device_sort=False times the production encode-only program (the host
    radix compactor needs no sorted input); True times the row-sorted
    (row_len > 0) or flat-sorted variant."""
    from dna_kmeres_parallel.ops import sparse as sparse_ops

    batch_bases = min(batch_bases, total_bases)
    n_batches = max(total_bases // batch_bases, 1)
    inputs = _random_batches(n_batches + 1, batch_bases, seed)
    n_own = jnp.int32(batch_bases - k + 1)

    if not device_sort:
        def fn(b):
            return sparse_ops.encode_words(b, n_own, k, canonical)
    elif row_len:
        def fn(b):
            return sparse_ops.sort_words_rows(
                b, n_own, k, canonical, row_len=row_len
            )
    else:
        def fn(b):
            return sparse_ops.sort_words(b, n_own, k, canonical)

    first, steady, outs = _timed(fn, inputs[-1], inputs[:-1])
    counted = 0
    for words in outs:
        major = words[0]
        sent = sparse_ops.word_sentinel(major.dtype)
        counted += int(jnp.sum(major != sent))
    return {
        "bench": "sparse_count",
        "k": k,
        "canonical": canonical,
        "device_sort": device_sort,
        "row_len": row_len,
        "total_bases": n_batches * batch_bases,
        "batch_bases": batch_bases,
        "compile_s": round(first - steady, 4),
        "steady_s_per_batch": steady,
        "gbases_per_sec": batch_bases / steady / 1e9,
        "windows_counted": counted,
        "windows_expected": n_batches * (batch_bases - k + 1),
        "device": _device(),
    }


def run_distance_bench(
    n_seqs: int = 1024,
    seq_len: int = 1024,
    k: int = 3,
    seed: int = 0,
    impl: str = "auto",
    reps: int = 3,
) -> dict:
    """Time the pairwise (min,+) program (the reference's step-2 analogue,
    /root/reference/kernels.h:85-109 generalized to one tiled program).

    impl: 'auto' mirrors KmerEngine routing (int8 thresholds when the cost
    models pick them, else the Pallas kernel where it runs, else XLA);
    'int8'/'pallas'/'jnp' force a path for A/B comparison. The counts
    matrix is built once outside the timed region; each timed call gets
    a distinct row roll of it."""
    from dna_kmeres_parallel.models.engine import (
        KmerEngine,
        _counts_matrix_batch,
    )
    from dna_kmeres_parallel.ops import distance as dist_ops
    from dna_kmeres_parallel.ops import distance_pallas
    from dna_kmeres_parallel.utils.config import KmerConfig

    bins = codec.num_bins(k)
    grid = jax.random.randint(
        jax.random.PRNGKey(seed), (n_seqs, seq_len), 0, 4, dtype=jnp.int32
    ).astype(jnp.uint8)
    counts = jax.block_until_ready(_counts_matrix_batch(grid, k, bins, False))
    engine = KmerEngine(KmerConfig(k=k))
    cmax = int(jnp.max(counts))
    cmax = 1 << max(cmax - 1, 0).bit_length() if cmax > 0 else 0
    if impl == "auto":
        int8 = engine._int8_dist_cmax(np.asarray(counts))
        if int8 is not None:
            use, cmax = "int8", int8
        elif engine._kernel() is not None:
            use = "pallas"
        else:
            use = "jnp"
    else:
        use = impl
    if use == "int8":
        fn = lambda c: dist_ops.min_sum_matrix_int8(c, cmax)  # noqa: E731
    elif use == "pallas":
        fn = distance_pallas.min_sum_matrix_pallas
    else:
        fn = dist_ops.min_sum_matrix
    rolled = [jnp.roll(counts, i + 1, axis=0) for i in range(reps + 1)]
    first, steady, _ = _timed(fn, rolled[-1], rolled[:-1])
    n_pairs = n_seqs * (n_seqs - 1) // 2
    return {
        "bench": "distance",
        "k": k,
        "impl": use,
        "cmax": cmax,
        "n_seqs": n_seqs,
        "seq_len": seq_len,
        "n_pairs": n_pairs,
        "compile_s": round(first - steady, 4),
        "elapsed_s": steady,
        "pairs_per_sec": n_pairs / steady,
        "device": _device(),
    }
