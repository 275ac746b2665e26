"""Resumable streaming counter: batches, metrics, checkpoint/resume.

The production counting loop: native parse -> flat encoded stream ->
fixed-shape device batches (async dispatch keeps host prep and device compute
overlapped) -> periodic checkpoint of (partial counts, stream cursor) so a
preempted run resumes batch-granularly (SURVEY.md §5 failure-recovery plan;
the reference has no recovery story at all).
"""

from __future__ import annotations

import os
import time

import jax.numpy as jnp
import numpy as np

from dna_kmeres_parallel.models.engine import (
    CountResult,
    _count_batch,
    _count_batch_acc,
    _count_batch_acc_packed,
    _count_batch_packed,
    _pow2_bucket,
    _round_up,
    _LANE,
    stage_batch,
)
from dna_kmeres_parallel.models.sparse_engine import SparseCountResult
from dna_kmeres_parallel.ops import sparse as sparse_ops
from dna_kmeres_parallel.utils import checkpoint as ckpt_mod
from dna_kmeres_parallel.utils import codec
from dna_kmeres_parallel.utils.config import KmerConfig
from dna_kmeres_parallel.utils.metrics import Metrics


# Device accumulators are int32: flush to the host int64 histogram before
# any bin could overflow (worst case: one bin receives every window).
_FLUSH_LIMIT = (1 << 31) - (1 << 27)

#: 'auto' compact adaptivity: after the initial race, every Nth batch runs
#: on the LOSING route to refresh its EWMA rate (KMER_COMPACT_RECHECK).
_COMPACT_RECHECK = int(os.environ.get("KMER_COMPACT_RECHECK", "16"))
#: flip modes only when the loser's EWMA beats the winner's by this margin
#: (flapping guard against one slow probe batch).
_COMPACT_HYSTERESIS = 1.25
#: 'auto' never pre-selects device-rle: a stream-head duplication sample
#: sees dup ~1 on coverage data, so such a gate does not fire where it
#: would matter. 'auto' starts from the EWMA probe race, which measures
#: the actual routes on the actual machine; compact='device-rle' remains
#: an explicit operator mode.


def _prefetched(items, fn, depth: int = 2):
    """Run fn over items with a 1-thread prefetcher: batch i+1's host prep
    (pad + H2D staging) overlaps batch i's device compute — the
    double-buffered feed of SURVEY.md §7 M3."""
    import itertools
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    it = iter(items)
    with ThreadPoolExecutor(max_workers=1) as ex:
        futs = deque()
        for item in itertools.islice(it, depth):
            futs.append((item, ex.submit(fn, item)))
        for item in it:
            done_item, fut = futs.popleft()
            yield done_item, fut.result()
            futs.append((item, ex.submit(fn, item)))
        while futs:
            done_item, fut = futs.popleft()
            yield done_item, fut.result()


class StreamingCounter:
    """Streamed, resumable, metered counting over a FASTA file or stream."""

    def __init__(
        self,
        config: KmerConfig | None = None,
        checkpoint_path: str | None = None,
        checkpoint_every_bases: int = 1 << 28,
        max_batches: int | None = None,
        max_retries: int = 2,
        trace_dir: str | None = None,
    ):
        """max_batches: stop (checkpointing progress) after N batches — for
        bounded work slices and for crash/preemption simulation in tests.
        max_retries: transient device failures per batch are retried this
        many times before surfacing (preemption-style fault tolerance).
        trace_dir: capture a jax.profiler xplane trace of the run."""
        self.config = config or KmerConfig()
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every_bases = checkpoint_every_bases
        self.max_batches = max_batches
        self.max_retries = max_retries
        self.trace_dir = trace_dir
        self.metrics = Metrics()
        self.route = ""  # the device route the last run() took

    def _with_retry(self, fn):
        """Run fn(), retrying transient device errors (the reference exits on
        first error, main.cu:224-227; here a failed batch is re-dispatched).

        NOTE: JAX dispatch is asynchronous — an error during device
        EXECUTION surfaces at the next host sync (np.asarray / fetch), not
        here. Wrap the sync point (with a closure that re-dispatches from
        still-valid inputs) when execution-time retry matters; a poisoned
        accumulator chain cannot be retried batch-granularly and falls
        back to checkpoint resume."""
        last = None
        for attempt in range(self.max_retries + 1):
            try:
                return fn()
            except Exception as e:  # jax runtime errors share no base class
                last = e
                name = type(e).__name__
                transient = any(
                    t in name or t in str(e)
                    for t in ("Internal", "Unavailable", "DataLoss", "RESOURCE")
                )
                if not transient or attempt == self.max_retries:
                    raise
                self.metrics.count("batch_retries")
        raise last

    # ------------------------------------------------------------------
    def _mesh(self):
        """Device mesh for multi-chip DP streaming (KmerConfig.mesh_shape);
        None = single-device path."""
        cfg = self.config
        if not cfg.mesh_shape:
            return None
        import math

        from dna_kmeres_parallel.parallel.mesh import make_mesh

        n = math.prod(cfg.mesh_shape)
        return make_mesh(n) if n > 1 else None

    # ------------------------------------------------------------------
    def _load_stream(self, source):
        from dna_kmeres_parallel import native
        from dna_kmeres_parallel.utils import fasta

        cfg = self.config
        if isinstance(source, (list, tuple)):
            # Multi-file input: concatenate per-file streams with one
            # sentinel between (counts add; no cross-file window exists).
            streams, total_bases, n_seqs = [], 0, 0
            saved_max = cfg.max_seqs
            for s in source:
                if saved_max is not None and n_seqs >= saved_max:
                    break
                if saved_max is not None:
                    self.config = cfg.replace(max_seqs=saved_max - n_seqs)
                try:
                    flat, tb, ns = self._load_stream(s)
                finally:
                    self.config = cfg
                if streams and flat.size:
                    streams.append(np.array([codec.INVALID_BASE], np.uint8))
                streams.append(flat)
                total_bases += tb
                n_seqs += ns
            flat = (
                np.concatenate(streams) if streams else np.zeros(0, np.uint8)
            )
            return flat, total_bases, n_seqs
        with self.metrics.phase("parse"):
            if (
                cfg.parser_variant == "modern"
                and isinstance(source, (str, os.PathLike))
                and native.available()
            ):
                parsed = native.parse_fasta_native(source, max_seqs=cfg.max_seqs)
                self.metrics.count("invalid_bases", parsed.invalid_bases)
                return parsed.stream, parsed.total_bases, parsed.n_seqs
            if cfg.parser_variant == "modern":
                records = fasta.parse_fasta(source, max_seqs=cfg.max_seqs)
            else:
                records = fasta.parse_fasta_reference(
                    source, variant=cfg.parser_variant, max_seqs=cfg.max_seqs
                )
            parts = []
            for i, r in enumerate(records):
                if i:
                    parts.append(np.array([codec.INVALID_BASE], dtype=np.uint8))
                parts.append(codec.encode_bases(r.seq))
            flat = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
            return flat, sum(len(r.seq) for r in records), len(records)

    def _maybe_resume(self, total: int):
        cfg = self.config
        if not self.checkpoint_path or not os.path.exists(self.checkpoint_path):
            return None
        ck = ckpt_mod.load_checkpoint(self.checkpoint_path)
        if ck.k != cfg.k or ck.canonical != cfg.canonical or ck.cursor > total:
            return None  # incompatible checkpoint: start fresh
        return ck

    def _save(self, cursor: int, total_bases: int, hist=None, sparse=None):
        if not self.checkpoint_path:
            return
        with self.metrics.phase("checkpoint"):
            ck = ckpt_mod.CountCheckpoint(
                k=self.config.k,
                canonical=self.config.canonical,
                cursor=cursor,
                total_bases=total_bases,
                hist=hist,
                sparse_codes=sparse[0] if sparse else None,
                sparse_counts=sparse[1] if sparse else None,
            )
            ckpt_mod.save_checkpoint(self.checkpoint_path, ck)
            self.metrics.count("checkpoints")

    # ------------------------------------------------------------------
    def run(self, source):
        """Count a FASTA source. Returns CountResult (dense, k <= 12) or
        SparseCountResult (sorted table, k >= 13)."""
        from dna_kmeres_parallel.utils.profiling import trace

        cfg = self.config
        t0 = time.perf_counter()
        flat, total_bases, n_seqs = self._load_stream(source)
        with trace(self.trace_dir):
            if cfg.bins <= cfg.dense_bins_limit:
                # Medium-dense bins (k=9..15): count through the sparse
                # path and materialize the dense histogram once at the end
                # (same routing as KmerEngine.count_stream; codes are
                # unique so it's an indexed store, not a scatter-add).
                # Checkpoints along the way are sparse tables.
                if cfg.bins > (1 << 16) and flat.shape[0] >= cfg.k:
                    from dna_kmeres_parallel.models.sparse_engine import (
                        dense_from_sparse,
                    )

                    sp = self._run_sparse(flat, total_bases, n_seqs, t0)
                    hist = dense_from_sparse(sp, cfg.bins)
                    return CountResult(
                        k=cfg.k,
                        canonical=cfg.canonical,
                        hist=hist,
                        n_seqs=n_seqs,
                        total_bases=total_bases,
                        elapsed_s=time.perf_counter() - t0,
                    )
                return self._run_dense(flat, total_bases, n_seqs, t0)
            return self._run_sparse(flat, total_bases, n_seqs, t0)

    def _batches(self, total: int, start: int):
        cfg = self.config
        overlap = cfg.k - 1
        batch = max(min(cfg.batch_bases, _pow2_bucket(total)), cfg.k)
        T = _round_up(batch + overlap, _LANE)
        pos = start
        while pos < total:
            end = min(pos + batch, total)
            yield pos, end, T, overlap
            pos = end

    def _run_dense(self, flat, total_bases, n_seqs, t0) -> CountResult:
        from dna_kmeres_parallel.ops.histogram import impl_name

        cfg = self.config
        total = flat.shape[0]
        hist = np.zeros(cfg.bins, dtype=np.int64)
        cursor = 0
        ck = self._maybe_resume(total)
        if ck is not None and ck.dense:
            hist = ck.hist.astype(np.int64)
            cursor = ck.cursor
            self.metrics.count("resumed_from_base", cursor)

        acc = None
        since_ckpt = 0
        acc_windows = 0
        done_batches = 0
        stopped = False
        mesh = self._mesh()
        self.route = ("mesh/" if mesh is not None else "") + (
            f"xla-histogram/{impl_name(cfg.bins)}"
        )

        def prep(bounds):
            start, end, T, overlap = bounds
            seg = flat[start : min(end + overlap, total)]
            padded = np.full(T, codec.INVALID_BASE, dtype=np.uint8)
            padded[: seg.shape[0]] = seg
            if mesh is not None:
                # Multi-chip DP: stage the batch sharded across the mesh
                # (count_sharded's ppermute halos + n_own masking handle
                # intra-batch shard and batch-overlap boundaries).
                from dna_kmeres_parallel.parallel.sharded_count import (
                    device_put_sharded_stream,
                )

                return device_put_sharded_stream(padded, mesh)
            # staged to device off-thread; 2-bit packed planes if configured
            return stage_batch(padded, cfg.pack_input)

        for (start, end, T, overlap), staged in _prefetched(
            self._batches(total, cursor), prep
        ):
            if self.max_batches is not None and done_batches >= self.max_batches:
                # Early stop: checkpoint progress at this boundary and DO NOT
                # write the final full-run checkpoint below.
                if acc is not None:
                    hist += np.asarray(acc, dtype=np.int64)
                    acc = None
                self._save(start, total_bases, hist=hist)
                stopped = True
                break
            done_batches += 1
            with self.metrics.phase("device"):
                n_own = jnp.int32(end - start)
                if mesh is not None:
                    from dna_kmeres_parallel.parallel.sharded_count import (
                        count_sharded,
                    )

                    prev = acc
                    acc = self._with_retry(
                        lambda: count_sharded(
                            staged, cfg.k, cfg.bins, cfg.canonical, mesh,
                            n_own=n_own, acc=prev,
                        )
                    )
                elif cfg.pack_input:
                    data, mask = staged
                    if acc is None:
                        acc = self._with_retry(
                            lambda: _count_batch_packed(
                                data, mask, n_own,
                                cfg.k, cfg.bins, cfg.canonical,
                            )
                        )
                    else:
                        prev = acc
                        acc = self._with_retry(
                            lambda: _count_batch_acc_packed(
                                prev, data, mask, n_own,
                                cfg.k, cfg.bins, cfg.canonical,
                            )
                        )
                elif acc is None:
                    acc = self._with_retry(
                        lambda: _count_batch(
                            staged, n_own,
                            cfg.k, cfg.bins, cfg.canonical,
                        )
                    )
                else:
                    prev = acc
                    acc = self._with_retry(
                        lambda: _count_batch_acc(
                            prev, staged, n_own,
                            cfg.k, cfg.bins, cfg.canonical,
                        )
                    )
            self.metrics.count("bases", end - start)
            self.metrics.count("batches")
            since_ckpt += end - start
            acc_windows += end - start
            if acc_windows >= _FLUSH_LIMIT:
                # Flush before any int32 accumulator bin could overflow
                # (the guard KmerEngine.count_stream applies; a
                # checkpoint_every_bases above 2^31 must not disable it).
                hist += np.asarray(acc, dtype=np.int64)
                acc = None
                acc_windows = 0
            if since_ckpt >= self.checkpoint_every_bases:
                if acc is not None:
                    hist += np.asarray(acc, dtype=np.int64)
                    acc = None
                acc_windows = 0
                self._save(end, total_bases, hist=hist)
                since_ckpt = 0
        if acc is not None:
            hist += np.asarray(acc, dtype=np.int64)
        if not stopped:
            self._save(total, total_bases, hist=hist)
        return CountResult(
            k=cfg.k,
            canonical=cfg.canonical,
            hist=hist,
            n_seqs=n_seqs,
            total_bases=total_bases,
            elapsed_s=time.perf_counter() - t0,
        )

    def _resolve_compact(self, mesh) -> bool | None:
        """KmerConfig.compact -> host_mode: True = host-resident native
        counting (ZERO D2H — re-derives a window's words from the resident
        bases instead of shipping them back from the device),
        False = device words + host radix, None = undecided ('auto': race
        the first batches and finish with the winner)."""
        from dna_kmeres_parallel import native

        cfg = self.config
        if cfg.compact == "host":
            if not native.available():
                raise RuntimeError(
                    "compact='host' needs the native engine (build "
                    "dna_kmeres_parallel/native); it is unavailable"
                )
            return True
        if cfg.compact in ("device-rle", "device-super"):
            if mesh is not None:
                raise ValueError(
                    f"compact={cfg.compact!r} is a single-device D2H mode; "
                    "mesh streams route compressed records/codes through "
                    "the exchanges instead (parallel/bucketed.py)"
                )
            return False
        if cfg.compact == "device" or mesh is not None or not native.available():
            # mesh streams exist to use every device; racing them against
            # one host core is not meaningful.
            return False
        return None

    def _run_sparse(self, flat, total_bases, n_seqs, t0) -> SparseCountResult:
        cfg = self.config
        total = flat.shape[0]
        # Two-level MergeLadder (r4): bounds memory for arbitrarily long
        # streams AND collapses batch tables through the native k-way heap
        # instead of pairwise ladder merges (the old plain list either
        # grew unboundedly without a checkpoint or paid merge-everything
        # on the checkpoint cadence).
        from dna_kmeres_parallel.models.sparse_engine import MergeLadder

        tables = MergeLadder()
        cursor = 0
        ck = self._maybe_resume(total)
        if ck is not None and not ck.dense:
            tables.push((ck.sparse_codes, ck.sparse_counts))
            cursor = ck.cursor
            self.metrics.count("resumed_from_base", cursor)

        since_ckpt = 0
        done_batches = 0
        stopped = False

        mesh = self._mesh()
        host_mode = self._resolve_compact(mesh)
        rle = cfg.compact == "device-rle"
        # Super-k-mer D2H compaction: ship minimizer-run records
        # (~1.5-2 B/window) instead of word planes (6-8), for when D2H
        # bounds the stream; the host expands records and counts with the
        # fused native engine. Single device, any k <= 31.
        sk = cfg.compact == "device-super"
        # 'auto' bookkeeping: EWMA bases/s per route. Initial decision:
        # drain walls of device batches 2..3 (batch 1 pays compiles) vs one
        # host-counted batch 4, decided before batch 5. The decision is
        # RE-EVALUATED for the rest of the stream: every _COMPACT_RECHECK
        # batches one batch runs on the losing route and refreshes its
        # rate, and the mode flips when the loser's EWMA beats the
        # winner's by the hysteresis margin, so one slow probe batch
        # cannot lock a GB run into the wrong mode.
        adaptive = host_mode is None
        rate: dict[str, float | None] = {
            "device": None, "host": None, "super": None
        }
        # Super-k-mer sub-route of the device arm: once
        # the main race picks the device route, one batch probes the
        # compressed-record D2H format; the EWMA then selects words vs
        # super by the same hysteresis as the main race (re-probed on the
        # recheck cycle, offset from the host probe). The probe only runs
        # when the device arm is active — when host-resident counting
        # wins, super (host counting PLUS a D2H leg) cannot beat it.
        from dna_kmeres_parallel import native as _native_mod

        super_eligible = (
            adaptive
            and not rle
            and not sk
            and mesh is None
            and cfg.k >= 13
            and _native_mod.available()
        )
        device_route = "words"
        _state = {"super_warm": False}

        def _rate_update(key: str, bases_n: int, wall: float) -> None:
            r = bases_n / max(wall, 1e-9)
            rate[key] = r if rate[key] is None else 0.5 * rate[key] + 0.5 * r

        def pad_bounds(bounds):
            start, end, T, overlap = bounds
            seg = flat[start : min(end + overlap, total)]
            padded = np.full(T, codec.INVALID_BASE, dtype=np.uint8)
            padded[: seg.shape[0]] = seg
            return padded

        def stage_words(padded):
            """Stage for the WORDS device route (packed / raw by config) —
            independent of the current sub-route, so words re-probes while
            device_route=='super' stage correctly."""
            return stage_batch(padded, cfg.pack_input)

        def stage_default(padded):
            if super_eligible and device_route == "super":
                # Steady-state super sub-route: records consume the raw
                # base stream (closure reads the CURRENT sub-route; the
                # dispatch loop restages on a format mismatch).
                return stage_batch(padded, False)
            return stage_words(padded)

        def prep(bounds):
            if host_mode is True:
                # Host-resident counting: nothing to pad or ship. (Closure
                # reads the CURRENT mode: the prefetch thread may still
                # stage 1-2 device batches around an 'auto' switch —
                # harmless, they are simply never dispatched.)
                return None
            start, end, T, overlap = bounds
            padded = pad_bounds(bounds)
            if rle or sk:
                # sort_words_rle / superkmer_records_device consume the
                # raw base stream.
                return stage_batch(padded, False)
            if mesh is not None:
                # Multi-chip DP-sparse: host-side halo shards (fixed shapes
                # every batch), staged sharded across the mesh.
                import jax
                from jax.sharding import NamedSharding, PartitionSpec as P

                from dna_kmeres_parallel.parallel.bucketed import (
                    shard_stream_with_halo,
                )
                from dna_kmeres_parallel.parallel.mesh import DATA_AXIS

                shards, n_own_d = shard_stream_with_halo(
                    padded, cfg.k, mesh, total_own=end - start
                )
                n_own_g = jax.device_put(
                    n_own_d, NamedSharding(mesh, P(DATA_AXIS))
                )
                return (
                    jax.device_put(
                        shards, NamedSharding(mesh, P(DATA_AXIS, None))
                    ),
                    n_own_g,
                )
            return stage_default(padded)

        from dna_kmeres_parallel.models.sparse_engine import (
            compact_table,
            compact_unsorted,
            fetch_words,
            resolve_device_sort,
        )

        # No-device-sort route: the device runs the encode kernel alone and
        # the host radix compactor absorbs the unsorted words — see
        # KmerConfig.device_sort. Applies per shard on the mesh path too.
        dev_sort = resolve_device_sort(cfg)

        # Software pipelining: batch t's host compaction (D2H fetch + native
        # compactor) runs only after batch t+1 has been dispatched, so the
        # device sorts t+1 while the host drains t.
        pending = None  # (words, batch_start, batch_end, batch_idx)

        def book(p_start, p_end):
            nonlocal since_ckpt
            self.metrics.count("bases", p_end - p_start)
            self.metrics.count("batches")
            since_ckpt += p_end - p_start
            if since_ckpt >= self.checkpoint_every_bases:
                # Full-table merges only serve the checkpoint snapshot;
                # without one, the MergeLadder already bounds memory and
                # the forced merge-everything was measured at ~40% of a
                # 1-GBase run's host time (r4).
                if self.checkpoint_path:
                    with self.metrics.phase("merge"):
                        snap = tables.result()
                        tables.reset_to(snap)
                    self._save(p_end, total_bases, sparse=snap)
                since_ckpt = 0

        def _maybe_flip():
            nonlocal host_mode, device_route
            if not adaptive or host_mode is None:
                return
            if (
                super_eligible
                and rate["super"] is not None
                and rate["device"] is not None
            ):
                # Device sub-route selection (words vs super D2H format),
                # same hysteresis as the main race.
                cur_k = "super" if device_route == "super" else "device"
                oth_k = "device" if cur_k == "super" else "super"
                if rate[oth_k] > _COMPACT_HYSTERESIS * rate[cur_k]:
                    device_route = "super" if oth_k == "super" else "words"
                    self.metrics.count("compact_super_flips")
            # The device arm's representative rate. In HOST mode only the
            # words route re-probes (super's probe needs the device arm),
            # so the host-vs-device flip uses the FRESH rate['device']
            # there — never the frozen super EWMA, which could otherwise
            # drive a flip on a number the code knows is stale. In DEVICE
            # mode the sub-route selection above already keeps
            # device_route on the better-measured sub-route; the flip
            # compares host against the route actually running.
            if host_mode:
                dev_key = "device"
            else:
                dev_key = (
                    "super"
                    if device_route == "super" and rate["super"] is not None
                    else "device"
                )
            if rate[dev_key] is None or rate["host"] is None:
                return
            cur, other = (
                ("host", dev_key) if host_mode else (dev_key, "host")
            )
            if rate[other] > _COMPACT_HYSTERESIS * rate[cur]:
                host_mode = not host_mode
                if not host_mode:
                    # Entering device mode on the words route; the
                    # sub-probe cycle re-rates super promptly.
                    device_route = "words"
                self.metrics.count("compact_mode_flips")

        def drain(p):
            words, p_start, p_end, p_idx, tag = p
            t_d = time.perf_counter()
            with self.metrics.phase("compact"):
                if tag == "rle":
                    from dna_kmeres_parallel.models.sparse_engine import (
                        table_from_rle,
                    )

                    tables.push(table_from_rle(*words))
                elif tag == "super":
                    from dna_kmeres_parallel.parallel.bucketed import (
                        table_from_superkmers,
                    )

                    tables.push(
                        table_from_superkmers(
                            *words, cfg.k, 7, cfg.canonical
                        )
                    )
                elif mesh is not None:
                    # [D, ...] planes: one table per device's shard.
                    planes = fetch_words(words)
                    for d in range(planes[-1].shape[0]):
                        plane = tuple(w[d] for w in planes)
                        tables.push(
                            compact_table(plane)
                            if dev_sort
                            else compact_unsorted(plane, cfg.k)
                        )
                elif dev_sort:
                    tables.push(compact_table(words))
                else:
                    tables.push(compact_unsorted(words, cfg.k))
            if adaptive and p_idx >= 2:
                # This wall covers device exec + D2H fetch + host
                # compaction — the full per-batch cost of the device route
                # in the pipelined steady state (batch 1 pays the compiles
                # and is excluded; the super sub-route's FIRST batch pays
                # its own compile and only warms).
                if tag == "super" and not _state["super_warm"]:
                    _state["super_warm"] = True
                else:
                    _rate_update(
                        "super" if tag == "super" else "device",
                        p_end - p_start,
                        time.perf_counter() - t_d,
                    )
                    _maybe_flip()
            book(p_start, p_end)

        for (start, end, T, overlap), staged in _prefetched(
            self._batches(total, cursor), prep
        ):
            if self.max_batches is not None and done_batches >= self.max_batches:
                if pending is not None:
                    drain(pending)
                    pending = None
                with self.metrics.phase("merge"):
                    snap = tables.result()
                    tables.reset_to(snap)
                self._save(start, total_bases, sparse=snap)
                stopped = True
                break
            done_batches += 1
            # Probe schedule: once decided, every _COMPACT_RECHECK-th batch
            # runs on the LOSING route to refresh its EWMA (so a stale
            # verdict can be overturned mid-stream).
            probe = (
                adaptive
                and host_mode is not None
                and not rle
                and not sk
                and _COMPACT_RECHECK > 0  # 0 = never re-probe
                and done_batches % _COMPACT_RECHECK == 0
            )
            use_host = (
                (host_mode is True) != probe
                if host_mode is not None
                else done_batches == 4
            )
            # Device sub-route for THIS batch: the super probe runs once
            # the main race has decided for the device arm (rate unset),
            # then the LOSING sub-route re-probes on the recheck cycle,
            # offset from the host probe so the two never collide.
            if not use_host and super_eligible and host_mode is False:
                sub_probe = (
                    rate["super"] is None
                    or (
                        _COMPACT_RECHECK > 0
                        and done_batches % _COMPACT_RECHECK
                        == max(_COMPACT_RECHECK // 2, 1)
                        and not probe
                    )
                )
                if sub_probe and rate["super"] is None:
                    batch_route = "super"
                elif sub_probe:
                    batch_route = (
                        "words" if device_route == "super" else "super"
                    )
                else:
                    batch_route = device_route
                if batch_route == "super":
                    self.metrics.count("compact_super_batches")
            else:
                batch_route = "words"
            want_super = sk or (not use_host and batch_route == "super")
            if not use_host and staged is None:
                # Device batch requested while the prefetch closure staged
                # for host mode (a probe, or the 1-2 batch skew around a
                # flip): stage synchronously for THIS batch's route.
                if want_super and not sk:
                    staged = stage_batch(
                        pad_bounds((start, end, T, overlap)), False
                    )
                else:
                    staged = stage_words(
                        pad_bounds((start, end, T, overlap))
                    )
            elif not use_host:
                # Sub-route / prefetch format mismatches restage
                # synchronously (rare: probes and the 1-2 batch skew
                # around a sub-route flip). stage_words, NOT
                # stage_default: a words re-probe while the sub-route is
                # 'super' must get the words format.
                is_raw = (
                    not isinstance(staged, tuple)
                    and getattr(staged, "dtype", None) == jnp.uint8
                )
                if want_super and not (sk or rle) and not is_raw:
                    staged = stage_batch(
                        pad_bounds((start, end, T, overlap)), False
                    )
                elif (
                    (not want_super)
                    and not (sk or rle)
                    and is_raw
                    and cfg.pack_input
                ):
                    staged = stage_words(
                        pad_bounds((start, end, T, overlap))
                    )
            if use_host:
                # ZERO-D2H route: count the batch straight off the
                # host-resident stream with the fused native engine (the
                # same halo rule — the segment carries k-1 tail bases, so
                # it owns exactly the windows starting in [start, end)).
                from dna_kmeres_parallel import native

                if pending is not None:
                    drain(pending)
                    pending = None
                seg = flat[start : min(end + overlap, total)]
                t_h = time.perf_counter()
                with self.metrics.phase("host_count"):
                    tables.push(
                        native.count_sparse_host_native(
                            seg, cfg.k, cfg.canonical
                        )
                    )
                if adaptive:
                    _rate_update(
                        "host", end - start, time.perf_counter() - t_h
                    )
                book(start, end)
                if (
                    adaptive
                    and host_mode is None
                    and rate["device"] is not None
                    and rate["host"] is not None
                ):
                    host_mode = rate["host"] > rate["device"]
                    self.metrics.count(
                        "compact_host_selected", int(host_mode)
                    )
                elif adaptive:
                    _maybe_flip()
                continue
            with self.metrics.phase("device"):
                n_own = jnp.int32(end - start)
                if rle:
                    # Device sort + RLE: only DISTINCT (code, count) pairs
                    # come down (drain -> table_from_rle).
                    words = self._with_retry(
                        lambda: sparse_ops.sort_words_rle(
                            staged, n_own, cfg.k, cfg.canonical
                        )
                    )
                elif want_super:
                    # Super-k-mer records: ~1.5-2 B/window of D2H (drain ->
                    # table_from_superkmers; host re-encodes + counts).
                    # Forced (compact='device-super') or the auto race's
                    # device sub-route/probe.
                    from dna_kmeres_parallel.parallel.bucketed import (
                        superkmer_records_device,
                    )

                    words = self._with_retry(
                        lambda: superkmer_records_device(
                            staged, n_own, cfg.k
                        )
                    )
                elif mesh is not None:
                    from dna_kmeres_parallel.parallel.sharded_sparse import (
                        encode_words_sharded,
                        sort_words_rows_sharded,
                    )

                    shards_g, n_own_g = staged
                    if dev_sort:
                        words = self._with_retry(
                            lambda: sort_words_rows_sharded(
                                shards_g, n_own_g, cfg.k, cfg.canonical, mesh,
                                row_len=cfg.sort_row_len or 2048,
                            )
                        )
                    else:
                        words = self._with_retry(
                            lambda: encode_words_sharded(
                                shards_g, n_own_g, cfg.k, cfg.canonical, mesh
                            )
                        )
                elif not dev_sort and cfg.pack_input:
                    words = self._with_retry(
                        lambda: sparse_ops.encode_words_packed(
                            *staged, n_own, cfg.k, cfg.canonical
                        )
                    )
                elif not dev_sort:
                    words = self._with_retry(
                        lambda: sparse_ops.encode_words(
                            staged, n_own, cfg.k, cfg.canonical
                        )
                    )
                elif cfg.pack_input and cfg.sort_row_len:
                    words = self._with_retry(
                        lambda: sparse_ops.sort_words_rows_packed(
                            *staged, n_own, cfg.k, cfg.canonical,
                            row_len=cfg.sort_row_len,
                        )
                    )
                elif cfg.pack_input:
                    words = self._with_retry(
                        lambda: sparse_ops.sort_words_packed(
                            *staged, n_own, cfg.k, cfg.canonical
                        )
                    )
                elif cfg.sort_row_len:
                    words = self._with_retry(
                        lambda: sparse_ops.sort_words_rows(
                            staged, n_own, cfg.k, cfg.canonical,
                            row_len=cfg.sort_row_len,
                        )
                    )
                else:
                    words = self._with_retry(
                        lambda: sparse_ops.sort_words(
                            staged, n_own, cfg.k, cfg.canonical
                        )
                    )
            if pending is not None:
                drain(pending)
            pending = (
                words,
                start,
                end,
                done_batches,
                "rle" if rle else ("super" if want_super else "words"),
            )
        if pending is not None:
            drain(pending)
        mode = (
            "host" if host_mode is True
            else "device-rle" if rle
            else "device-super" if sk
            else "device"
        )
        self.route = ("mesh/" if mesh is not None else "") + (
            f"compact={mode}" if mode == "host" else
            f"compact={mode}/xla-encode+"
            + ("device-sort" if dev_sort else "host-radix")
        )
        with self.metrics.phase("merge"):
            codes, counts = tables.result()
        if not stopped:
            self._save(total, total_bases, sparse=(codes, counts))
        return SparseCountResult(
            k=cfg.k,
            canonical=cfg.canonical,
            codes=codes,
            counts=counts,
            n_seqs=n_seqs,
            total_bases=total_bases,
            elapsed_s=time.perf_counter() - t0,
        )
