"""The device engine: batched counting + pairwise distances.

High-level flow (the re-design of the reference's main(),
/root/reference/main.cu:120-174):

  FASTA -> host parse/encode -> padded device batches
        -> rolling-code encode (ops/encode)
        -> histogram / counts matrix (ops/histogram)
        -> (min,+) distance reduction (ops/distance, ops/distance_pallas)
        -> reference-format CSVs / count tables (utils/io)

Counting uses a flat base stream with one invalid sentinel byte between
sequences (mirroring the reference's '|'->'\\0' sentinel, main.cu:506,539):
any window touching a sentinel is invalid, so no cross-sequence window is
ever counted and chunk boundaries stay exact.

Every path here is verified count-for-count against models/oracle.py.
"""

from __future__ import annotations

import functools
import os
import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from dna_kmeres_parallel.models import distance_stream, oracle
from dna_kmeres_parallel.ops import distance as dist_ops
from dna_kmeres_parallel.ops import distance_pallas
from dna_kmeres_parallel.ops import encode as encode_ops
from dna_kmeres_parallel.ops import histogram as hist_ops
from dna_kmeres_parallel.ops import runtime
from dna_kmeres_parallel.utils import codec, fasta
from dna_kmeres_parallel.utils.config import KmerConfig

_LANE = 128  # pad axes to lane multiples so XLA tiles cleanly


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pow2_bucket(x: int) -> int:
    """Smallest power of two >= x (>= 128): shape buckets for small inputs."""
    b = _LANE
    while b < x:
        b <<= 1
    return b


@dataclass
class CountResult:
    k: int
    canonical: bool
    hist: np.ndarray  # int64 [4^k] dense histogram
    n_seqs: int
    total_bases: int
    elapsed_s: float = 0.0

    def table(self) -> dict[str, int]:
        nz = np.nonzero(self.hist)[0]
        return {codec.code_to_kmer(int(c), self.k): int(self.hist[c]) for c in nz}

    @property
    def total_kmers(self) -> int:
        return int(self.hist.sum())

    @property
    def distinct_kmers(self) -> int:
        return int(np.count_nonzero(self.hist))


@dataclass
class DistanceResult:
    k: int
    n: int
    ids: list[str]
    packed: np.ndarray  # float32 [n*(n-1)/2] strict upper triangle
    counts: np.ndarray | None = None  # int32 [n, 4^k] per-sequence counts
    elapsed_s: float = 0.0
    route: str = ""  # the (min,+) route taken (see KmerEngine._route)


@functools.partial(jax.jit, static_argnames=("k", "bins", "canonical"))
def _count_batch(
    bases: jax.Array,
    n_own: jax.Array,
    k: int,
    bins: int,
    canonical: bool,
) -> jax.Array:
    """One flat base batch [T] uint8 -> dense histogram [bins] int32.

    Only windows *starting* at positions < n_own are counted; the trailing
    k-1 bases are the halo completing the last owned windows (SURVEY.md §5
    halo-correct chunking) — windows starting inside the halo belong to the
    next chunk and are masked out here, so every window is counted exactly
    once across chunk boundaries.
    """
    codes, valid = encode_ops.rolling_codes(bases, k)
    n = codes.shape[0]
    own = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1) < n_own
    valid = valid & own
    if canonical:
        codes = encode_ops.canonicalize(codes, k)
    return hist_ops.histogram(codes, valid, bins)


@functools.partial(jax.jit, static_argnames=("k", "bins", "canonical"))
def _count_batch_acc(
    acc: jax.Array,
    bases: jax.Array,
    n_own: jax.Array,
    k: int,
    bins: int,
    canonical: bool,
) -> jax.Array:
    """acc + count(batch) in ONE dispatch (no separate add program)."""
    return acc + _count_batch(bases, n_own, k, bins, canonical)


@functools.partial(jax.jit, static_argnames=("k", "bins", "canonical"))
def _count_batch_packed(
    data: jax.Array,
    mask: jax.Array,
    n_own: jax.Array,
    k: int,
    bins: int,
    canonical: bool,
) -> jax.Array:
    """_count_batch over the 2-bit packed transfer format: the host ships
    (data [T/4], mask [T/8]) — 4x less H2D — and the unpack fuses into the
    count program (ops/encode.unpack_stream)."""
    bases = encode_ops.unpack_stream(data, mask)
    return _count_batch(bases, n_own, k, bins, canonical)


@functools.partial(jax.jit, static_argnames=("k", "bins", "canonical"))
def _count_batch_acc_packed(
    acc: jax.Array,
    data: jax.Array,
    mask: jax.Array,
    n_own: jax.Array,
    k: int,
    bins: int,
    canonical: bool,
) -> jax.Array:
    bases = encode_ops.unpack_stream(data, mask)
    return acc + _count_batch(bases, n_own, k, bins, canonical)


def stage_batch(padded, pack: bool):
    """Host->device staging of one padded batch [T] uint8.

    pack=True ships the 2-bit packed planes (4 bases/byte + validity
    bitmask; native kp_pack_2bit or the numpy codec) — 4.5 bytes per 16
    bases of H2D instead of 16 — for the *_packed program variants.
    Returns a device array (pack=False) or a (data, mask) tuple.
    """
    if not pack:
        return jnp.asarray(padded)
    from dna_kmeres_parallel import native
    from dna_kmeres_parallel.utils import codec

    if native.available():
        data, mask, _ = native.pack_2bit_native(padded)
    else:
        data, mask, _ = codec.pack_bases(padded)
    return jnp.asarray(data), jnp.asarray(mask)


@functools.partial(jax.jit, static_argnames=("k", "bins", "canonical"))
def _counts_matrix_batch(
    bases: jax.Array,
    k: int,
    bins: int,
    canonical: bool,
) -> jax.Array:
    """Padded sequence grid [S, L] uint8 -> per-sequence counts [S, bins]."""
    codes, valid = encode_ops.rolling_codes(bases, k)
    if canonical:
        codes = encode_ops.canonicalize(codes, k)
    return hist_ops.counts_matrix(codes, valid, bins)


class KmerEngine:
    """Single-host engine. Multi-chip sharding lives in parallel/."""

    def __init__(self, config: KmerConfig | None = None, **kw):
        self.config = (config or KmerConfig()).replace(**kw) if kw else (
            config or KmerConfig()
        )
        if self.config.k > encode_ops.MAX_DENSE_K:
            raise NotImplementedError(
                f"dense engine supports k <= {encode_ops.MAX_DENSE_K}; "
                f"use the sparse engine (ops/sparse.py) for k={self.config.k}"
            )

    def _kernel(self) -> str | None:
        """How the Pallas (min,+) kernel runs here ('compiled' /
        'interpret'), or None for XLA's plain (min,+): honors
        config.use_pallas and the backend capability."""
        if not self.config.use_pallas:
            return None
        return runtime.backend().kernel

    def _mesh(self):
        """Device mesh from config.mesh_shape (None = single card;
        mesh_shape=(1,) also resolves to None — the single-card triangle
        kernel beats a 1-device shard_map of the full square, matching
        StreamingCounter._mesh)."""
        if not self.config.mesh_shape:
            return None
        from dna_kmeres_parallel.parallel.mesh import make_mesh

        n = 1
        for d in self.config.mesh_shape:
            n *= d
        return make_mesh(n) if n > 1 else None

    def count_route(self) -> str:
        """Name of the device route count_stream takes (CLI report)."""
        cfg = self.config
        if (1 << 16) < cfg.bins:
            from dna_kmeres_parallel.models.sparse_engine import (
                SparseKmerEngine,
            )

            return SparseKmerEngine(cfg).route()
        return f"xla-histogram/{hist_ops.impl_name(cfg.bins)}"

    def _int8_dist_cmax(self, counts_np) -> int | None:
        """Whether the int8 threshold route serves this counts matrix:
        returns the static cmax to use (rounded up to its power-of-two
        bucket — extra thresholds contribute zero exactly, and a cmax
        stream then compiles a bounded program set), or None to keep the
        (min,+) routes.

        Gates (cost-based, not a fixed crossover): cmax_bucket <= the
        unroll cap (KMER_INT8_CMAX, default
        ops.distance.INT8_CMAX_DEFAULT=64; setting the env skips the cost
        comparison — an explicit override is trusted), predicted
        threshold time under the per-pair models beats the (min,+) route
        the engine would otherwise take (the Pallas kernel when it runs
        here, XLA's otherwise — int8_time_per_pair vs
        tri/jnp_time_per_pair), every row's window total < 2^31 (int32
        exactness), and an accelerator backend (KMER_DIST_INT8=1/0
        forces/disables — tests route it on the CPU with =1)."""
        force = os.environ.get("KMER_DIST_INT8")
        if force == "0":
            return None
        if force != "1" and not runtime.backend().accelerator:
            return None
        counts_np = np.asarray(counts_np)
        if counts_np.size == 0:
            return None
        cmax = int(counts_np.max(initial=0))
        if cmax <= 0:
            return None
        cmax_b = 1 << max(cmax - 1, 0).bit_length()
        limit_env = os.environ.get("KMER_INT8_CMAX")
        limit = int(limit_env) if limit_env else dist_ops.INT8_CMAX_DEFAULT
        if cmax_b > limit:
            return None
        if limit_env is None:
            bins = int(counts_np.shape[1])
            if self._kernel() is not None:
                t_alt = dist_ops.tri_time_per_pair(bins)
            else:
                t_alt = dist_ops.jnp_time_per_pair(bins)
            if dist_ops.int8_time_per_pair(bins, cmax_b) >= t_alt:
                return None
        if int(counts_np.sum(axis=1).max(initial=0)) >= (1 << 31):
            return None
        return cmax_b

    def _route(self, int8_cmax) -> str:
        """Name of the (min,+) route distance_sequences / the panel
        closure take for this job (reported by the CLI)."""
        mesh = "mesh/" if self._mesh() is not None else ""
        if int8_cmax is not None:
            return f"{mesh}int8-threshold/cmax={int8_cmax}"
        if self._kernel() is not None:
            return f"{mesh}pallas-min-plus"
        return f"{mesh}xla-min-plus"

    def _min_sum_panel_mesh(self, panel, other, mesh, int8_cmax=None):
        """Column-sharded (min,+) panel over the mesh: [Pr, bins] x
        [S2, bins] -> np.int32 [Pr, S2]. Pads partner rows to a mesh-axis
        multiple with zero-count rows (min-sum 0, sliced off); routes the
        int8 threshold matmuls (int8_cmax) or the Pallas kernel per shard
        exactly like the single-card engine."""
        from dna_kmeres_parallel.parallel.mesh import DATA_AXIS
        from dna_kmeres_parallel.parallel.sharded_count import (
            min_sum_panel_sharded,
        )

        D = mesh.shape[DATA_AXIS]
        S2 = other.shape[0]
        pad = (-S2) % D
        if pad:
            other = jnp.pad(other, ((0, pad), (0, 0)))
        sums = min_sum_panel_sharded(
            panel, other, mesh, pallas=self._kernel(), int8_cmax=int8_cmax
        )
        return np.asarray(sums)[:, :S2]

    # ------------------------------------------------------------- ingest
    def _parse(self, source) -> list[fasta.FastaRecord]:
        cfg = self.config
        if cfg.parser_variant == "modern":
            return fasta.parse_fasta(source, max_seqs=cfg.max_seqs)
        return fasta.parse_fasta_reference(
            source, variant=cfg.parser_variant, max_seqs=cfg.max_seqs
        )

    def _flat_stream(self, seqs: list[str]) -> tuple[np.ndarray, int]:
        """Concatenate base codes with 1 invalid sentinel between sequences
        (the shared codec helper — one implementation of the invariant)."""
        flat = codec.concat_with_sentinels(seqs)
        return flat, flat.shape[0]

    # ------------------------------------------------------------- counting
    def count_stream(
        self, flat: np.ndarray, total_bases: int, n_seqs: int
    ) -> CountResult:
        """Count a pre-encoded flat base stream (uint8 codes, 0xFF sentinels
        between sequences) — the native-parser fast path."""
        cfg = self.config
        t0 = time.perf_counter()
        # Medium-dense bins (k=9..15): count sparse and materialize the
        # dense histogram once at the end (codes are unique, so it's a
        # direct indexed store, not a scatter-add).
        if (1 << 16) < cfg.bins and total_bases > 0:
            from dna_kmeres_parallel.models.sparse_engine import (
                SparseKmerEngine,
                dense_from_sparse,
            )

            sp = SparseKmerEngine(cfg).count_stream(flat, total_bases, n_seqs)
            hist = dense_from_sparse(sp, cfg.bins)
            return CountResult(
                k=cfg.k,
                canonical=cfg.canonical,
                hist=hist,
                n_seqs=n_seqs,
                total_bases=total_bases,
                elapsed_s=time.perf_counter() - t0,
            )
        hist = np.zeros(cfg.bins, dtype=np.int64)
        total = flat.shape[0]
        if total >= cfg.k:
            overlap = cfg.k - 1
            # Inputs smaller than one batch use a power-of-two shape bucket
            # (bounded compile count); larger inputs stream through a single
            # fixed batch shape (one compile).
            batch = max(min(cfg.batch_bases, _pow2_bucket(total)), cfg.k)
            T = _round_up(batch + overlap, _LANE)
            # Accumulate on DEVICE (async dispatch pipelines host prep with
            # device compute — no per-batch device->host sync), flushing to
            # the host int64 histogram before int32 could overflow.
            acc = None
            acc_windows = 0
            flush_limit = (1 << 31) - (1 << 27)
            start = 0
            while start < total:
                end = min(start + batch, total)
                # Each chunk owns windows *starting* in [start, end); the
                # halo [end, end+k-1) completes the tail windows.
                seg = flat[start : min(end + overlap, total)]
                padded = np.full(T, codec.INVALID_BASE, dtype=np.uint8)
                padded[: seg.shape[0]] = seg
                if cfg.pack_input:
                    staged = stage_batch(padded, True)
                    args = (*staged, jnp.int32(end - start))
                    batch_fn, acc_fn = _count_batch_packed, _count_batch_acc_packed
                else:
                    staged = stage_batch(padded, False)
                    args = (staged, jnp.int32(end - start))
                    batch_fn, acc_fn = _count_batch, _count_batch_acc
                if acc is None:
                    acc = batch_fn(*args, cfg.k, cfg.bins, cfg.canonical)
                else:
                    acc = acc_fn(acc, *args, cfg.k, cfg.bins, cfg.canonical)
                acc_windows += end - start
                if acc_windows >= flush_limit:
                    hist += np.asarray(acc, dtype=np.int64)
                    acc, acc_windows = None, 0
                start = end
            if acc is not None:
                hist += np.asarray(acc, dtype=np.int64)
        return CountResult(
            k=cfg.k,
            canonical=cfg.canonical,
            hist=hist,
            n_seqs=n_seqs,
            total_bases=total_bases,
            elapsed_s=time.perf_counter() - t0,
        )

    def count_sequences(self, seqs: list[str]) -> CountResult:
        flat, _total = self._flat_stream(seqs)
        return self.count_stream(flat, sum(len(s) for s in seqs), len(seqs))

    def count_file(self, source) -> CountResult:
        """Count a FASTA file. Prefers the native C++ parse->encode path
        (one pass, no Python string materialization)."""
        from dna_kmeres_parallel import native

        if (
            self.config.parser_variant == "modern"
            and isinstance(source, (str, os.PathLike))
            and native.available()
        ):
            parsed = native.parse_fasta_native(
                source, max_seqs=self.config.max_seqs
            )
            return self.count_stream(
                parsed.stream, parsed.total_bases, parsed.n_seqs
            )
        records = self._parse(source)
        return self.count_sequences([r.seq for r in records])

    # ------------------------------------------------------------- distances
    def counts_matrix(self, seqs: list[str]) -> np.ndarray:
        """Per-sequence count vectors [S, 4^k] int32.

        Sequences are grouped into power-of-two length buckets so mixed
        lengths don't all pad to the global max (the reference pads nothing
        but rescans per k-mer; here padding is the only waste and bucketing
        bounds it at 2x).
        """
        cfg = self.config
        S = len(seqs)
        out = np.zeros((S, cfg.bins), dtype=np.int32)
        if S == 0:
            return out
        buckets: dict[int, list[int]] = {}
        for i, s in enumerate(seqs):
            Lp = _round_up(max(_pow2_bucket(max(len(s), 1)), cfg.k), _LANE)
            buckets.setdefault(Lp, []).append(i)
        for Lp, idxs in buckets.items():
            # Row counts are power-of-two bucketed too: a data-dependent
            # row count would compile a fresh device program per call;
            # INVALID rows produce all-zero counts and are sliced off below.
            rows_p = _pow2_bucket(len(idxs))
            grid = np.full((rows_p, Lp), codec.INVALID_BASE, dtype=np.uint8)
            for row, i in enumerate(idxs):
                grid[row, : len(seqs[i])] = codec.encode_bases(seqs[i])
            counts = np.asarray(
                _counts_matrix_batch(
                    jnp.asarray(grid), cfg.k, cfg.bins, cfg.canonical
                )
            )
            out[np.asarray(idxs)] = counts[: len(idxs)]
        return out

    def distance_sequences(
        self, seqs: list[str], ids: list[str] | None = None
    ) -> DistanceResult:
        cfg = self.config
        t0 = time.perf_counter()
        n = len(seqs)
        counts = self.counts_matrix(seqs)
        lengths = np.array([len(s) for s in seqs], dtype=np.int64)
        kernel = self._kernel()
        mesh = self._mesh()
        int8_cmax = self._int8_dist_cmax(counts) if n else None
        sums = None  # [S, S] int32 min-sums; None -> XLA packed path
        if mesh is not None and n:
            # Multi-card: one partner-sharded panel covering all rows —
            # every device runs the same (threshold-/Pallas-routed) kernel
            # as the single-card path; integer sums, so the distances are
            # bit-identical at any device count.
            sums = self._min_sum_panel_mesh(
                jnp.asarray(counts), jnp.asarray(counts), mesh,
                int8_cmax=int8_cmax,
            )
        elif int8_cmax is not None:
            # int8 threshold route: cmax boolean matmuls on the tensor
            # cores — the low-multiplicity regime's fast path
            # (ops/distance.min_sum_matrix_int8; exact, gated above).
            sums = np.asarray(
                dist_ops.min_sum_matrix_int8(jnp.asarray(counts), int8_cmax)
            )
        elif kernel is not None and n:
            # Triangle-only grid: ~2x fewer tiles than the full matrix
            # (min is symmetric).
            sums = np.asarray(
                distance_pallas.min_sum_matrix_pallas(
                    jnp.asarray(counts), interpret=(kernel == "interpret")
                )
            )
        if sums is not None:
            square = dist_ops.finish_distances(sums, lengths, cfg.k)
            rows, cols = np.triu_indices(n, k=1)
            packed = square[rows, cols]
        else:
            packed = dist_ops.distance_matrix_packed(
                jnp.asarray(counts), jnp.asarray(lengths, dtype=jnp.int32), cfg.k
            )
        return DistanceResult(
            k=cfg.k,
            n=n,
            ids=ids or [f">seq{i}" for i in range(n)],
            packed=np.asarray(packed),
            counts=counts,
            elapsed_s=time.perf_counter() - t0,
            route=self._route(int8_cmax),
        )

    def distance_file(self, source) -> DistanceResult:
        records = self._parse(source)
        return self.distance_sequences(
            [r.seq for r in records], ids=[r.id for r in records]
        )

    def distance_stream_to_csv(
        self,
        seqs: list[str],
        output_path,
        panel_rows: int = 2048,
        checkpoint_path=None,
        max_panels: int | None = None,
        row_lo: int = 0,
        row_hi: int | None = None,
    ) -> dict:
        """Large-S distance path: the [S, S] matrix never materializes.

        Counts live on device ([S, bins] int32 — tiny); the (min,+) matrix
        is computed one row panel at a time (Pallas panel kernel;
        partner-sharded over the mesh when config.mesh_shape is set) and
        each panel's packed strict-upper-triangle entries are appended to
        the CSV in reference format. Handles the reference's design-target
        scale (54K sequences -> 1.46G pairs) in bounded memory.

        checkpoint_path: make the run preemption-safe (SURVEY.md §5 —
        this is the framework's single longest job at design scale) via
        the shared writer (models/distance_stream.py): the CSV appends
        panel-at-a-time with fsync-then-checkpoint durability; resume is
        byte-identical to a single-shot run. max_panels bounds the
        panels processed this call (testing / cooperative yielding).
        row_lo/row_hi stream only that row block (multi-host row
        sharding — parallel/multihost.py concatenates the shards).
        """
        cfg = self.config
        S = len(seqs)
        counts_np = self.counts_matrix(seqs)
        int8_cmax = self._int8_dist_cmax(counts_np) if S else None
        lengths = np.array([len(s) for s in seqs], dtype=np.int64)
        panel_fn = self.make_dense_panel_fn(
            counts_np, lengths, panel_rows, int8_cmax=int8_cmax
        )
        meta = {
            "k": cfg.k,
            "canonical": cfg.canonical,
            "n_seqs": S,
            "regime": "dense",
            "input_sha": distance_stream.input_fingerprint(seqs),
        }
        report = distance_stream.stream_panels_to_csv(
            output_path,
            S,
            panel_rows,
            panel_fn,
            meta=meta,
            checkpoint_path=checkpoint_path,
            max_panels=max_panels,
            row_lo=row_lo,
            row_hi=row_hi,
        )
        report["route"] = self._route(int8_cmax)
        return report

    def make_dense_panel_fn(
        self, counts_np, lengths, panel_rows: int, int8_cmax=None
    ):
        """Packed-panel closure over the dense [S, bins] counts matrix:
        panel_fn(r0, r1) -> float32 flat packed distances for rows
        r0..r1 (each row i: columns i+1..S), routed exactly like
        distance_sequences (mesh panel / int8 thresholds / Pallas / XLA)
        with the host IEEE float finish."""
        cfg = self.config
        S = int(counts_np.shape[0])
        counts = jnp.asarray(counts_np)
        kernel = self._kernel()
        mesh = self._mesh()
        # Shape discipline: every panel is padded to [panel_rows, bins] and
        # the partner matrix to a power-of-two-ish column bucket, so the
        # whole run compiles a HANDFUL of device programs (a naive
        # counts[r0:] trim would trace a fresh program per panel — ~30
        # compiles at the 54K design scale). The trim itself stays:
        # only columns >= r0 are computed/fetched, halving both the (min,+)
        # work and the D2H volume across the run.
        col_bucket = max(panel_rows, 16384)
        counts_p = jnp.pad(counts, ((0, panel_rows), (0, 0)))
        lengths = np.asarray(lengths, dtype=np.int64)

        def panel_fn(r0: int, r1: int) -> np.ndarray:
            rp = r1 - r0
            panel = counts_p[r0 : r0 + panel_rows]
            n_cols = min(_round_up(S - r0, col_bucket), S)
            other = counts[S - n_cols :]
            base = S - n_cols  # first column's sequence index
            if mesh is not None:
                sums = self._min_sum_panel_mesh(
                    panel, other, mesh, int8_cmax=int8_cmax
                )[:rp]
            elif int8_cmax is not None:
                sums = np.asarray(
                    dist_ops.min_sum_matrix_int8(panel, int8_cmax, other)
                )[:rp]
            elif kernel is not None:
                sums = np.asarray(
                    distance_pallas.min_sum_matrix_pallas(
                        panel, other, interpret=(kernel == "interpret")
                    )
                )[:rp]
            else:
                sums = np.asarray(
                    dist_ops.min_sum_matrix(panel, counts_other=other)
                )[:rp]
            d = dist_ops.finish_distances_panel(
                sums, lengths[r0:r1], lengths[base:], cfg.k
            )
            # Pack the panel's strict-upper-triangle entries (row i
            # keeps columns i+1..S) into one flat array; the shared
            # writer formats it through the native %f formatter.
            rows = [d[i - r0, (i - base) + 1 :] for i in range(r0, r1)]
            return (
                np.concatenate(rows) if rows else np.empty(0, np.float32)
            )

        return panel_fn

    # ------------------------------------------------------------- verification
    def verify_against_oracle(self, seqs: list[str]) -> dict:
        """Differential check (the formalization of the reference's dual-engine
        CSV-diff strategy, SURVEY.md §4): exact count + distance equality."""
        cfg = self.config
        got = self.count_sequences(seqs)
        want = sum(
            (oracle.count_vector(s, cfg.k, cfg.canonical) for s in seqs),
            np.zeros(cfg.bins, dtype=np.int64),
        )
        counts_equal = bool(np.array_equal(got.hist, want))
        d_got = self.distance_sequences(seqs).packed
        d_want = oracle.distance_matrix_packed(seqs, cfg.k, cfg.canonical)
        dist_equal = bool(np.array_equal(d_got, d_want))
        return {
            "counts_equal": counts_equal,
            "distances_equal": dist_equal,
            "n_seqs": len(seqs),
            "total_kmers": int(want.sum()),
        }
