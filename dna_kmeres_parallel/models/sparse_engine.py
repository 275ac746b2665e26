"""Sparse (sorted-table) counting engine for large k (16 <= k <= 31).

Streams the flat base stream through ops/sparse.sort_unique_counts in fixed
batches, compacts each batch's masked RLE output on host, and merges batch
tables with an integer sorted-merge. Counts are exact (pure integer), and
the result is a sorted (code_u64 -> count) table — the representation the
k=21 / k=31 BASELINE configs require once 4^k outgrows HBM.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from dna_kmeres_parallel.ops import sparse as sparse_ops
from dna_kmeres_parallel.utils import codec
from dna_kmeres_parallel.utils.config import KmerConfig

_LANE = 128


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def fetch_words(words) -> tuple[np.ndarray, ...]:
    """D2H fetch of device word planes."""
    return tuple(np.asarray(w) for w in words)


def dense_from_sparse(sp: "SparseCountResult", bins: int) -> np.ndarray:
    """Materialize a dense int64 histogram from a sparse result — the
    shared k=9..12 densify step (codes are unique, so this is an indexed
    store, not a scatter-add)."""
    hist = np.zeros(bins, dtype=np.int64)
    hist[sp.codes.astype(np.int64)] = sp.counts
    return hist


def resolve_device_sort(cfg: KmerConfig) -> bool:
    """Resolve KmerConfig.device_sort=None: skip the device sort exactly
    when the native radix compactor can absorb unsorted words."""
    if cfg.device_sort is not None:
        return cfg.device_sort
    from dna_kmeres_parallel import native

    return not native.available()


def compact_table(words) -> tuple[np.ndarray, np.ndarray]:
    """Sorted device code words -> (codes_u64, counts_i64).

    Accepts both layouts: flat 1-D words (ops/sparse.sort_words) and
    row-sorted 2-D [rows, m] words (ops/sparse.sort_words_rows — each row
    independently sorted; the multiway merge happens here on the host).
    Run boundaries and lengths both come from neighbor compares during the
    host pass (no device-side flags). Native multithreaded compactor when
    available.
    """
    from dna_kmeres_parallel import native

    words = fetch_words(words)
    if words[0].ndim == 2:
        if native.available():
            return native.compact_rows_native(words)
        # Fallback: drop sentinels, merge rows with one flat np sort + RLE.
        major = words[0]
        sent = major.dtype.type(np.iinfo(major.dtype).max)
        valid = major != sent
        if len(words) == 1:
            codes_all = words[0][valid].astype(np.uint64)
        else:
            codes_all = sparse_ops.merged_code64(words[0][valid], words[1][valid])
        if codes_all.size == 0:
            return np.zeros(0, np.uint64), np.zeros(0, np.int64)
        codes_all = np.sort(codes_all)
        starts = np.empty(codes_all.shape[0], bool)
        starts[0] = True
        np.not_equal(codes_all[1:], codes_all[:-1], out=starts[1:])
        idx = np.flatnonzero(starts)
        counts = np.diff(np.append(idx, codes_all.shape[0])).astype(np.int64)
        return codes_all[idx], counts
    if native.available():
        return native.compact_sorted_native(words)
    major = words[0]
    sent = major.dtype.type(np.iinfo(major.dtype).max)
    end = int(np.searchsorted(major, sent))
    if end == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    if len(words) == 1:
        codes_all = words[0][:end].astype(np.uint64)
    else:
        codes_all = sparse_ops.merged_code64(words[0][:end], words[1][:end])
    starts = np.empty(end, bool)
    starts[0] = True
    np.not_equal(codes_all[1:], codes_all[:-1], out=starts[1:])
    idx = np.flatnonzero(starts)
    counts = np.diff(np.append(idx, end)).astype(np.int64)
    return codes_all[idx], counts


def compact_unsorted(words, k: int) -> tuple[np.ndarray, np.ndarray]:
    """UNSORTED device code words (ops/sparse.encode_words output; all-ones
    sentinels interspersed) -> (codes_u64, counts_i64).

    The host half of the no-device-sort route: an MSD+LSD radix compactor
    whose cost is a constant ~6 memory touches per element — no device sort
    needed, no merge fan-in. Native when available; the NumPy fallback
    filters sentinels and sorts flat.
    """
    from dna_kmeres_parallel import native

    words = tuple(w.reshape(-1) for w in fetch_words(words))
    if native.available():
        return native.compact_unsorted_native(words, 2 * k)
    major = words[0]
    sent = major.dtype.type(np.iinfo(major.dtype).max)
    valid = major != sent
    if len(words) == 1:
        codes_all = words[0][valid].astype(np.uint64)
    else:
        codes_all = sparse_ops.merged_code64(words[0][valid], words[1][valid])
    if codes_all.size == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    codes_all = np.sort(codes_all)
    starts = np.empty(codes_all.shape[0], bool)
    starts[0] = True
    np.not_equal(codes_all[1:], codes_all[:-1], out=starts[1:])
    idx = np.flatnonzero(starts)
    counts = np.diff(np.append(idx, codes_all.shape[0])).astype(np.int64)
    return codes_all[idx], counts


def compact_starts(words, starts) -> tuple[np.ndarray, np.ndarray]:
    """Sorted device code words + run-start flags -> (codes_u64, counts_i64).

    Run lengths are derived from consecutive start indices (ops/sparse
    no longer computes them on device — they cost a device scan and a
    4-bytes-per-window transfer for information the indices already carry).
    Native C++ two-pass multithreaded compactor when available; the Python
    fallback is flatnonzero + diff.
    """
    from dna_kmeres_parallel import native

    words = fetch_words(words)
    starts = np.asarray(starts)
    if native.available():
        return native.compact_starts_native(words, starts)
    major = words[0]
    sent = major.dtype.type(np.iinfo(major.dtype).max)  # all-ones sentinel
    end = int(np.searchsorted(major, sent))  # sorted: sentinel tail begins
    idx = np.flatnonzero(starts[:end])
    counts = np.diff(np.append(idx, end)).astype(np.int64)
    if len(words) == 1:
        codes = words[0][idx].astype(np.uint64)
    else:
        codes = sparse_ops.merged_code64(words[0][idx], words[1][idx])
    return codes, counts


def compact_rle(hi, lo, counts, starts) -> tuple[np.ndarray, np.ndarray]:
    """Back-compat: masked device RLE output (with device-computed counts)
    -> (codes_u64, counts_i64)."""
    from dna_kmeres_parallel import native

    hi = np.asarray(hi)
    lo = np.asarray(lo)
    counts = np.asarray(counts)
    starts = np.asarray(starts)
    if native.available():
        return native.compact_rle_native(hi, lo, counts, starts)
    idx = np.flatnonzero(starts)
    return (
        sparse_ops.merged_code64(hi[idx], lo[idx]),
        counts[idx].astype(np.int64),
    )


def merge_sparse_tables(
    tables: list[tuple[np.ndarray, np.ndarray]]
) -> tuple[np.ndarray, np.ndarray]:
    """Merge [(codes_u64 sorted-unique, counts int64), ...] into one.

    Native path: multithreaded k-way heap merge partitioned by sampled
    code-range pivots — O(n log m) with no giant argsort. (The np fallback
    argsort over the concatenation costs minutes at the 1-GB/k=21 scale
    where the merged inputs approach 1e9 entries.)
    """
    tables = [t for t in tables if t[0].size]
    if not tables:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    if len(tables) == 1:
        return tables[0]
    from dna_kmeres_parallel import native

    if native.available():
        return native.merge_tables_native(tables)
    codes = np.concatenate([t[0] for t in tables])
    counts = np.concatenate([t[1] for t in tables])
    # Introsort, not stable mergesort: grouping equal codes is all the
    # downstream sum needs, and it's ~2x faster at the 100M-entry scale.
    order = np.argsort(codes)
    codes, counts = codes[order], counts[order]
    uniq_mask = np.empty(codes.shape, bool)
    uniq_mask[0] = True
    np.not_equal(codes[1:], codes[:-1], out=uniq_mask[1:])
    group = np.cumsum(uniq_mask) - 1
    out_codes = codes[uniq_mask]
    out_counts = np.zeros(out_codes.shape[0], np.int64)
    np.add.at(out_counts, group, counts)
    return out_codes, out_counts


class MergeLadder:
    """Bounded-memory incremental merging of per-batch tables.

    Two levels (r4): incoming batch tables BUFFER up to ``buffer_max``
    and collapse in ONE native k-way heap pass (the heap is multiway —
    merging tables pairwise through an LSM ladder re-touched every
    element ~log2(batches) times, measured at ~40% of a 1-GBase
    coverage run's host wall); the collapsed runs then go through the
    geometric 2x ladder, so total merge work is
    O(n * (1 + log(batches / buffer_max))) with peak memory ~
    buffer_max batch tables + 2x the final table.
    """

    def __init__(self, buffer_max: int = 32):
        self._stack: list[tuple[np.ndarray, np.ndarray]] = []
        self._buffer: list[tuple[np.ndarray, np.ndarray]] = []
        self._buffer_max = max(buffer_max, 1)

    def _collapse(self) -> None:
        if not self._buffer:
            return
        run = (
            self._buffer[0]
            if len(self._buffer) == 1
            else merge_sparse_tables(self._buffer)
        )
        self._buffer = []
        self._stack.append(run)
        while (
            len(self._stack) >= 2
            and self._stack[-2][0].size <= 2 * self._stack[-1][0].size
        ):
            b = self._stack.pop()
            a = self._stack.pop()
            self._stack.append(merge_sparse_tables([a, b]))

    def push(self, table: tuple[np.ndarray, np.ndarray]) -> None:
        if not table[0].size:
            return
        self._buffer.append(table)
        if len(self._buffer) >= self._buffer_max:
            self._collapse()

    def result(self) -> tuple[np.ndarray, np.ndarray]:
        self._collapse()
        return merge_sparse_tables(self._stack)

    def reset_to(self, table: tuple[np.ndarray, np.ndarray]) -> None:
        """Replace all pending state with one merged table (checkpoint
        snapshots: the saved table becomes the sole base run)."""
        self._stack = []
        self._buffer = []
        self.push(table)


@dataclass
class SparseCountResult:
    k: int
    canonical: bool
    codes: np.ndarray  # uint64 sorted distinct k-mer codes
    counts: np.ndarray  # int64 counts aligned with codes
    n_seqs: int
    total_bases: int
    elapsed_s: float = 0.0

    @property
    def total_kmers(self) -> int:
        return int(self.counts.sum())

    @property
    def distinct_kmers(self) -> int:
        return int(self.codes.shape[0])

    def table(self) -> dict[str, int]:
        return {
            codec.code_to_kmer(int(c), self.k): int(n)
            for c, n in zip(self.codes, self.counts)
        }

    def count_of(self, kmer: str) -> int:
        code = codec.kmer_to_code(kmer)
        if self.canonical:
            # canonical tables key by min(code, rc): fold the query too, so
            # either strand's spelling finds its count
            code = min(code, codec.kmer_to_code(codec.revcomp_str(kmer)))
        code = np.uint64(code)
        i = np.searchsorted(self.codes, code)
        if i < self.codes.shape[0] and self.codes[i] == code:
            return int(self.counts[i])
        return 0


class SparseKmerEngine:
    """Single-host sparse engine; bucket-sharded multi-chip variant lives in
    parallel/bucketed.py."""

    def __init__(self, config: KmerConfig | None = None, **kw):
        self.config = (config or KmerConfig()).replace(**kw) if kw else (
            config or KmerConfig()
        )
        if not (1 <= self.config.k <= sparse_ops.MAX_SPARSE_K):
            raise ValueError(f"sparse engine supports k <= {sparse_ops.MAX_SPARSE_K}")

    def route(self) -> str:
        """Name of the device route count_stream takes (CLI report)."""
        sort = "device-sort" if resolve_device_sort(self.config) else "host-radix"
        return f"xla-encode+{sort}"

    def count_stream(
        self, flat: np.ndarray, total_bases: int, n_seqs: int
    ) -> SparseCountResult:
        cfg = self.config
        t0 = time.perf_counter()
        total = flat.shape[0]
        tables: list[tuple[np.ndarray, np.ndarray]] = []
        if total >= cfg.k:
            overlap = cfg.k - 1
            pow2 = 1 << (max(total, _LANE) - 1).bit_length()
            batch = max(min(cfg.batch_bases, pow2), cfg.k)
            T = _round_up(batch + overlap, _LANE)
            ladder = MergeLadder()
            start = 0
            from dna_kmeres_parallel.models.engine import stage_batch

            dev_sort = resolve_device_sort(cfg)
            while start < total:
                end = min(start + batch, total)
                seg = flat[start : min(end + overlap, total)]
                padded = np.full(T, codec.INVALID_BASE, dtype=np.uint8)
                padded[: seg.shape[0]] = seg
                staged = stage_batch(padded, cfg.pack_input)
                n_own = jnp.int32(end - start)
                if not dev_sort:
                    if cfg.pack_input:
                        words = sparse_ops.encode_words_packed(
                            *staged, n_own, cfg.k, cfg.canonical
                        )
                    else:
                        words = sparse_ops.encode_words(
                            staged, n_own, cfg.k, cfg.canonical
                        )
                    ladder.push(compact_unsorted(words, cfg.k))
                    start = end
                    continue
                if cfg.pack_input and cfg.sort_row_len:
                    words = sparse_ops.sort_words_rows_packed(
                        *staged, n_own, cfg.k, cfg.canonical,
                        row_len=cfg.sort_row_len,
                    )
                elif cfg.pack_input:
                    words = sparse_ops.sort_words_packed(
                        *staged, n_own, cfg.k, cfg.canonical
                    )
                elif cfg.sort_row_len:
                    words = sparse_ops.sort_words_rows(
                        staged, n_own, cfg.k, cfg.canonical,
                        row_len=cfg.sort_row_len,
                    )
                else:
                    words = sparse_ops.sort_words(
                        staged, n_own, cfg.k, cfg.canonical
                    )
                ladder.push(compact_table(words))
                start = end
            tables = [ladder.result()]
        codes, counts = merge_sparse_tables(tables)
        return SparseCountResult(
            k=cfg.k,
            canonical=cfg.canonical,
            codes=codes,
            counts=counts,
            n_seqs=n_seqs,
            total_bases=total_bases,
            elapsed_s=time.perf_counter() - t0,
        )

    def count_sequences(self, seqs: list[str]) -> SparseCountResult:
        flat = codec.concat_with_sentinels(seqs)
        return self.count_stream(flat, sum(len(s) for s in seqs), len(seqs))

    def count_file(self, source) -> SparseCountResult:
        import os

        from dna_kmeres_parallel import native
        from dna_kmeres_parallel.utils import fasta

        if (
            self.config.parser_variant == "modern"
            and isinstance(source, (str, os.PathLike))
            and native.available()
        ):
            parsed = native.parse_fasta_native(source, max_seqs=self.config.max_seqs)
            return self.count_stream(parsed.stream, parsed.total_bases, parsed.n_seqs)
        if self.config.parser_variant == "modern":
            records = fasta.parse_fasta(source, max_seqs=self.config.max_seqs)
        else:
            records = fasta.parse_fasta_reference(
                source,
                variant=self.config.parser_variant,
                max_seqs=self.config.max_seqs,
            )
        return self.count_sequences([r.seq for r in records])


def table_from_rle(
    words_c, counts, n_distinct
) -> tuple[np.ndarray, np.ndarray]:
    """Device-RLE output -> sorted-unique (codes_u64, counts_i64) table.

    Fetches ONLY the distinct prefix (the whole point of the mode): the
    distinct count comes down as one scalar, the prefix length is rounded
    up to a power-of-two bucket so the slice programs compile a bounded
    number of shapes, and uint16 hi planes ride the u32-bitcast fast path
    (fetch_words). No host radix — the table is already sorted-unique.
    """
    m = int(np.asarray(n_distinct))
    if m == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    n = int(counts.shape[0])
    mp = 1 << (m - 1).bit_length()  # shape bucket
    mp = min(max(mp, 128), n)
    planes = fetch_words(tuple(w[:mp] for w in words_c) + (counts[:mp],))
    cnt = planes[-1][:m].astype(np.int64)
    ws = planes[:-1]
    if len(ws) == 1:
        codes = ws[0][:m].astype(np.uint64)
    else:
        hi = ws[0][:m].astype(np.uint64)
        codes = (hi << np.uint64(32)) | ws[1][:m].astype(np.uint64)
    return codes, cnt


#: per-sequence length above which the device sparse engine builds the
#: per-sequence distance table (below it the host rolling counter wins;
#: above it the device encoder + radix compactor amortize their dispatch
#: overhead and the host counter becomes the bottleneck).
_DEVICE_TABLE_MIN_BASES = 4 << 20


def dense_distance_feasible(
    n_seqs: int, k: int, budget_bytes: int | None = None
) -> bool:
    """Whether the dense distance path's [S, 4^k] int32 counts matrix fits
    the memory budget (KMER_DENSE_DIST_BUDGET bytes, default 2 GiB).

    The reference's distance design (/root/reference/kernels.h:85-109)
    assumes 4^k is tiny (64 bins at k=3). Mid-k (9..15) dense vectors
    overflow host RAM and HBM at moderate S — 4^13 bins is 268 MB per
    sequence — so distances route through per-sequence sparse tables
    (distance_sparse_packed) whenever the dense matrix would not fit.
    The gate is a memory budget, NOT a k threshold: small-S mid-k jobs
    keep the fast dense (min,+) path, large-S jobs degrade gracefully.

    Two engine realities are modeled, not just S * 4^k * 4:
    - the counts-matrix builder pads the row count to power-of-two
      buckets with a 128-row floor (engine.counts_matrix shape
      discipline), so tiny S does not shrink the device allocation;
    - the [S_padded, bins] int32 counts matrix must fit device memory
      with room for its transposed operands and the output panels
      (capped at 8 GiB) — this rules the dense path out for k >= 12 at
      any S regardless of how high the host-side budget is raised.
    """
    import os

    if budget_bytes is None:
        budget_bytes = int(
            os.environ.get("KMER_DENSE_DIST_BUDGET", str(2 << 30))
        )
    bins = 4**k
    s_padded = max(128, 1 << max(int(n_seqs) - 1, 0).bit_length())
    dense_bytes = s_padded * bins * 4
    if dense_bytes >= (8 << 30):  # device HBM cap (counts + panels)
        return False
    return dense_bytes <= budget_bytes


#: Host two-pointer rate, entry-pair steps/s per thread, on ~1e3-entry
#: tables (ops/calibrate.measure_compute's probe shape). Measured with
#: `kmers calibrate` on the 16-CPU host of an NVIDIA H100 80GB HBM3
#: (700 W power limit); a calibration on the running host replaces it.
_SPARSE_ENTRY_PAIRS_PER_SEC_PER_THREAD = 3.3e7


def dense_distance_preferred(
    n_seqs: int,
    k: int,
    seq_lengths=None,
    budget_bytes: int | None = None,
    host_threads: int | None = None,
) -> bool:
    """Cost-based dense-vs-sparse distance routing.

    dense_distance_feasible is a MEMORY gate only; mid-k (9..15) jobs
    that fit can still be orders of magnitude slower dense: the dense
    route pays ~4^k (min,+) terms per pair while the sparse-table route
    pays ~2*E[table entries] two-pointer steps per pair (~L-k+1 for
    random sequence) — at k=11 and 1-Kbase sequences that is 4.19M vs
    ~2K work items per pair. This gate routes on PREDICTED cost with the
    per-pair models (ops/distance; the Pallas kernel's where it runs,
    XLA's otherwise) against the host two-pointer rate, keeping the
    memory budget as a hard ceiling:

      dense iff feasible AND t_dense(bins) <= avg_table / (C_sparse * threads)

    k <= 8 always prefers dense when feasible. seq_lengths=None assumes
    tables at the dense-equivalent size (prefers dense). host_threads
    defaults to the host's CPU count.
    """
    from dna_kmeres_parallel import native
    from dna_kmeres_parallel.ops import distance as dist_ops
    from dna_kmeres_parallel.ops import runtime

    if not dense_distance_feasible(n_seqs, k, budget_bytes):
        return False
    if k <= 8 or seq_lengths is None:
        return True
    if not native.available():
        # The sparse constants model the native THREADED two-pointer; the
        # pure-Python fallback is orders of magnitude slower than the
        # dense device route — keep the memory-only behavior.
        return True
    bins = 4**k
    lengths = np.asarray(seq_lengths, dtype=np.float64)
    if lengths.size == 0:
        return True
    avg_table = float(
        np.minimum(np.maximum(lengths - k + 1, 1), bins).mean()
    )
    if runtime.backend().kernel is not None:
        dense_s_per_pair = dist_ops.tri_time_per_pair(bins)
    else:
        dense_s_per_pair = dist_ops.jnp_time_per_pair(bins)
    sparse_s_per_pair = avg_table / (
        _sparse_entry_rate_per_thread() * _host_threads(host_threads)
    )
    return dense_s_per_pair <= sparse_s_per_pair


def _host_threads(host_threads: int | None) -> int:
    import os

    if host_threads is not None:
        return max(int(host_threads), 1)
    return max(os.cpu_count() or 1, 1)


def _sparse_entry_rate_per_thread() -> float:
    from dna_kmeres_parallel.ops import calibrate

    return float(
        calibrate.get_calibration().get(
            "sparse_entry_pairs_per_sec_per_thread",
            _SPARSE_ENTRY_PAIRS_PER_SEC_PER_THREAD,
        )
    )


#: The union route's device-time predictions share the per-pair models in
#: ops.distance (int8/tri/jnp_time_per_pair) and the threshold unroll cap
#: (ops.distance.INT8_CMAX_DEFAULT). The link terms below are the
#: `kmers calibrate` link measurement on the host of an NVIDIA H100
#: 80GB HBM3 (700 W power limit); a calibration on the running host
#: replaces them.
#: Fixed per-job device cost (dispatch + small-fetch roundtrip): keeps
#: tiny jobs on the host, where the two-pointer finishes before the
#: device program would even launch.
_DEVICE_JOB_OVERHEAD_S = 6.6e-4
#: H2D rate the cost model charges for shipping the [Sp, Dp] matrix
#: (KMER_H2D_BPS overrides both link legs).
_H2D_BYTES_PER_SEC_DEFAULT = 2.8e9


def union_dense_plan(
    codes,
    cnts,
    offs,
    *,
    budget_bytes: int | None = None,
    panel_rows: int | None = None,
    host_threads: int | None = None,
) -> dict | None:
    """Routing plan for the UNION-INDEXED dense distance route, or None.

    The sparse-table regime (k >= 12, or mid-k past the memory budget)
    pays a host two-pointer intersection per pair because the dense
    [S, 4^k] matrix cannot exist. But the pairwise min-sum only ever
    touches codes that OCCUR: re-indexing every table against the sorted
    union of distinct codes yields a dense [S, D] counts matrix over
    D = |union| "observed bins", and the existing device (min,+) routes
    (int8 threshold matmuls / Pallas kernel / XLA) apply unchanged — exact,
    because absent codes contribute min(0, .) = 0 exactly as the 4^k
    formulation's empty bins do. For high-sharing data (read sets at
    coverage, related genomes — the data this tool exists for,
    /root/reference/main.cu:327-335) D is near the underlying genome
    length, orders of magnitude below S * E[table], and the device
    replaces the host's irregular merge.

    Gates (None keeps the host two-pointer):
    - KMER_DIST_UNION=0 disables, =1 forces consideration (tests /
      CPU); default requires an accelerator when the native threaded
      two-pointer exists (a native-less host prefers the device route
      whenever it fits — the pure-Python fallback is orders slower).
    - the [Sp, Dp] matrix (shape-bucketed; int8 when counts fit — 4x
      less H2D) must fit KMER_UNION_DIST_BUDGET bytes (default
      2 GiB — same ceiling philosophy as the dense gate), with the
      [Sp, Sp] output and device operands modeled in;
    - predicted device time (best sub-route + the link legs + the fixed
      dispatch floor) must beat the predicted host time (the host
      two-pointer rate times host_threads — the host's CPU count unless
      given);
    - int32 exactness: every per-sequence window total < 2^31.

    The returned plan carries the sorted union, chosen sub-route
    ('int8'|'pallas'|'jnp'; KMER_UNION_IMPL overrides), cmax, and the
    predicted times (logged by the CLI; pinned by routing tests).
    """
    import os

    from dna_kmeres_parallel import native
    from dna_kmeres_parallel.ops import runtime

    force = os.environ.get("KMER_DIST_UNION")
    if force == "0":
        return None
    S = int(offs.shape[0] - 1)
    N = int(codes.shape[0])
    if S < 2 or N == 0:
        return None
    have_native = native.available()
    be = runtime.backend()
    if force != "1" and not be.accelerator and have_native:
        return None
    if budget_bytes is None:
        budget_bytes = int(
            os.environ.get("KMER_UNION_DIST_BUDGET", str(2 << 30))
        )
    union = np.unique(codes)
    D = int(union.shape[0])
    # Shape buckets: S and D round up to powers of two (zero rows /
    # columns are exact — min(0, .) = 0), so a stream of jobs compiles a
    # BOUNDED set of device programs (a per-dataset shape would trace
    # one each).
    Sp = 1 << max(S - 1, 7).bit_length()
    Dp = 1 << max(D - 1, 127).bit_length()
    cmax_true = int(np.asarray(cnts).max(initial=0))
    # cmax rounds up to its power-of-two bucket (thresholds past the
    # true max contribute [a>=t][b>=t] = 0 — exact), so a stream of
    # jobs compiles a bounded set of device programs.
    cmax_b = (
        1 << max(cmax_true - 1, 0).bit_length() if cmax_true > 0 else 0
    )
    # Counts ship int8 (4x less H2D; the (min,+) routes widen on
    # device) only when the BUCKETED cmax fits too: the threshold
    # sub-route compares thresholds 1..cmax against the shipped dtype,
    # and an int8 (counts >= 128) wraps to (>= -128) = all-True — silent
    # corruption. cmax_b is a power of two, so this means
    # cmax_true <= 64.
    itemsize = 1 if cmax_b <= 127 else 4
    # Host matrix + two device operands (shipped + widened/threshold
    # planes) + the output, at PADDED shapes: the one-shot route
    # materializes the [Sp, Sp] int32 square AND its packed-int64
    # triangle (~Sp^2*4 again); the STREAMED route (panel_rows set,
    # models/distance_stream.py) only ever holds one [panel, Sp] slab —
    # that is what lets design-scale S ride the device.
    out_bytes = (
        Sp * Sp * 8
        if panel_rows is None
        else min(panel_rows, Sp) * Sp * 8
    )
    approx_bytes = Sp * Dp * (itemsize * 2 + 4) + out_bytes
    if approx_bytes > budget_bytes:
        return None
    # Per-sequence window totals via cumsum at the offsets (reduceat
    # cannot express empty segments — a sequence shorter than k has one).
    cs = np.concatenate(
        [[0], np.cumsum(np.asarray(cnts, dtype=np.int64))]
    )
    per_seq_windows = cs[np.asarray(offs[1:])] - cs[np.asarray(offs[:-1])]
    if per_seq_windows.size and int(per_seq_windows.max()) >= (1 << 31):
        return None
    avg_table = N / S

    from dna_kmeres_parallel.ops import distance as dist_ops

    cands: dict[str, float] = {
        "jnp": dist_ops.jnp_time_per_pair(Dp),
    }
    # The threshold sub-route honors the SAME env knobs as the engine's dense
    # gate: KMER_DIST_INT8=0 disables it, KMER_INT8_CMAX caps the
    # unroll (a user who pinned routing away from the matmul chain must
    # reach this route's sub-selection too).
    int8_limit_env = os.environ.get("KMER_INT8_CMAX")
    int8_limit = (
        int(int8_limit_env) if int8_limit_env else dist_ops.INT8_CMAX_DEFAULT
    )
    if (
        os.environ.get("KMER_DIST_INT8") != "0"
        and 0 < cmax_b <= int8_limit
    ):
        cands["int8"] = dist_ops.int8_time_per_pair(Dp, cmax_b)
    if be.kernel is not None:
        cands["pallas"] = dist_ops.tri_time_per_pair(Dp)
    impl_force = os.environ.get("KMER_UNION_IMPL")
    if impl_force in cands:
        impl = impl_force
    else:
        impl = min(cands, key=cands.get)
    t_dev_pair = cands[impl]
    pairs = S * (S - 1) / 2.0
    # Device routes execute over the PADDED Sp rows (the int8/jnp
    # sub-routes compute the full padded square) — charge them for it.
    pairs_exec = Sp * (Sp - 1) / 2.0
    if have_native:
        t_host_pair = avg_table / (
            _sparse_entry_rate_per_thread() * _host_threads(host_threads)
        )
    else:
        # Pure-Python np.intersect1d per pair: per-pair sort/merge work
        # plus interpreter overhead — rough, but the decision it gates
        # differs by orders of magnitude wherever it fires.
        t_host_pair = 5e-5 + avg_table / 2e7
    # Link rates: the MEASURED per-backend link calibration is the
    # default (measured once on an accelerator and persisted beside the
    # compile cache). KMER_H2D_BPS overrides both legs (explicit
    # operator knowledge wins); the built-in constants are the last
    # fallback.
    from dna_kmeres_parallel.ops import calibrate

    cal = calibrate.get_calibration()
    h2d_env = os.environ.get("KMER_H2D_BPS")
    if h2d_env:
        h2d_bps = d2h_bps = float(h2d_env)
    else:
        h2d_bps = float(cal.get("h2d_bps", _H2D_BYTES_PER_SEC_DEFAULT))
        d2h_bps = float(cal.get("d2h_bps", h2d_bps))
    overhead_s = float(cal.get("roundtrip_s", _DEVICE_JOB_OVERHEAD_S))
    t_dev_total = (
        pairs_exec * t_dev_pair
        + overhead_s
        # matrix H2D + [S, S] min-sum D2H (padding rows are sliced off
        # on device before the fetch), each charged at its measured
        # link rate.
        + Sp * Dp * itemsize / h2d_bps
        + S * S * 4 / d2h_bps
    )
    if force != "1" and t_dev_total >= pairs * t_host_pair:
        return None
    return {
        "union": union,
        "D": D,
        "Sp": Sp,
        "Dp": Dp,
        "cmax": cmax_b,
        "cmax_true": cmax_true,
        "impl": impl,
        "t_dev_total": t_dev_total,
        "t_host_pair": t_host_pair,
    }


def union_matrix(codes, cnts, offs, plan) -> np.ndarray:
    """The [Sp, Dp] union-indexed counts matrix a union_dense_plan
    executes over. Bucketed shape (see union_dense_plan): zero
    rows/columns are exact and keep the compiled-program count bounded.
    Counts ship int8 (widened on device by the (min,+) routes) only when
    the BUCKETED cmax fits int8 — the threshold sub-route thresholds
    against the shipped dtype and an int8 (>= 128) wraps."""
    S = int(offs.shape[0] - 1)
    dtype = np.int8 if plan["cmax"] <= 127 else np.int32
    mat = np.zeros((plan["Sp"], plan["Dp"]), dtype=dtype)
    rows = np.repeat(np.arange(S, dtype=np.int64), np.diff(offs))
    mat[rows, np.searchsorted(plan["union"], codes)] = np.asarray(
        cnts
    ).astype(dtype)
    return mat


def union_dense_min_sums(codes, cnts, offs, plan) -> np.ndarray:
    """Execute a union_dense_plan: packed strict-upper-triangle int64
    pair min-sums via the planned device sub-route over the [S, D]
    union-indexed counts matrix (exact; see union_dense_plan)."""
    from dna_kmeres_parallel.ops import distance as dist_ops
    from dna_kmeres_parallel.ops import distance_pallas, runtime

    S = int(offs.shape[0] - 1)
    mat = union_matrix(codes, cnts, offs, plan)
    impl = plan["impl"]
    if impl == "int8":
        # Thresholds compare the shipped dtype directly — no widening.
        sq_dev = dist_ops.min_sum_matrix_int8(jnp.asarray(mat), plan["cmax"])
    elif impl == "pallas":
        # Triangle-only grid; the kernel widens int8 to int32 on device.
        sq_dev = distance_pallas.min_sum_matrix_pallas(
            jnp.asarray(mat),
            interpret=(runtime.backend().kernel == "interpret"),
        )
    else:
        # Widen ON DEVICE first — min_sum_matrix's integer sum would
        # overflow int8 accumulation on a narrow-shipped matrix.
        sq_dev = dist_ops.min_sum_matrix(jnp.asarray(mat).astype(jnp.int32))
    # Slice the padding rows off ON DEVICE before the fetch (up to ~4x
    # less D2H when Sp rounded S up).
    sq = np.asarray(sq_dev[:S, :S])
    # Rowwise triangle extraction (same discipline as
    # finish_distances_packed): np.triu_indices would materialize two
    # pairs-sized int64 index arrays plus a fancy-index copy — ~3x the
    # packed output again in transients.
    out = np.empty(S * (S - 1) // 2, dtype=np.int64)
    w = 0
    for i in range(S - 1):
        m = S - 1 - i
        out[w : w + m] = sq[i, i + 1 :]
        w += m
    return out


def min_sum_pairs_python(codes, counts, offs) -> np.ndarray:
    """Pure-NumPy fallback of native.min_sum_pairs_native (sorted-table
    pairwise intersection min-sums); exact, for native-less hosts."""
    S = offs.shape[0] - 1
    out = np.zeros(max(S * (S - 1) // 2, 1), dtype=np.int64)
    w = 0
    for i in range(S - 1):
        ci = codes[offs[i] : offs[i + 1]]
        ni = counts[offs[i] : offs[i + 1]]
        for j in range(i + 1, S):
            cj = codes[offs[j] : offs[j + 1]]
            nj = counts[offs[j] : offs[j + 1]]
            _, ia, ib = np.intersect1d(
                ci, cj, assume_unique=True, return_indices=True
            )
            out[w] = np.minimum(ni[ia], nj[ib]).sum()
            w += 1
    return out[: S * (S - 1) // 2]


def distance_sparse_packed(
    seqs: list[str], k: int, canonical: bool = False,
    info: dict | None = None,
) -> np.ndarray:
    """Pairwise k-mer distances over SPARSE per-sequence tables — the
    regime where the reference's dense [4^k] count vectors
    (/root/reference/kernels.h:85-109) cannot exist: every k > 15, and
    mid-k (9..15) whenever [S, 4^k] overflows the memory budget (see
    dense_distance_feasible). Completes the framework's distance
    capability for every k its counting supports.

    Routing: when the distinct-code UNION across the tables is small
    (high-sharing data — read sets, related genomes), the job is
    re-indexed to a dense [S, |union|] matrix and the device (min,+)
    routes serve it (union_dense_plan, cost-gated). Otherwise the
    pairwise sorted-table intersection — an irregular two-pointer merge
    with data-dependent advance, no matrix shape — runs
    on the host (native kp_min_sum_pairs, threaded) next to the radix
    compactor that builds the tables. The float32 finish follows
    contract point 4 (SURVEY.md §2.4.4: host IEEE division) either way.
    Table building routes like counting does: the host rolling counter
    for short sequences, the device sparse engine for sequences past
    _DEVICE_TABLE_MIN_BASES (where the device encoder amortizes).

    info: optional dict the chosen route / union stats are written into
    (CLI reporting, routing tests).

    Returns the packed strict-upper-triangle float32 distance vector
    (same layout/format as the dense engine's, contract point 5).
    """
    codes, cnts, offs = build_pair_tables(seqs, k, canonical)
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    plan = union_dense_plan(codes, cnts, offs)
    if plan is not None:
        try:
            sums = union_dense_min_sums(codes, cnts, offs, plan)
        except Exception as e:
            # A memory-allocation failure falls back to the host
            # two-pointer (it needs almost no memory) and is counted;
            # anything else raises.
            from dna_kmeres_parallel.ops import runtime

            if not runtime.host_alloc_failure(e, "union"):
                raise
            sums = None
        if sums is not None:
            if info is not None:
                info.update(
                    route=f"union/{plan['impl']}",
                    union_bins=plan["D"],
                    cmax=plan["cmax"],
                )
            return finish_distances_packed(sums, lengths, k)
    from dna_kmeres_parallel import native

    if native.available():
        sums = native.min_sum_pairs_native(codes, cnts, offs)
    else:
        sums = min_sum_pairs_python(codes, cnts, offs)
    if info is not None:
        info["route"] = "host/sparse"
    return finish_distances_packed(sums, lengths, k)


def min_sum_panel_python(codes, counts, offs, r0: int, r1: int) -> np.ndarray:
    """Pure-NumPy fallback of native.min_sum_panel_native: pair min-sums
    for rows [r0, r1), panel-locally packed."""
    S = offs.shape[0] - 1
    r0, r1 = max(r0, 0), min(r1, max(S - 1, 0))
    if r0 >= r1:
        return np.zeros(0, dtype=np.int64)
    parts = []
    for i in range(r0, r1):
        ci = codes[offs[i] : offs[i + 1]]
        ni = counts[offs[i] : offs[i + 1]]
        row = np.zeros(S - 1 - i, dtype=np.int64)
        for w, j in enumerate(range(i + 1, S)):
            cj = codes[offs[j] : offs[j + 1]]
            nj = counts[offs[j] : offs[j + 1]]
            _, ia, ib = np.intersect1d(
                ci, cj, assume_unique=True, return_indices=True
            )
            row[w] = np.minimum(ni[ia], nj[ib]).sum()
        parts.append(row)
    return np.concatenate(parts) if parts else np.zeros(0, np.int64)


def _finish_packed_rows(
    flat_sums: np.ndarray, lengths: np.ndarray, k: int, r0: int, r1: int
) -> np.ndarray:
    """Panel-local packed min-sums (rows r0..r1) -> float32 distances,
    row at a time (contract point 4: host IEEE division)."""
    S = lengths.shape[0]
    out = np.empty(flat_sums.shape[0], dtype=np.float32)
    w = 0
    for i in range(r0, r1):
        m = S - 1 - i
        denom = (np.minimum(lengths[i], lengths[i + 1 :]) - k + 1).astype(
            np.float32
        )
        out[w : w + m] = (
            np.float32(1.0)
            - flat_sums[w : w + m].astype(np.float32) / denom
        )
        w += m
    return out


def make_sparse_panel_fn(
    codes,
    cnts,
    offs,
    lengths,
    k: int,
    panel_rows: int,
    *,
    mesh=None,
    info: dict | None = None,
):
    """Packed-panel closure over per-sequence sparse tables: the sparse
    regime's twin of KmerEngine.make_dense_panel_fn (the flagship k gets
    the same streamed/resumable/mesh machinery as the dense regime).

    Routing per job (not per panel — one decision, bounded programs):
    when union_dense_plan fires, the [Sp, Dp] union-indexed matrix is
    staged on device ONCE and every panel is a [panel_rows, Dp] x
    [Sp, Dp] device min-sum (int8 thresholds / Pallas / XLA; partner-
    sharded over ``mesh`` when given — the same
    parallel/sharded_count.min_sum_panel_sharded program as the dense
    stream). Otherwise panels run the native threaded two-pointer
    (kp_min_sum_panel) on the host. Either way the closure returns
    float32 flat packed distances finished with host IEEE division.
    """
    import jax.numpy as jnp

    from dna_kmeres_parallel import native
    from dna_kmeres_parallel.ops import distance as dist_ops
    from dna_kmeres_parallel.ops import distance_pallas, runtime

    S = int(offs.shape[0] - 1)
    lengths = np.asarray(lengths, dtype=np.int64)
    plan = union_dense_plan(codes, cnts, offs, panel_rows=panel_rows)
    if plan is not None:
        mat_dev = jnp.asarray(union_matrix(codes, cnts, offs, plan))
        # Pad panel_rows extra zero rows so every panel slice has the
        # same static shape (one compiled program for the whole run).
        mat_p = jnp.pad(mat_dev, ((0, panel_rows), (0, 0)))
        impl = plan["impl"]
        if info is not None:
            info.update(
                route=f"union/{impl}",
                union_bins=plan["D"],
                cmax=plan["cmax"],
                streamed=True,
            )
        kernel = runtime.backend().kernel

        def panel_fn(r0: int, r1: int) -> np.ndarray:
            rp = r1 - r0
            panel = mat_p[r0 : r0 + panel_rows]
            if mesh is not None:
                from dna_kmeres_parallel.parallel.mesh import DATA_AXIS
                from dna_kmeres_parallel.parallel.sharded_count import (
                    min_sum_panel_sharded,
                )

                # Partner rows must divide the mesh axis: pad with
                # zero-count rows (min-sum 0 — exact; the [:, :S] slice
                # below drops them). Sp is a power of two, so this only
                # fires on non-power-of-two meshes (same discipline as
                # the dense engine's _min_sum_panel_mesh).
                n_dev = mesh.shape[DATA_AXIS]
                pad_rows = (-mat_dev.shape[0]) % n_dev
                other = (
                    jnp.pad(mat_dev, ((0, pad_rows), (0, 0)))
                    if pad_rows
                    else mat_dev
                )
                # int8-shipped matrices widen per shard for the
                # non-threshold kernels inside min_sum_panel_sharded.
                if impl == "int8":
                    sums_dev = min_sum_panel_sharded(
                        panel, other, mesh, int8_cmax=plan["cmax"]
                    )
                else:
                    sums_dev = min_sum_panel_sharded(
                        panel.astype(jnp.int32),
                        other.astype(jnp.int32),
                        mesh,
                        pallas=kernel if impl == "pallas" else None,
                    )
            elif impl == "int8":
                sums_dev = dist_ops.min_sum_matrix_int8(
                    panel, plan["cmax"], mat_dev
                )
            elif impl == "pallas":
                sums_dev = distance_pallas.min_sum_matrix_pallas(
                    panel, mat_dev, interpret=(kernel == "interpret")
                )
            else:
                sums_dev = dist_ops.min_sum_matrix(
                    panel.astype(jnp.int32),
                    counts_other=mat_dev.astype(jnp.int32),
                )
            # Slice padding off ON DEVICE before the fetch.
            sums = np.asarray(sums_dev[:rp, :S])
            d = dist_ops.finish_distances_panel(
                sums, lengths[r0:r1], lengths, k
            )
            rows = [d[i - r0, i + 1 :] for i in range(r0, r1)]
            return (
                np.concatenate(rows) if rows else np.empty(0, np.float32)
            )

        return panel_fn

    if info is not None:
        info.update(route="host/sparse", streamed=True)
    use_native = native.available()

    def panel_fn_host(r0: int, r1: int) -> np.ndarray:
        if use_native:
            sums = native.min_sum_panel_native(codes, cnts, offs, r0, r1)
        else:
            sums = min_sum_panel_python(codes, cnts, offs, r0, r1)
        return _finish_packed_rows(sums, lengths, k, r0, r1)

    return panel_fn_host


def distance_sparse_stream_to_csv(
    seqs: list[str],
    k: int,
    output_path,
    canonical: bool = False,
    *,
    panel_rows: int = 2048,
    checkpoint_path=None,
    max_panels: int | None = None,
    mesh=None,
    row_lo: int = 0,
    row_hi: int | None = None,
    info: dict | None = None,
) -> dict:
    """Streamed, resumable sparse-regime distances (r5): the k >= 12
    twin of KmerEngine.distance_stream_to_csv. The packed pair array
    never materializes — panels of rows append to the CSV through the
    shared writer (models/distance_stream.py: fsync-then-checkpoint
    durability, byte-identical resume), with the union-indexed device
    route riding the mesh when the cost gate says so. At the reference's
    design scale (54,018 seqs, /root/reference/main.cu:29) the k=21
    packed array alone is ~5.8 GB and the CSV 13 GB — this is the only
    shape that survives it. row_lo/row_hi bound the rows this writer
    owns (multi-host row sharding, parallel/multihost.py)."""
    from dna_kmeres_parallel.models import distance_stream

    codes, cnts, offs = build_pair_tables(seqs, k, canonical)
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    S = len(seqs)
    panel_fn = make_sparse_panel_fn(
        codes, cnts, offs, lengths, k, panel_rows, mesh=mesh, info=info
    )
    meta = {
        "k": k,
        "canonical": canonical,
        "n_seqs": S,
        "regime": "sparse",
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
    if info is not None:
        report["route"] = info.get("route")
    return report


def build_pair_tables(
    seqs: list[str], k: int, canonical: bool = False
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-sequence sorted-unique tables, concatenated: (codes_u64,
    counts_i64, offs_i64[S+1]) with sequence i's table at
    [offs[i], offs[i+1]). Routes like counting does: native host rolling
    counter for short sequences, the device sparse engine past
    _DEVICE_TABLE_MIN_BASES, oracle fallback without the native lib."""
    from dna_kmeres_parallel import native

    S = len(seqs)
    code_parts: list[np.ndarray] = []
    count_parts: list[np.ndarray] = []
    offs = np.zeros(S + 1, dtype=np.int64)
    use_native = native.available()
    dev_engine = None
    for i, s in enumerate(seqs):
        if len(s) >= _DEVICE_TABLE_MIN_BASES:
            if dev_engine is None:
                dev_engine = SparseKmerEngine(
                    KmerConfig(k=k, canonical=canonical)
                )
            sp = dev_engine.count_sequences([s])
            c = sp.codes
            n = sp.counts
        elif use_native:
            c, n = native.count_sparse_host_native(
                codec.encode_bases(s), k, canonical
            )
        else:
            from dna_kmeres_parallel.models.oracle import count_table_any_k

            table = count_table_any_k([s], k, canonical)
            c = np.sort(
                np.array(
                    [codec.kmer_to_code(w) for w in table], dtype=np.uint64
                )
            )
            n = np.array(
                [table[codec.code_to_kmer(int(x), k)] for x in c],
                dtype=np.int64,
            )
        code_parts.append(c)
        count_parts.append(n)
        offs[i + 1] = offs[i] + c.shape[0]
    codes = (
        np.concatenate(code_parts) if code_parts else np.zeros(0, np.uint64)
    )
    cnts = (
        np.concatenate(count_parts) if count_parts else np.zeros(0, np.int64)
    )
    return codes, cnts, offs


def finish_distances_packed(
    sums: np.ndarray, lengths: np.ndarray, k: int
) -> np.ndarray:
    """Packed pair min-sums -> float32 distances, one row at a time
    (contract point 4: host IEEE division; bounded memory at large S —
    no [S, S] materialization)."""
    S = lengths.shape[0]
    out = np.zeros(sums.shape[0], dtype=np.float32)
    w = 0
    for i in range(S - 1):
        m = S - 1 - i
        denom = (np.minimum(lengths[i], lengths[i + 1 :]) - k + 1).astype(
            np.float32
        )
        out[w : w + m] = (
            np.float32(1.0) - sums[w : w + m].astype(np.float32) / denom
        )
        w += m
    return out
