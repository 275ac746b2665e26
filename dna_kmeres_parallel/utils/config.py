"""Runtime configuration.

The reference's entire "config system" is compile-time #defines and hard-coded
absolute paths (SURVEY.md §2.3: K, MAX_SEQS, grid sizes, CSV paths —
/root/reference/main.cu:19-50, kernels.h:11-19). Here everything is a runtime
dataclass; ``k`` is a runtime parameter up to the sharded-histogram limit.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class KmerConfig:
    """Configuration for counting / distance runs.

    Attributes:
      k: k-mer length. Dense histograms are used while 4^k fits the
         ``dense_bins_limit``; beyond that the sparse (sorted) engine engages.
      canonical: fold reverse complements (min(code, rc(code))) — a mandated
         new capability; the reference has none (SURVEY.md §2.4.6).
      max_seqs: optional ingest cap (reference MAX_SEQS=100, main.cu:30).
      batch_bases: number of bases per device batch in the streaming
         counter (default 16M: smaller batches underutilize the device and
         pay per-dispatch latency; inputs smaller than one batch use
         power-of-two shape buckets so tiny files never pad to 16M).
      seq_tile: sequences per tile in the distance engine (rounded to 8).
      dense_bins_limit: largest dense histogram kept per chip (default 4^12).
      count_dtype: dtype of count accumulators (int32 like the reference's
         ``int`` counters; SURVEY.md kernels.h:13).
      mesh_shape: (data,) or (hosts, chips) device mesh for sharded counting.
      use_pallas: run the (min,+) distance kernel (ops/distance_pallas)
        where the backend compiles it (else XLA's plain (min,+)).
      parser_variant: "modern" | "blank_line" | "no_blank_line" (see fasta.py).
      pack_input: ship device batches 2-bit packed (4 bases/byte + validity
         bitmask, the format the reference sketched at utils.h:65-92 but
         never built) — 4x less host->device transfer; the unpack fuses
         into the device program.
      sort_row_len: sparse path (k >= 13): sort the window stream as
         independent rows of this length instead of one flat array; the
         host compactor multiway-merges the rows in its single pass.
         0 = flat full-array sort. Only applies when the device sorts at
         all (see device_sort).
      device_sort: sparse path (k >= 13): whether the device sorts the
         window words at all. None (default) = auto: skip the device sort
         when the native MSD+LSD radix compactor is available (it builds
         the table from UNSORTED words in a constant number of passes, so
         sorted input buys it nothing and the device runs the encode
         alone); sort on device
         when only the NumPy fallback compactor exists. True/False force.
      compact: sparse path: where each batch's table is built.
         'device' ships encoded window words D2H (6-8 B/window) into the
         host radix compactor — right when D2H is fast next to the host's
         encode (the host is spared the encode and feeds the radix
         directly). 'host' never touches the device: each batch is counted
         from the HOST-resident stream by the fused native engine
         (count_sparse_host_native) — ZERO bytes D2H/H2D; it wins when the
         host re-derives a window's words faster than D2H ships them.
         'auto' (default) RACES the two on the first batches of a
         multi-batch stream and finishes with the winner (self-calibrating:
         no transfer or CPU model needed; single-device streams only —
         mesh runs exist to use every device and stay on device); when the
         device arm wins (k >= 13, native present) it additionally probes
         the super-k-mer D2H format as a device SUB-ROUTE and keeps
         whichever the measured rates favor. 'device-rle' is the
         HIGH-DUPLICATION mode: the device sorts and RLE-collapses runs,
         shipping only DISTINCT (code, count) pairs — D2H and host work
         scale with distinct codes (~10/dup B per window; sequencing
         reads carry 30-50x coverage) and the host merges already-sorted
         tables with no radix pass. Explicit opt-in: at dup ~1 the
         device sort costs more than it saves. 'device-super' ships
         SUPER-K-MER records (each minimizer run's 2k-m bases packed
         2-bit + a run length) instead of word planes — ~1.5-2 B/window
         of D2H instead of 6-8 (k=21/m=7: 3x), with the host expanding
         records and re-counting via the fused native engine: the
         D2H-bound mode when the host must NOT count the resident
         stream itself (e.g. it feeds several devices).
    """

    k: int = 3
    canonical: bool = False
    max_seqs: int | None = None
    batch_bases: int = 1 << 24
    seq_tile: int = 256
    dense_bins_limit: int = 1 << 24
    count_dtype: str = "int32"
    mesh_shape: tuple[int, ...] = ()
    use_pallas: bool = True
    parser_variant: str = "modern"
    pack_input: bool = True
    sort_row_len: int = 2048
    device_sort: bool | None = None
    compact: str = "auto"

    def __post_init__(self):
        if not (1 <= self.k <= 31):
            # 31 is the hard framework limit: 2k bits must fit the 62-bit
            # code budget (split u32 words; host codecs use int64).
            raise ValueError(f"k must be in [1, 31], got {self.k}")
        if self.parser_variant not in ("modern", "blank_line", "no_blank_line"):
            raise ValueError(f"bad parser_variant {self.parser_variant!r}")
        if self.compact == "device-super" and self.k < 9:
            # compact modes are consumed by the streamed SPARSE path,
            # which serves k >= 9 (k <= 8 counts dense and would
            # silently ignore the setting); the record format's own
            # bound (minimizer m=7 < k) is implied by k >= 9.
            raise ValueError(
                f"compact='device-super' serves the sparse stream "
                f"(k >= 9), got k={self.k}"
            )
        if self.compact not in (
            "auto", "device", "host", "device-rle", "device-super"
        ):
            raise ValueError(f"bad compact {self.compact!r}")

    @property
    def bins(self) -> int:
        return 1 << (2 * self.k)

    @property
    def dense(self) -> bool:
        """Whether the dense per-chip histogram representation applies."""
        return self.bins <= self.dense_bins_limit

    def replace(self, **kw) -> "KmerConfig":
        return dataclasses.replace(self, **kw)
