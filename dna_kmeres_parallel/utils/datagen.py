"""Synthetic FASTA generation for benchmarks and large-scale tests."""

from __future__ import annotations

import numpy as np

_ALPHABET = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_fasta(
    path: str,
    n_seqs: int,
    seq_len: int | tuple[int, int],
    seed: int = 0,
    line_width: int = 80,
    invalid_frac: float = 0.0,
) -> int:
    """Write a random FASTA file; returns total bases written.

    seq_len: fixed length or (lo, hi) uniform range.
    """
    rng = np.random.default_rng(seed)
    total = 0
    with open(path, "wb") as f:
        for i in range(n_seqs):
            if isinstance(seq_len, tuple):
                L = int(rng.integers(seq_len[0], seq_len[1] + 1))
            else:
                L = seq_len
            seq = _ALPHABET[rng.integers(0, 4, size=L)]
            if invalid_frac > 0:
                mask = rng.random(L) < invalid_frac
                seq = np.where(mask, np.uint8(ord("N")), seq)
            f.write(b">seq%d synthetic\n" % i)
            for off in range(0, L, line_width):
                f.write(seq[off : off + line_width].tobytes())
                f.write(b"\n")
            f.write(b"\n")
            total += L
    return total


def realistic_fasta(
    path: str,
    genome_len: int = 100_000,
    coverage: float = 30.0,
    read_len: int = 150,
    repeat_unit: int = 311,
    repeat_copies: int = 20,
    n_run_rate: float = 0.002,
    n_run_len: int = 12,
    lowercase_frac: float = 0.05,
    seed: int = 0,
) -> int:
    """Write a sequencing-shaped FASTA: reads sampled at `coverage`x from
    one synthetic genome. Returns total bases written.

    Every test/bench fixture before r3 was uniform-random ACGT — the one
    distribution real data never is (VERDICT r2 item 7; the reference ran
    plants.fasta / all_seqs.fasta, main.cu:47-50). This generator bakes in
    the features uniform data cannot exercise:

    - COVERAGE DUPLICATION: reads overlap ~coverage-fold, so most k-mers
      repeat (drives the device-RLE auto-selection and host-merge runs);
    - REPEATS: `repeat_copies` copies of one `repeat_unit`-base element are
      planted in the genome — shared minimizers concentrate those windows
      onto few bucket owners (the bucketed path's overflow trigger);
    - N RUNS: geometric bursts of 'N' inside reads (invalid-window
      handling beyond isolated Ns);
    - SOFT MASKING: lowercase spans (invalid per the reference contract —
      its char compares are case-sensitive, kernels.h:136-139).
    """
    rng = np.random.default_rng(seed)
    genome = _ALPHABET[rng.integers(0, 4, size=genome_len)]
    unit = _ALPHABET[rng.integers(0, 4, size=repeat_unit)]
    for _ in range(repeat_copies):
        at = int(rng.integers(0, max(genome_len - repeat_unit, 1)))
        genome[at : at + repeat_unit] = unit[: genome_len - at]
    n_reads = max(int(coverage * genome_len / read_len), 1)
    L = min(read_len, genome_len)
    total = 0
    chunk = 1 << 16  # reads generated per vectorized step (bounds memory)
    with open(path, "wb") as f:
        for r0 in range(0, n_reads, chunk):
            n = min(chunk, n_reads - r0)
            starts = rng.integers(0, max(genome_len - read_len, 1), size=n)
            reads = genome[starts[:, None] + np.arange(L)]
            # N bursts (sequencer dropouts), geometric-ish length.
            rows, cols = np.nonzero(rng.random((n, L)) < n_run_rate)
            runs = 1 + rng.geometric(1.0 / max(n_run_len, 1), size=rows.size)
            for r, c, run in zip(rows, cols, runs):
                reads[r, c : c + run] = ord("N")
            # Soft-masked (lowercase) spans: ACGT -> acgt (N -> n).
            if L > 20:
                for r in np.flatnonzero(rng.random(n) < lowercase_frac):
                    a = int(rng.integers(0, L - 10))
                    b = min(a + int(rng.integers(5, 30)), L)
                    reads[r, a:b] += 32
            lines = [
                b">read%d pos=%d\n%s\n" % (r0 + i, starts[i], reads[i].tobytes())
                for i in range(n)
            ]
            f.write(b"".join(lines))
            total += n * L
    return total
