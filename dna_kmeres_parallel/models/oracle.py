"""The NumPy golden engine — exact reference semantics, the correctness oracle.

Reproduces, in plain NumPy, the numerical contract of the reference's CPU
engine (the reference's own golden path: ``sequentialKmerCount2`` at
/root/reference/main.cu:587-621 with ``permutationsCountAll`` at
main.cu:636-646), as documented in SURVEY.md §2.4:

1. k-mer index space: lexicographic A=0,C=1,G=2,T=3 (big-endian rolling code;
   see utils/codec.py for the note on the reference's internal little-endian
   layout, which is distance-invariant).
2. A sequence of length L yields exactly L-k+1 windows.
3. Windows containing any character outside {A,C,G,T} are excluded from
   counts and distances (reference: CPU bucket-0 sink main.cu:643-644 skipped
   by the 1-based pair loop main.cu:610; GPU simply never matches,
   kernels.h:136-139).
4. Distance: D(i,j) = 1 - sum_p min(cnt_i[p], cnt_j[p]) / (min(L_i,L_j)-k+1),
   computed in float32 (main.cu:614: ``1 - (float) sum / (minLength - k + 1)``).
5. Result layout: packed strict upper triangle, row-major
   (utils/triangular.py).

Every accelerated path in this framework is tested for exact equality against
this module.
"""

from __future__ import annotations

import numpy as np

from dna_kmeres_parallel.utils import codec
from dna_kmeres_parallel.utils.triangular import packed_index, packed_size


def count_vector(seq: str | np.ndarray, k: int, canonical: bool = False) -> np.ndarray:
    """Exact dense count vector [4^k] (int64) for one sequence.

    Bucket ``c`` counts windows whose canonical big-endian code is ``c``.
    Invalid-character windows are excluded entirely (contract point 3).
    With ``canonical=True``, reverse complements are folded:
    bucket = min(code, revcomp(code)) — a new capability, not in the reference.
    """
    bases = codec.encode_bases(seq) if isinstance(seq, str) else np.asarray(seq)
    codes, valid = codec.kmer_codes(bases, k)
    if canonical:
        codes = codec.canonical_code(codes, k)
    hist = np.zeros(codec.num_bins(k), dtype=np.int64)
    np.add.at(hist, codes[valid], 1)
    return hist


def counts_matrix(seqs: list[str], k: int, canonical: bool = False) -> np.ndarray:
    """[n_seqs, 4^k] int64 count matrix."""
    return np.stack([count_vector(s, k, canonical) for s in seqs], axis=0)


def count_table(seqs: list[str], k: int, canonical: bool = False) -> dict[str, int]:
    """Aggregate counts over all sequences, keyed by k-mer string.

    This is the order-free representation used for cross-engine parity checks
    (robust to any internal bucket-layout choice, including the reference's
    little-endian one)."""
    total = np.zeros(codec.num_bins(k), dtype=np.int64)
    for s in seqs:
        total += count_vector(s, k, canonical)
    return {
        codec.code_to_kmer(c, k): int(total[c]) for c in np.nonzero(total)[0]
    }


def count_table_any_k(
    seqs: list[str], k: int, canonical: bool = False
) -> dict[str, int]:
    """Naive dict-based aggregate counter valid for ANY k (including k > 15
    where dense vectors are impossible) — the oracle for the sparse engine."""
    table: dict[str, int] = {}
    for s in seqs:
        for i in range(len(s) - k + 1):
            w = s[i : i + k]
            if any(ch not in "ACGT" for ch in w):
                continue
            if canonical:
                w = min(w, codec.revcomp_str(w))
            table[w] = table.get(w, 0) + 1
    return table


def distance_pair(cnt_i, cnt_j, len_i: int, len_j: int, k: int) -> np.float32:
    """Reference distance formula in float32 (contract point 4)."""
    s = np.int64(np.minimum(cnt_i, cnt_j).sum())
    denom = min(len_i, len_j) - k + 1
    return np.float32(1.0) - np.float32(s) / np.float32(denom)


def distance_matrix_packed(
    seqs: list[str], k: int, canonical: bool = False
) -> np.ndarray:
    """Packed strict-upper-triangle float32 distance vector (contract 4+5)."""
    n = len(seqs)
    counts = counts_matrix(seqs, k, canonical)
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    out = np.zeros(packed_size(n), dtype=np.float32)
    for i in range(n - 1):
        # Vectorized over j for speed; float32 math matches the scalar formula.
        js = np.arange(i + 1, n)
        sums = np.minimum(counts[i][None, :], counts[js]).sum(axis=1)
        denoms = (np.minimum(lengths[i], lengths[js]) - k + 1).astype(np.float32)
        d = np.float32(1.0) - sums.astype(np.float32) / denoms
        out[packed_index(i, js, n)] = d
    return out


def naive_count_vector(seq: str, k: int) -> np.ndarray:
    """Independent O(L*k) dict-based counter used to cross-check count_vector
    (two different implementations of the same contract)."""
    hist = np.zeros(codec.num_bins(k), dtype=np.int64)
    for i in range(len(seq) - k + 1):
        window = seq[i : i + k]
        if any(ch not in "ACGT" for ch in window):
            continue
        hist[codec.kmer_to_code(window)] += 1
    return hist


def distance_matrix_packed_sparse(
    seqs: list[str], k: int, canonical: bool = False
) -> np.ndarray:
    """Packed float32 distance vector for ANY k via per-sequence dict
    tables (the oracle twin of sparse_engine.distance_sparse_packed —
    k > 15 where the dense counts matrix of distance_matrix_packed is
    impossible). Same float32 finish as contract point 4."""
    return distance_rows_packed(seqs, k, max(len(seqs) - 1, 0), canonical)


def distance_rows_packed(
    seqs: list[str], k: int, n_rows: int, canonical: bool = False
) -> np.ndarray:
    """The first ``n_rows`` rows of the packed distance vector (row i: the
    pairs (i, i+1..n-1)), via per-sequence dict tables — a row panel of
    the oracle for matrices too large to check whole."""
    n = len(seqs)
    tables = [count_table_any_k([s], k, canonical) for s in seqs]
    lengths = [len(s) for s in seqs]
    n_rows = min(n_rows, max(n - 1, 0))
    out = np.zeros(sum(n - 1 - i for i in range(n_rows)), dtype=np.float32)
    w = 0
    for i in range(n_rows):
        ti = tables[i]
        for j in range(i + 1, n):
            tj = tables[j]
            small, big = (ti, tj) if len(ti) <= len(tj) else (tj, ti)
            s = sum(min(c, big.get(km, 0)) for km, c in small.items())
            denom = min(lengths[i], lengths[j]) - k + 1
            out[w] = np.float32(1.0) - np.float32(s) / np.float32(denom)
            w += 1
    return out
