"""FASTA parser tests: record splitting, reference-variant emulation, streaming."""

import io

import pytest

from dna_kmeres_parallel.utils import fasta

BLANK_SEP = b"""\
>seq1 first
ACGTACGT
ACGT

>seq2 second
TTTT
GGGG

>seq3
A

"""

NO_BLANK = b"""\
>seq1 first
ACGTACGT
ACGT
>seq2 second
TTTT
GGGG
>seq3
A
"""


def test_parse_modern_blank_separated():
    recs = fasta.parse_fasta(BLANK_SEP)
    assert [(r.id, r.seq) for r in recs] == [
        (">seq1 first", "ACGTACGTACGT"),
        (">seq2 second", "TTTTGGGG"),
        (">seq3", "A"),
    ]


def test_parse_modern_no_blank():
    recs = fasta.parse_fasta(NO_BLANK)
    assert [(r.id, r.seq) for r in recs] == [
        (">seq1 first", "ACGTACGTACGT"),
        (">seq2 second", "TTTTGGGG"),
        (">seq3", "A"),
    ]


def test_parse_crlf_and_max_seqs():
    data = BLANK_SEP.replace(b"\n", b"\r\n")
    recs = fasta.parse_fasta(data)
    assert len(recs) == 3 and recs[0].seq == "ACGTACGTACGT"
    assert len(fasta.parse_fasta(BLANK_SEP, max_seqs=2)) == 2


def test_reference_blank_line_variant():
    # importSeqs semantics (main.cu:474-545) on well-formed blank-separated
    # input == modern parser.
    recs = fasta.parse_fasta_reference(BLANK_SEP, variant="blank_line")
    assert [(r.id, r.seq) for r in recs] == [
        (">seq1 first", "ACGTACGTACGT"),
        (">seq2 second", "TTTTGGGG"),
        (">seq3", "A"),
    ]


def test_reference_blank_line_swallows_headers():
    # Faithful quirk: without blank separators, importSeqs appends the next
    # '>' header into the sequence body (why importSeqsNoNL exists).
    recs = fasta.parse_fasta_reference(NO_BLANK, variant="blank_line")
    assert len(recs) == 1
    assert ">seq2 second" in recs[0].seq


def test_reference_no_blank_line_variant():
    # importSeqsNoNL (main.cu:401-473): records split at the next header.
    recs = fasta.parse_fasta_reference(NO_BLANK, variant="no_blank_line")
    assert [(r.id, r.seq) for r in recs] == [
        (">seq1 first", "ACGTACGTACGT"),
        (">seq2 second", "TTTTGGGG"),
        (">seq3", "A"),
    ]


def test_reference_max_seqs_cap():
    # MAX_SEQS ingest cap (main.cu:30,514): default 100, here 2.
    recs = fasta.parse_fasta_reference(BLANK_SEP, variant="blank_line", max_seqs=2)
    assert len(recs) == 2


def test_streaming_matches_batch(tmp_path, make_dna):
    records = [(f">r{i}", make_dna(50 + i * 13)) for i in range(20)]
    path = tmp_path / "t.fasta"
    fasta.write_fasta(path, records, width=17)
    batch = fasta.parse_fasta(str(path))
    # Tiny chunk size forces many partial-line boundaries.
    streamed = list(fasta.iter_fasta_records(str(path), chunk_bytes=7))
    assert [(r.id, r.seq) for r in streamed] == [(r.id, r.seq) for r in batch]
    assert [(r.id, r.seq) for r in batch] == records


def test_streaming_no_trailing_newline():
    data = b">a\nACGT\nGG\n>b\nTTT"
    recs = list(fasta.iter_fasta_records(data, chunk_bytes=4))
    assert [(r.id, r.seq) for r in recs] == [(">a", "ACGTGG"), (">b", "TTT")]


def test_empty_and_header_only():
    assert fasta.parse_fasta(b"") == []
    recs = fasta.parse_fasta(b">only header\n")
    assert [(r.id, r.seq) for r in recs] == [(">only header", "")]


def test_iter_fasta_records_gzip(tmp_path, make_dna):
    """iter_fasta_records must sniff gzip like parse_fasta (review
    regression: a raw-binary read of .gz yielded zero records)."""
    import gzip

    seqs = [make_dna(80) for _ in range(3)]
    raw = "".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)).encode()
    path = tmp_path / "in.fa.gz"
    path.write_bytes(gzip.compress(raw))
    got = list(fasta.iter_fasta_records(str(path)))
    assert [r.seq for r in got] == seqs
