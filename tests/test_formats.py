"""FASTQ and gzip ingest: native and Python parsers, engine integration."""

import gzip

import numpy as np
import pytest

from dna_kmeres_parallel import native
from dna_kmeres_parallel.models import oracle
from dna_kmeres_parallel.utils import codec, fasta
from dna_kmeres_parallel.utils.config import KmerConfig


def _write_fastq(path, records, qual_char="I", wrap=None):
    with open(path, "w") as f:
        for rid, seq in records:
            f.write(f"@{rid}\n")
            if wrap:
                for off in range(0, len(seq), wrap):
                    f.write(seq[off : off + wrap] + "\n")
            else:
                f.write(seq + "\n")
            f.write("+\n")
            # quality line can START with '@' or '+' — must not break parsing
            q = "@" + qual_char * (len(seq) - 1) if len(seq) > 1 else qual_char
            if wrap:
                for off in range(0, len(q), wrap):
                    f.write(q[off : off + wrap] + "\n")
            else:
                f.write(q + "\n")


@pytest.fixture
def seqs(make_dna):
    return [(f"r{i}", make_dna(130 + 37 * i, invalid_frac=0.02)) for i in range(5)]


def test_parse_fastq_python(tmp_path, seqs):
    path = tmp_path / "t.fastq"
    _write_fastq(path, seqs)
    recs = fasta.parse_fasta(str(path))  # auto-dispatch on '@'
    assert [r.seq for r in recs] == [s for _, s in seqs]
    assert [r.id for r in recs] == [f"@{i}" for i, _ in seqs]


def test_parse_fastq_multiline(tmp_path, seqs):
    path = tmp_path / "m.fastq"
    _write_fastq(path, seqs, wrap=23)
    recs = fasta.parse_fasta(str(path))
    assert [r.seq for r in recs] == [s for _, s in seqs]


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_parse_fastq_native_matches_python(tmp_path, seqs):
    path = tmp_path / "n.fastq"
    _write_fastq(path, seqs, wrap=31)
    parsed = native.parse_fasta_native(str(path))
    assert parsed.n_seqs == len(seqs)
    for j, (_, s) in enumerate(seqs):
        assert np.array_equal(parsed.sequence_codes(j), codec.encode_bases(s))


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_parse_fasta_gzip_native_and_python(tmp_path, seqs):
    plain = tmp_path / "p.fasta"
    fasta.write_fasta(plain, [(f">{i}", s) for i, s in seqs])
    gz = tmp_path / "p.fasta.gz"
    with open(plain, "rb") as fi, gzip.open(gz, "wb") as fo:
        fo.write(fi.read())
    a = native.parse_fasta_native(str(plain))
    b = native.parse_fasta_native(str(gz))
    assert a.n_seqs == b.n_seqs
    assert np.array_equal(a.stream, b.stream)
    recs = fasta.parse_fasta(str(gz))
    assert [r.seq for r in recs] == [s for _, s in seqs]


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_gzip_byte_range_rejected(tmp_path, seqs):
    gz = tmp_path / "r.fasta.gz"
    with gzip.open(gz, "wt") as f:
        f.write(">a\nACGT\n")
    with pytest.raises(IOError):
        native.parse_fasta_native(str(gz), byte_range=(0, 10))


def test_engine_counts_fastq_and_gz(tmp_path, seqs, make_dna):
    # End to end: count a FASTQ and a gzipped FASTA through the engine.
    from dna_kmeres_parallel.models.engine import KmerEngine

    fq = tmp_path / "e.fastq"
    _write_fastq(fq, seqs)
    want = sum(
        (oracle.count_vector(s, 5) for _, s in seqs),
        np.zeros(4**5, np.int64),
    )
    r = KmerEngine(KmerConfig(k=5)).count_file(str(fq))
    assert np.array_equal(r.hist, want)

    gz = tmp_path / "e.fasta.gz"
    with gzip.open(gz, "wt") as f:
        for i, s in seqs:
            f.write(f">{i}\n{s}\n")
    r2 = KmerEngine(KmerConfig(k=5)).count_file(str(gz))
    assert np.array_equal(r2.hist, want)


def test_fastq_zero_length_read(tmp_path):
    # Adapter-trimmed FASTQ: an empty read must not swallow the next record
    # (regression: the '@' of the following header was consumed as quality).
    content = "@r1\nACGTACGT\n+\nIIIIIIII\n@empty\n+\n@r2\nGGGGCCCC\n+\nIIIIIIII\n"
    path = tmp_path / "z.fastq"
    path.write_text(content)
    recs = fasta.parse_fasta(str(path))
    assert [r.id for r in recs] == ["@r1", "@empty", "@r2"]
    assert [r.seq for r in recs] == ["ACGTACGT", "", "GGGGCCCC"]
    if native.available():
        parsed = native.parse_fasta_native(str(path))
        assert parsed.n_seqs == 3
        assert np.array_equal(
            parsed.sequence_codes(2), codec.encode_bases("GGGGCCCC")
        )


def test_fastq_truncated_quality_eof(tmp_path):
    # EOF inside the quality line: the trailing record's bases still count.
    path = tmp_path / "t.fastq"
    path.write_text("@r1\nACGTACGT\n+\nIII")
    recs = fasta.parse_fasta(str(path))
    assert [r.seq for r in recs] == ["ACGTACGT"]


def test_fastq_stream_source():
    import io as io_mod

    recs = fasta.parse_fasta(
        io_mod.StringIO("@a\nACGT\n+\nIIII\n@b\nTTTT\n+\nIIII\n")
    )
    assert [r.seq for r in recs] == ["ACGT", "TTTT"]
