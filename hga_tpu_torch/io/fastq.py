"""L0 — streaming FASTQ/FASTA reader (multi-file, category-tagged).

Capability parity with the reference's C++ `SequenceRecordIterator`-like
multi-file reader (SURVEY.md C1): parses FASTQ and FASTA (gzip included),
tags each read with the index of its source file (category: by convention
0 = short/Illumina files, 1 = long/nanopore files), and yields records in a
streaming fashion so arbitrarily large files never need to fit in memory as
python strings.

A copy of ``hga_tpu.io.fastq``.  It defines the semantics that the native
C++ packer (io/native.py) reproduces bit for bit; models/pipeline.load_reads
takes the native route when the pads are known up front.

Quality-score policy: FASTQ quality strings are parsed (SeqRecord.quality)
and by DEFAULT not propagated into PackedReads — consensus voting and
trimming are quality-blind.  The pileup majority vote over ~20-30x depth
makes per-base weighting a second-order effect, and dropping the quality
plane halves L0 host memory and host->device traffic.  Opt in with
`load_reads(..., keep_quality=True)` (models/pipeline.py): the plane
rides PackedReads.qual (uint8 phred) and consensus votes weigh each base's
phred tier (cfg.use_quality, models/correction.py; SURVEY.md L0 per-read
quality metadata).
"""

from __future__ import annotations

import gzip
import io
from typing import Iterable, Iterator, List, NamedTuple, Optional, Sequence, Tuple


class SeqRecord(NamedTuple):
    name: str
    seq: str
    quality: Optional[str]  # None for FASTA
    category: int           # source-file category tag


def _open(path: str):
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "r")


def _sniff_format(first_char: str) -> str:
    if first_char == ">":
        return "fasta"
    if first_char == "@":
        return "fastq"
    raise ValueError(f"unrecognised sequence file (starts with {first_char!r})")


def iter_records(path: str, category: int = 0) -> Iterator[SeqRecord]:
    """Stream records from one FASTQ/FASTA(.gz) file."""
    with _open(path) as fh:
        first = fh.read(1)
        if not first:
            return
        fmt = _sniff_format(first)
        if fmt == "fasta":
            name = fh.readline().strip()
            chunks: List[str] = []
            for line in fh:
                line = line.rstrip("\n")
                if line.startswith(">"):
                    yield SeqRecord(name.split()[0] if name else "", "".join(chunks), None, category)
                    name = line[1:].strip()
                    chunks = []
                else:
                    chunks.append(line)
            yield SeqRecord(name.split()[0] if name else "", "".join(chunks), None, category)
        else:
            # FASTQ: strictly 4 lines per record (multi-line FASTQ is not in
            # modern use; the reference reader assumes 4-line records too).
            name = fh.readline().strip()  # rest of the @ line
            while True:
                seq = fh.readline().strip()
                _plus = fh.readline()
                qual = fh.readline().strip()
                if not _plus:
                    break
                yield SeqRecord(name.split()[0] if name else "", seq, qual, category)
                header = fh.readline()
                if not header:
                    break
                name = header[1:].strip()


def read_sequence_files(
    paths: Sequence[str],
    categories: Optional[Sequence[int]] = None,
) -> Iterator[SeqRecord]:
    """Stream all records from multiple files with per-file category tags.

    If `categories` is None, the category defaults to the file's position in
    `paths` clamped to {0,1} — matching the reference's convention of short
    reads first, long reads second.
    """
    for fi, path in enumerate(paths):
        cat = categories[fi] if categories is not None else min(fi, 1)
        yield from iter_records(path, category=cat)


def write_fasta(path: str, records: Iterable[Tuple[str, str]], width: int = 80) -> None:
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i : i + width] + "\n")


def write_fastq(path: str, records: Iterable[Tuple[str, str, str]]) -> None:
    with open(path, "w") as fh:
        for name, seq, qual in records:
            fh.write(f"@{name}\n{seq}\n+\n{qual}\n")
