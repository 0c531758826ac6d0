"""FASTA/FASTQ reading and writing (L1 host IO).

Covers the reference reader's behaviour (`common/fasta.c`): gzip-transparent
input, fasta/fastq autodetection from the first record character, multi-line
sequences, colour-space reads carrying an initial letter base, and optional
per-read quality strings.  The streaming interface yields `ReadRecord`s; the
genome loader returns whole contigs.

The reference reads through a hand-rolled 8MB gzip buffer (fasta.c:60-120);
here Python's buffered gzip/file objects fill that role — the hot path for
mapping is device compute, and a C++ reader can slot in behind the same
generator interface later.
"""

from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass

import numpy as np

from shrimp_tpu_torch import dna


@dataclass
class ReadRecord:
    """One sequencing read as parsed from FASTA/FASTQ."""

    name: str
    seq: str                  # raw sequence text (CS reads include initial base)
    qual: str | None = None   # raw quality string, if FASTQ

    def is_colour_space(self) -> bool:
        """CS reads start with a letter base followed by digits."""
        return (len(self.seq) >= 2 and self.seq[0].upper() in "ACGT"
                and all(c in "0123.Nn4" for c in self.seq[1:]))


@dataclass
class Contig:
    name: str
    codes: np.ndarray         # int8 base codes
    is_rna: bool = False


def _open_maybe_gz(path: str) -> io.TextIOBase:
    if path == "-":
        import sys
        return sys.stdin
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(
            io.BufferedReader(gzip.open(path, "rb"), buffer_size=1 << 22))
    return open(path, "rt", buffering=1 << 22)


def detect_fastq(path: str) -> bool:
    """Autodetect fastq vs fasta from the first non-blank character
    (gmapper autodetects unless --no-autodetect-input)."""
    fh = _open_maybe_gz(path)
    try:
        for line in fh:
            s = line.strip()
            if s:
                return s[0] == "@"
        return False
    finally:
        if fh is not io.TextIOBase:
            fh.close()


NATIVE_CHUNK = 64 << 20        # bytes of file indexed per native call


def _iter_reads_native(path: str, fastq: bool):
    """Bulk record indexing through the native C scanner; returns None when
    the library is unavailable or the file shape needs the general parser.

    The file is scanned in fixed-size chunks (the reference streams through
    an 8MB buffer, common/fasta.c:60-120): each chunk is indexed by the C
    scanner, the possibly-truncated final record is dropped, and the next
    chunk resumes at that record's header — so peak host memory stays
    O(chunk), not O(file)."""
    import ctypes

    from shrimp_tpu_torch import native

    lib = native.load()
    if lib is None:
        return None
    size = os.path.getsize(path)
    if size == 0:
        return iter(())

    def index_chunk(data: bytes):
        """Index one in-memory chunk; (spans, got) or None for fallback."""
        width = 6 if fastq else 4
        # min record: '@x\ns\n+\nq\n' = 8 bytes fastq / '>x\ns\n' fasta
        cap = len(data) // (8 if fastq else 4) + 4
        spans = np.empty((cap, width), np.int64)
        ptr = spans.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))
        if fastq:
            got = lib.fastx_index_fastq(data, len(data), ptr, cap)
        else:
            got = lib.fastx_index_fasta(data, len(data), ptr, cap)
        if got < 0:
            return None
        return spans, int(got)

    def emit(data: bytes, spans: np.ndarray, n: int):
        for i in range(n):
            row = spans[i]
            name = data[row[0]:row[1]].decode("ascii")
            if fastq:
                yield ReadRecord(name=name,
                                 seq=data[row[2]:row[3]].decode("ascii"),
                                 qual=data[row[4]:row[5]].decode("ascii"))
            else:
                seq = data[row[2]:row[3]].decode("ascii")
                yield ReadRecord(
                    name=name,
                    seq=seq.replace("\n", "").replace("\r", ""))

    def gen():
        pos = 0
        chunk = NATIVE_CHUNK
        with open(path, "rb") as fh:
            while pos < size:
                fh.seek(pos)
                data = fh.read(min(chunk, size - pos))
                res = index_chunk(data)
                if res is None:
                    # malformed/multi-line shapes: re-parse the tail with
                    # the general reader (keeps earlier chunks' output)
                    yield from _iter_reads_python_from(path, pos, fastq)
                    return
                spans, got = res
                at_eof = pos + len(data) >= size
                if not at_eof and got > 0:
                    # drop the final record (may be truncated) and resume
                    # at its header marker
                    got -= 1
                    if got == 0:
                        chunk *= 2      # one record larger than the chunk
                        continue
                    resume = int(spans[got][0]) - 1
                else:
                    resume = len(data)
                yield from emit(data, spans, got)
                if at_eof:
                    return
                pos += resume

    return gen()


def _iter_reads_python_from(path: str, offset: int, fastq: bool):
    """General Python parser starting at a byte offset (native fallback)."""
    with open(path, "rb") as raw:
        raw.seek(offset)
        fh = io.TextIOWrapper(io.BufferedReader(raw, buffer_size=1 << 22))
        yield from _parse_stream(fh, fastq)


def iter_reads(path: str, fastq: bool | None = None):
    """Yield ReadRecord from a FASTA or FASTQ file (gzip ok).

    Plain (non-gzip) files go through the native C record indexer when
    available (shrimp_tpu_torch/native); gzip and odd shapes use the general
    Python parser."""
    if fastq is None:
        fastq = detect_fastq(path)
    if path != "-":
        try:
            with open(path, "rb") as probe:
                is_gz = probe.read(2) == b"\x1f\x8b"
        except OSError:
            is_gz = True
        if not is_gz:
            it = _iter_reads_native(path, fastq)
            if it is not None:
                yield from it
                return
    fh = _open_maybe_gz(path)
    try:
        yield from _parse_stream(fh, fastq)
    finally:
        fh.close()


def _parse_stream(fh, fastq: bool):
    """The general FASTA/FASTQ parser over an open text stream."""
    if fastq:
        while True:
            header = fh.readline()
            if not header:
                return
            header = header.strip()
            if not header:
                continue
            if not header.startswith("@"):
                raise ValueError(f"malformed FASTQ header: {header!r}")
            name = header[1:].split()[0] if len(header) > 1 else ""
            seq_parts: list[str] = []
            line = fh.readline()
            while line and not line.startswith("+"):
                seq_parts.append(line.strip())
                line = fh.readline()
            seq = "".join(seq_parts)
            # colour-space reads carry no qv for the initial letter base,
            # so their quality string is one shorter (fasta.c qual_vector
            # offset handling)
            expected = len(seq)
            if (len(seq) >= 2 and seq[0].upper() in "ACGT"
                    and all(c in "0123.Nn4" for c in seq[1:])):
                expected -= 1
            qual_parts: list[str] = []
            qlen = 0
            while qlen < expected:
                line = fh.readline()
                if not line:
                    break
                part = line.rstrip("\n")
                qual_parts.append(part)
                qlen += len(part)
            yield ReadRecord(name=name, seq=seq, qual="".join(qual_parts))
    else:
        name = None
        seq_parts = []
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield ReadRecord(name=name, seq="".join(seq_parts))
                name = line[1:].split()[0] if len(line) > 1 else ""
                seq_parts = []
            else:
                seq_parts.append(line)
        if name is not None:
            yield ReadRecord(name=name, seq="".join(seq_parts))


def iter_contigs(path: str):
    """Yield genome contigs as Contig(name, int8 codes)."""
    for rec in iter_reads(path, fastq=False):
        yield Contig(name=rec.name, codes=dna.encode(rec.seq))


def read_batches(path: str, batch_size: int, fastq: bool | None = None):
    """Yield lists of up to batch_size ReadRecords — the chunked intake that
    replaces the reference's per-thread read checkout (gmapper.c:343-400)."""
    batch: list[ReadRecord] = []
    for rec in iter_reads(path, fastq=fastq):
        batch.append(rec)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch:
        yield batch


def write_fasta(path_or_fh, records, width: int = 80) -> None:
    own = isinstance(path_or_fh, (str, os.PathLike))
    fh = open(path_or_fh, "wt") if own else path_or_fh
    try:
        for rec in records:
            fh.write(f">{rec.name}\n")
            for i in range(0, len(rec.seq), width):
                fh.write(rec.seq[i:i + width] + "\n")
    finally:
        if own:
            fh.close()


def write_fastq(path_or_fh, records) -> None:
    own = isinstance(path_or_fh, (str, os.PathLike))
    fh = open(path_or_fh, "wt") if own else path_or_fh
    try:
        for rec in records:
            fh.write(f"@{rec.name}\n{rec.seq}\n+\n{rec.qual or ''}\n")
    finally:
        if own:
            fh.close()
