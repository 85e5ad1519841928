"""FASTA/FASTQ reading (plain or gzip), matching kseq semantics.

kseq (reference src/lib/utils.h kseq) splits the header at the first
whitespace: `name` is the first token, `comment` the rest. Sequence lines are
concatenated verbatim (case preserved).
"""
from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
from typing import Iterator


@dataclass
class Record:
    name: str
    comment: str
    seq: str
    qual: str | None = None


def _open(path: str):
    f = open(path, "rb")
    if f.peek(2)[:2] == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=f))
    return f


def read_fastx(path: str) -> Iterator[Record]:
    """Iterate records of a FASTA or FASTQ file (auto-detected, gz ok)."""
    with _open(path) as f:
        first = f.peek(1)[:1]
        if first == b">":
            yield from _read_fasta(f)
        elif first == b"@":
            yield from _read_fastq(f)
        elif first == b"":
            return
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ")


def _split_header(line: bytes) -> tuple[str, str]:
    h = line[1:].rstrip(b"\r\n")
    parts = h.split(None, 1)
    name = parts[0].decode() if parts else ""
    comment = parts[1].decode() if len(parts) > 1 else ""
    return name, comment


def _read_fasta(f) -> Iterator[Record]:
    name = comment = None
    seq: list[bytes] = []
    for line in f:
        if line.startswith(b">"):
            if name is not None:
                yield Record(name, comment, b"".join(seq).decode())
            name, comment = _split_header(line)
            seq = []
        else:
            seq.append(line.strip())
    if name is not None:
        yield Record(name, comment, b"".join(seq).decode())


def read_fastx_fast(path: str) -> Iterator[Record]:
    """read_fastx via the native batch reader (csrc/fastx.c) when a C
    compiler is available; identical Record stream otherwise."""
    from . import native

    if not native.available():
        yield from read_fastx(path)
        return
    rdr = native.NativeFastxReader(path)
    try:
        for raw_names, seq_bytes, qual_bytes, lens, hasq in rdr:
            off = 0
            for i, raw in enumerate(raw_names):
                ln = int(lens[i])
                parts = raw.split(None, 1)
                name = parts[0].decode() if parts else ""
                comment = parts[1].decode() if len(parts) > 1 else ""
                seq = seq_bytes[off : off + ln].decode()
                qual = (qual_bytes[off : off + ln].decode() if hasq[i]
                        else None)
                off += ln
                yield Record(name, comment, seq, qual)
    finally:
        rdr.close()


def _read_fastq(f) -> Iterator[Record]:
    while True:
        h = f.readline()
        if not h:
            return
        if h.strip() == b"":
            continue
        name, comment = _split_header(h)
        seq = f.readline().strip().decode()
        f.readline()  # '+'
        qual = f.readline().strip().decode()
        yield Record(name, comment, seq, qual)
