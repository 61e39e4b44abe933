"""Sequence banks: FASTA / FASTQ, plain or gzip, comma lists, file-of-files.

Replicates GATB's Bank facilities as used by the reference
(Bank::open at src/Finder.cpp:306, BankFasta at src/Filler.cpp:285-292;
input conventions documented in reference README.md:167).

Sequence records expose the accessors the reference relies on:
``comment`` (full header), ``comment_short`` (first whitespace token,
cf. getCommentShort), ``seq`` and ``index``.
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass
from typing import Iterator


@dataclass
class Sequence:
    index: int
    comment: str  # full header line without '>'/'@'
    seq: str

    @property
    def comment_short(self) -> str:
        return self.comment.split()[0] if self.comment else ""


def _open_text(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def _expand_uri(uri: str) -> list[str]:
    """Expand a bank URI: comma-separated entries; an entry whose content does
    not start with '>'/'@' is treated as a file of file names."""
    files: list[str] = []
    for part in uri.split(","):
        part = part.strip()
        if not part:
            continue
        with _open_text(part) as f:
            head = f.read(1)
        if head in (">", "@"):
            files.append(part)
        else:
            base = os.path.dirname(part)
            with _open_text(part) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        p = line if os.path.isabs(line) else os.path.join(base, line)
                        files.append(p)
    return files


class Bank:
    """A (possibly composite) sequence bank."""

    def __init__(self, uri: str):
        self.uri = uri
        self.files = _expand_uri(uri)

    @staticmethod
    def open(uri: str) -> "Bank":
        return Bank(uri)

    def __iter__(self) -> Iterator[Sequence]:
        idx = 0
        for path in self.files:
            for rec in _iter_file(path):
                yield Sequence(idx, rec[0], rec[1])
                idx += 1

    def estimate_nb_items(self) -> int:
        return sum(1 for _ in self)

    def estimate_sequences_size(self) -> int:
        return sum(len(s.seq) for s in self)


def iter_codes(uri: str):
    """Yield (header, packed-code uint8 array) per record, using the native
    parser when available (mindthegap_tpu/io/cbank.py), else the python
    reader. This is the graph-build ingestion path."""
    from ..utils import dna
    from . import cbank

    for path in _expand_uri(uri):
        parsed = cbank.parse_codes(path) if cbank.available() else None
        if parsed is not None:
            headers, codes, offsets = parsed
            for i, h in enumerate(headers):
                yield h, codes[offsets[i] : offsets[i + 1]]
        else:
            for rec in _iter_file(path):
                yield rec[0], dna.seq_to_codes(rec[1])


def _iter_file(path: str):
    with _open_text(path) as f:
        first = f.read(1)
        f.seek(0)
        if first == ">":
            header = None
            chunks: list[str] = []
            for line in f:
                line = line.rstrip("\n").rstrip("\r")
                if line.startswith(">"):
                    if header is not None:
                        yield header, "".join(chunks)
                    header = line[1:]
                    chunks = []
                else:
                    chunks.append(line)
            if header is not None:
                yield header, "".join(chunks)
        elif first == "@":
            while True:
                h = f.readline()
                if not h:
                    break
                s = f.readline().rstrip("\n").rstrip("\r")
                f.readline()  # +
                f.readline()  # qual
                yield h[1:].rstrip("\n").rstrip("\r"), s
        else:
            raise ValueError(f"unrecognized sequence file format: {path}")
