"""SAM lines parsed into records, and base codes of text."""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

CODE = np.full(256, 15, np.int8)
for _i, _c in enumerate("ACGT"):
    CODE[ord(_c)] = _i
    CODE[ord(_c.lower())] = _i

_CIGAR = re.compile(r"(\d+)([MIDNSHP=X])")


@dataclass
class Record:
    qname: str
    flag: int
    rname: str
    pos: int
    mapq: int
    cigar: list
    rnext: str
    pnext: int
    tlen: int
    seq: str
    qual: str
    tags: dict = field(default_factory=dict)

    @property
    def reverse(self) -> bool:
        return bool(self.flag & 0x10)

    @property
    def mapped(self) -> bool:
        return not self.flag & 0x4


def parse(line: str) -> Record:
    f = line.split("\t")
    tags = {}
    for t in f[11:]:
        k, typ, v = t.split(":", 2)
        tags[k] = int(v) if typ == "i" else v
    cig = ([] if f[5] == "*"
           else [(int(n), op) for n, op in _CIGAR.findall(f[5])])
    return Record(qname=f[0], flag=int(f[1]), rname=f[2], pos=int(f[3]),
                  mapq=int(f[4]), cigar=cig, rnext=f[6], pnext=int(f[7]),
                  tlen=int(f[8]), seq=f[9], qual=f[10], tags=tags)


def codes(text: str) -> np.ndarray:
    return CODE[np.frombuffer(text.encode(), np.uint8)]


def revcomp(text: str) -> str:
    return text.translate(str.maketrans("ACGTacgt", "TGCAtgca"))[::-1]
