"""bgzipped FASTQ writer (reference output format: index.md:55-58)."""

from __future__ import annotations

import numpy as np

from ccs_tpu_torch.io.bgzf import BgzfWriter
from ccs_tpu_torch.ops import dna
from ccs_tpu_torch.pipeline.qvbin import qv_to_ascii


class FastqWriter:
    def __init__(self, path_or_fileobj, level: int = 6):
        self._w = BgzfWriter(path_or_fileobj, level=level)

    def write(self, name: str, seq: np.ndarray, qual: np.ndarray) -> None:
        self._w.write(b"@" + name.encode() + b"\n")
        self._w.write(dna.decode(seq) + b"\n+\n")
        self._w.write(qv_to_ascii(qual) + b"\n")

    def close(self) -> None:
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_fasta(path: str) -> dict:
    """Minimal FASTA reader -> {name: int8 base codes} (control references,
    chemistry-bundle assets). Gzip detected by magic bytes."""
    import gzip as _gzip
    from ccs_tpu_torch.ops import dna
    with open(path, "rb") as fh:
        head = fh.read(2)
    opener = _gzip.open if head == b"\x1f\x8b" else open
    seqs: dict = {}
    name, parts = None, []
    with opener(path, "rb") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(b">"):
                if name is not None:
                    seqs[name] = dna.encode(b"".join(parts))
                name = line[1:].split()[0].decode()
                parts = []
            else:
                parts.append(line)
    if name is not None:
        seqs[name] = dna.encode(b"".join(parts))
    return seqs
