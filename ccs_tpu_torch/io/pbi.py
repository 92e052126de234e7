"""PacBio BAM index (.pbi) reader/writer — basic section.

The .pbi is what enables ``--chunk i/N`` sharding and the progress ETA
(reference docs, faq/parallelize.md:8-20, reports-aux-files.md:192).
Layout follows the public PacBio file-format spec: a BGZF-compressed stream of
a small header plus column-oriented per-read arrays.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from ccs_tpu_torch.io.bgzf import BgzfReader, BgzfWriter

PBI_MAGIC = b"PBI\x01"
PBI_VERSION = 0x040000    # 4.0.0
FLAG_BASIC = 0x0000


@dataclasses.dataclass
class PbiIndex:
    """Column-oriented per-record index data (basic section)."""
    rg_id: np.ndarray        # int32  read-group ID hash
    q_start: np.ndarray      # int32  query start (qs)
    q_end: np.ndarray        # int32  query end (qe)
    hole_number: np.ndarray  # int32  ZMW hole numbers
    read_qual: np.ndarray    # float32
    ctxt_flag: np.ndarray    # uint8  local context flags (cx)
    file_offset: np.ndarray  # uint64 BGZF virtual offsets

    @property
    def n_reads(self) -> int:
        return len(self.hole_number)

    def unique_zmws(self) -> np.ndarray:
        """Distinct hole numbers in file order (first-appearance order)."""
        _, idx = np.unique(self.hole_number, return_index=True)
        return self.hole_number[np.sort(idx)]

    def zmw_chunk_ranges(self, n_chunks: int) -> list[tuple[int, int]]:
        """Split distinct ZMWs into N contiguous chunks (the --chunk i/N math:
        parallelize.md:15-20). Returns [start_zmw_index, end) per chunk."""
        n = len(self.unique_zmws())
        base, rem = divmod(n, n_chunks)
        ranges, start = [], 0
        for i in range(n_chunks):
            size = base + (1 if i < rem else 0)
            ranges.append((start, start + size))
            start += size
        return ranges


def write_pbi(path, index: PbiIndex, level: int = 6) -> None:
    with BgzfWriter(path, level=level) as w:
        n = index.n_reads
        w.write(PBI_MAGIC)
        w.write(struct.pack("<IHI", PBI_VERSION, FLAG_BASIC, n))
        w.write(b"\x00" * 18)  # reserved
        w.write(np.asarray(index.rg_id, dtype=np.int32).tobytes())
        w.write(np.asarray(index.q_start, dtype=np.int32).tobytes())
        w.write(np.asarray(index.q_end, dtype=np.int32).tobytes())
        w.write(np.asarray(index.hole_number, dtype=np.int32).tobytes())
        w.write(np.asarray(index.read_qual, dtype=np.float32).tobytes())
        w.write(np.asarray(index.ctxt_flag, dtype=np.uint8).tobytes())
        w.write(np.asarray(index.file_offset, dtype=np.uint64).tobytes())


def read_pbi(path) -> PbiIndex:
    r = BgzfReader(path)
    try:
        if r.read(4) != PBI_MAGIC:
            raise IOError("not a .pbi file")
        version, flags, n = struct.unpack("<IHI", r.read(10))
        r.read(18)  # reserved

        def col(dtype):
            size = np.dtype(dtype).itemsize * n
            return np.frombuffer(r.read(size), dtype=dtype).copy()

        return PbiIndex(
            rg_id=col(np.int32),
            q_start=col(np.int32),
            q_end=col(np.int32),
            hole_number=col(np.int32),
            read_qual=col(np.float32),
            ctxt_flag=col(np.uint8),
            file_offset=col(np.uint64),
        )
    finally:
        r.close()


def build_index_from_records(records, voffsets, rg_id: int = 0) -> PbiIndex:
    """Build a basic .pbi from in-memory records + their virtual offsets."""
    n = len(records)
    qs = np.zeros(n, dtype=np.int32)
    qe = np.zeros(n, dtype=np.int32)
    zm = np.zeros(n, dtype=np.int32)
    rq = np.full(n, -1.0, dtype=np.float32)
    cx = np.zeros(n, dtype=np.uint8)
    for i, rec in enumerate(records):
        qs[i] = rec.tag("qs", 0)
        qe[i] = rec.tag("qe", len(rec.seq))
        zm[i] = rec.tag("zm", 0)
        rq[i] = rec.tag("rq", -1.0)
        cx[i] = rec.tag("cx", 0)
    return PbiIndex(
        rg_id=np.full(n, rg_id, dtype=np.int32),
        q_start=qs, q_end=qe, hole_number=zm, read_qual=rq, ctxt_flag=cx,
        file_offset=np.asarray(voffsets, dtype=np.uint64),
    )


def filter_pbi(index: PbiIndex, holes) -> PbiIndex:
    """Subset an index to the given hole numbers (CLR subsampling, C17)."""
    keep = np.isin(index.hole_number, np.asarray(sorted(holes), np.int32))
    return PbiIndex(
        rg_id=index.rg_id[keep], q_start=index.q_start[keep],
        q_end=index.q_end[keep], hole_number=index.hole_number[keep],
        read_qual=index.read_qual[keep], ctxt_flag=index.ctxt_flag[keep],
        file_offset=index.file_offset[keep])
