"""BAM record codec (unaligned PacBio BAM), from scratch — no htslib here.

Implements the subset of the BAM spec that PacBio subreads/HiFi files use:
unaligned records (refID=-1), full tag typing incl. ``B`` arrays, 4-bit SEQ
packing, SAM-text headers with RG/PG lines (reference output contract:
reference docs, faq/bam-output.md:7-53).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, BinaryIO, Iterator, Optional, Union

import numpy as np

from ccs_tpu_torch.io.bgzf import BgzfReader, BgzfWriter
from ccs_tpu_torch.ops import dna

BAM_MAGIC = b"BAM\x01"

_TAG_FMT = {
    b"c": ("<b", 1), b"C": ("<B", 1), b"s": ("<h", 2), b"S": ("<H", 2),
    b"i": ("<i", 4), b"I": ("<I", 4), b"f": ("<f", 4), b"A": ("<c", 1),
}
_ARRAY_DTYPE = {
    b"c": np.int8, b"C": np.uint8, b"s": np.int16, b"S": np.uint16,
    b"i": np.int32, b"I": np.uint32, b"f": np.float32,
}
_DTYPE_CODE = {np.dtype(v).str: k for k, v in _ARRAY_DTYPE.items()}


@dataclasses.dataclass
class TagValue:
    """A typed BAM tag value; ``type`` is the one-letter BAM type code."""
    type: str       # one of A c C s S i I f Z H B
    value: Any      # scalar, bytes (Z/H), or np.ndarray (B)
    subtype: str = ""  # for B arrays


def _decode_tags(buf: bytes) -> dict[str, TagValue]:
    tags: dict[str, TagValue] = {}
    off, n = 0, len(buf)
    while off + 3 <= n:
        tag = buf[off:off + 2].decode()
        t = buf[off + 2:off + 3]
        off += 3
        if t in _TAG_FMT:
            fmt, size = _TAG_FMT[t]
            (val,) = struct.unpack_from(fmt, buf, off)
            off += size
            if t == b"A":
                val = val.decode()
            tags[tag] = TagValue(t.decode(), val)
        elif t == b"Z" or t == b"H":
            end = buf.index(0, off)
            tags[tag] = TagValue(t.decode(), buf[off:end])
            off = end + 1
        elif t == b"B":
            sub = buf[off:off + 1]
            (count,) = struct.unpack_from("<I", buf, off + 1)
            off += 5
            dt = _ARRAY_DTYPE[sub]
            size = np.dtype(dt).itemsize * count
            arr = np.frombuffer(buf[off:off + size], dtype=dt).copy()
            off += size
            tags[tag] = TagValue("B", arr, sub.decode())
        else:
            raise ValueError(f"unknown BAM tag type {t!r} for tag {tag}")
    return tags


def _encode_tags(tags: dict[str, TagValue]) -> bytes:
    out = bytearray()
    for tag, tv in tags.items():
        out += tag.encode()
        t = tv.type.encode()
        if t in _TAG_FMT:
            out += t
            fmt, _ = _TAG_FMT[t]
            if t == b"A":
                out += struct.pack(fmt, tv.value.encode() if isinstance(tv.value, str) else tv.value)
            else:
                out += struct.pack(fmt, tv.value)
        elif t in (b"Z", b"H"):
            val = tv.value if isinstance(tv.value, bytes) else str(tv.value).encode()
            out += t + val + b"\x00"
        elif t == b"B":
            arr = np.asarray(tv.value)
            sub = tv.subtype.encode() if tv.subtype else _DTYPE_CODE[arr.dtype.str]
            arr = arr.astype(_ARRAY_DTYPE[sub])
            out += b"B" + sub + struct.pack("<I", arr.size) + arr.tobytes()
        else:
            raise ValueError(f"unknown tag type {tv.type}")
    return bytes(out)


@dataclasses.dataclass
class BamRecord:
    """One unaligned BAM record (seq as int8 base codes, qual as raw phred)."""
    name: str
    seq: np.ndarray                 # int8 codes (dna module convention)
    qual: Optional[np.ndarray]      # uint8 phred values or None (0xFF fill)
    tags: dict[str, TagValue] = dataclasses.field(default_factory=dict)
    flag: int = 4                   # unmapped

    # -- convenient typed tag accessors --
    def tag(self, name: str, default=None):
        tv = self.tags.get(name)
        return default if tv is None else tv.value

    def set_tag(self, name: str, type_: str, value, subtype: str = "") -> None:
        self.tags[name] = TagValue(type_, value, subtype)

    def encode(self) -> bytes:
        name_b = self.name.encode() + b"\x00"
        l_seq = len(self.seq)
        seq_packed = dna.pack_nibbles(self.seq)
        if self.qual is None:
            qual_b = b"\xff" * l_seq
        else:
            qual_b = np.asarray(self.qual, dtype=np.uint8).tobytes()
        tags_b = _encode_tags(self.tags)
        body = struct.pack(
            "<iiBBHHHiiii",
            -1, -1,                  # refID, pos
            len(name_b), 255, 4680,  # l_read_name, mapq=255, bin (unaligned convention)
            0, self.flag,            # n_cigar_op, flag
            l_seq, -1, -1, 0,        # l_seq, next_refID, next_pos, tlen
        ) + name_b + seq_packed + qual_b + tags_b
        return struct.pack("<i", len(body)) + body

    @staticmethod
    def decode(body: bytes) -> "BamRecord":
        (ref_id, pos, l_read_name, mapq, bin_, n_cigar, flag, l_seq,
         next_ref, next_pos, tlen) = struct.unpack_from("<iiBBHHHiiii", body, 0)
        off = 32
        name = body[off:off + l_read_name - 1].decode()
        off += l_read_name
        off += 4 * n_cigar  # skip cigar (unaligned input has none)
        seq_bytes = (l_seq + 1) // 2
        seq = dna.unpack_nibbles(body[off:off + seq_bytes], l_seq)
        off += seq_bytes
        qual = np.frombuffer(body[off:off + l_seq], dtype=np.uint8).copy()
        if l_seq and qual[0] == 0xFF and np.all(qual == 0xFF):
            qual = None
        off += l_seq
        tags = _decode_tags(body[off:])
        return BamRecord(name=name, seq=seq, qual=qual, tags=tags, flag=flag)


@dataclasses.dataclass
class BamHeader:
    """SAM-text BAM header; PacBio files carry RG lines with chemistry info."""
    text: str = ""

    def lines(self) -> list[str]:
        return [ln for ln in self.text.split("\n") if ln]

    def read_groups(self) -> list[dict[str, str]]:
        groups = []
        for ln in self.lines():
            if ln.startswith("@RG"):
                fields = dict(f.split(":", 1) for f in ln.split("\t")[1:] if ":" in f)
                groups.append(fields)
        return groups

    def movie_name(self) -> Optional[str]:
        for rg in self.read_groups():
            if "PU" in rg:
                return rg["PU"]
        return None

    def chemistry(self) -> Optional[dict[str, str]]:
        """Parse BINDINGKIT/SEQUENCINGKIT/BASECALLERVERSION from RG DS field.

        The reference aborts if chemistry info is missing
        (reference docs, changelog.md:66 'Abort if input BAM has no
        chemistry information').
        """
        for rg in self.read_groups():
            ds = rg.get("DS", "")
            kv = dict(p.split("=", 1) for p in ds.split(";") if "=" in p)
            if "BINDINGKIT" in kv:
                return kv
        return None


class BamReader:
    """Sequential (+ virtual-offset seekable) BAM reader."""

    def __init__(self, path_or_fileobj):
        self._bgzf = BgzfReader(path_or_fileobj)
        magic = self._bgzf.read(4)
        if magic != BAM_MAGIC:
            raise IOError("not a BAM file")
        (l_text,) = struct.unpack("<i", self._bgzf.read(4))
        self.header = BamHeader(self._bgzf.read(l_text).decode(errors="replace").rstrip("\x00"))
        (n_ref,) = struct.unpack("<i", self._bgzf.read(4))
        self.references = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._bgzf.read(4))
            name = self._bgzf.read(l_name)[:-1].decode()
            (l_ref,) = struct.unpack("<i", self._bgzf.read(4))
            self.references.append((name, l_ref))

    @property
    def tell_virtual(self) -> int:
        return self._bgzf.tell_virtual

    def seek_virtual(self, voffset: int) -> None:
        self._bgzf.seek_virtual(voffset)

    def __iter__(self) -> Iterator[BamRecord]:
        while True:
            rec = self.read_record()
            if rec is None:
                return
            yield rec

    def read_record(self) -> Optional[BamRecord]:
        raw = self._bgzf.read(4)
        if len(raw) < 4:
            return None
        (block_size,) = struct.unpack("<i", raw)
        body = self._bgzf.read(block_size)
        if len(body) < block_size:
            raise IOError("truncated BAM record")
        return BamRecord.decode(body)

    def close(self) -> None:
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BamWriter:
    """BAM writer that records per-record virtual offsets (for .pbi)."""

    def __init__(self, path_or_fileobj, header: BamHeader, level: int = 6):
        self._bgzf = BgzfWriter(path_or_fileobj, level=level)
        self.header = header
        text = header.text.encode()
        self._bgzf.write(BAM_MAGIC)
        self._bgzf.write(struct.pack("<i", len(text)))
        self._bgzf.write(text)
        self._bgzf.write(struct.pack("<i", 0))  # n_ref = 0 (unaligned)
        self._bgzf.flush()  # header gets its own block(s) -> records start clean
        self.voffsets: list[int] = []

    def write_record(self, rec: BamRecord) -> int:
        voff = self._bgzf.tell_virtual
        self.voffsets.append(voff)
        self._bgzf.write(rec.encode())
        return voff

    def close(self) -> None:
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def make_ccs_header(movie: str, read_groups: list[dict[str, str]],
                    program_args: str = "", version: str = "0.1.0") -> BamHeader:
    """Build the HiFi output header (RG DS:READTYPE=CCS[;STRAND=...],
    mode-heteroduplex-filtering.md:41-51)."""
    lines = ["@HD\tVN:1.6\tSO:unknown\tpb:5.0.0"]
    for rg in read_groups:
        fields = "\t".join(f"{k}:{v}" for k, v in rg.items())
        lines.append(f"@RG\t{fields}")
    lines.append(
        f"@PG\tID:ccs_tpu\tPN:ccs_tpu\tVN:{version}\tCL:{program_args}"
    )
    return BamHeader("\n".join(lines) + "\n")
