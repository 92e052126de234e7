"""BGZF (blocked gzip) reader/writer, implemented from scratch on zlib.

BGZF is the container for BAM, .pbi and bgzipped FASTQ (reference contract:
reference docs, faq/bam-output.md, parallelize.md:8-13). Each block is a
standalone gzip member with a BC extra subfield holding the total block size;
virtual file offsets are ``coffset << 16 | uoffset`` which makes random access
(chunking over .pbi) possible.

No pysam/htslib in this environment — this module is the foundation of the
whole I/O layer.
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import BinaryIO, Iterator, Optional

MAX_BLOCK = 65536          # max uncompressed payload per block
_TARGET_PAYLOAD = 65280    # leave headroom so compressed block fits in 65536

# 28-byte BGZF EOF marker (an empty block), required at end of file.
EOF_MARKER = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_HEADER = struct.Struct("<4BI2BH")  # magic(4) mtime xfl os xlen


def _compress_block(payload: bytes, level: int) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    data = c.compress(payload) + c.flush()
    # total block size = header(12) + BC subfield(6) + data + crc(4) + isize(4);
    # the BSIZE extra field stores (total - 1)
    bsize_m1 = len(data) + 26 - 1
    if bsize_m1 >= MAX_BLOCK:
        raise ValueError("BGZF payload compressed larger than 64 KiB block")
    header = (
        b"\x1f\x8b\x08\x04"            # gzip magic, deflate, FEXTRA
        b"\x00\x00\x00\x00"            # mtime
        b"\x00\xff"                    # xfl, os=unknown
        b"\x06\x00"                    # xlen = 6
        b"\x42\x43\x02\x00"            # SI1='B' SI2='C' slen=2
        + struct.pack("<H", bsize_m1)  # BSIZE - 1
    )
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return header + data + struct.pack("<II", crc, len(payload))


class BgzfWriter:
    """Streaming BGZF writer with virtual-offset tracking."""

    def __init__(self, fileobj_or_path, level: int = 6):
        if isinstance(fileobj_or_path, (str, bytes)):
            self._fh: BinaryIO = open(fileobj_or_path, "wb")
            self._owns = True
        else:
            self._fh = fileobj_or_path
            self._owns = False
        self._level = level
        self._buf = bytearray()
        self._coffset = 0  # compressed bytes written so far

    @property
    def tell_virtual(self) -> int:
        """Virtual offset of the next byte to be written."""
        return (self._coffset << 16) | len(self._buf)

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= _TARGET_PAYLOAD:
            self._flush_block(_TARGET_PAYLOAD)

    def _flush_block(self, n: Optional[int] = None) -> None:
        n = len(self._buf) if n is None else n
        if n == 0:
            return
        payload = bytes(self._buf[:n])
        del self._buf[:n]
        block = _compress_block(payload, self._level)
        self._fh.write(block)
        self._coffset += len(block)

    def flush(self) -> None:
        """Flush pending payload into a block boundary (safe split point)."""
        self._flush_block()

    def close(self) -> None:
        self._flush_block()
        self._fh.write(EOF_MARKER)
        self._fh.flush()
        if self._owns:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BgzfReader:
    """Random-access BGZF reader supporting virtual-offset seek."""

    def __init__(self, fileobj_or_path):
        if isinstance(fileobj_or_path, (str, bytes)):
            self._fh: BinaryIO = open(fileobj_or_path, "rb")
            self._owns = True
        else:
            self._fh = fileobj_or_path
            self._owns = False
        self._block: bytes = b""
        self._block_coffset = -1   # coffset of currently loaded block
        self._within = 0           # position within current block
        self._next_coffset = 0     # coffset of the next block to load
        self._eof = False

    def _load_block_at(self, coffset: int) -> bool:
        """Load the block starting at compressed offset; False at EOF."""
        self._fh.seek(coffset)
        header = self._fh.read(12)
        if len(header) < 12:
            self._eof = True
            self._block = b""
            self._block_coffset = coffset
            return False
        if header[:4] != b"\x1f\x8b\x08\x04":
            raise IOError(f"not a BGZF block at offset {coffset}")
        xlen = struct.unpack("<H", header[10:12])[0]
        extra = self._fh.read(xlen)
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack("<H", extra[i + 2:i + 4])[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack("<H", extra[i + 4:i + 6])[0] + 1
            i += 4 + slen
        if bsize is None:
            raise IOError("BGZF block missing BC subfield")
        cdata_len = bsize - 12 - xlen - 8
        cdata = self._fh.read(cdata_len)
        self._fh.read(8)  # crc + isize
        payload = zlib.decompress(cdata, -15)
        self._block = payload
        self._block_coffset = coffset
        self._within = 0
        self._next_coffset = coffset + bsize
        self._eof = len(payload) == 0  # empty block = EOF marker
        return not self._eof

    def seek_virtual(self, voffset: int) -> None:
        coffset, within = voffset >> 16, voffset & 0xFFFF
        self._load_block_at(coffset)
        self._within = within

    @property
    def tell_virtual(self) -> int:
        if self._block_coffset < 0:
            return 0
        if self._within == len(self._block) and not self._eof:
            return self._next_coffset << 16
        return (self._block_coffset << 16) | self._within

    def read(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            if self._within >= len(self._block):
                if self._eof or not self._load_block_at(
                    self._next_coffset if self._block_coffset >= 0 else 0
                ):
                    break
            take = min(n, len(self._block) - self._within)
            out += self._block[self._within:self._within + take]
            self._within += take
            n -= take
        return bytes(out)

    def read_all(self) -> bytes:
        chunks = []
        while True:
            chunk = self.read(1 << 20)
            if not chunk:
                break
            chunks.append(chunk)
        return b"".join(chunks)

    def close(self) -> None:
        if self._owns:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def compress_bytes(data: bytes, level: int = 6) -> bytes:
    """One-shot: bytes -> complete BGZF stream (with EOF marker)."""
    out = io.BytesIO()
    with BgzfWriter(out, level=level) as w:
        w.write(data)
    return out.getvalue()


def decompress_bytes(data: bytes) -> bytes:
    return BgzfReader(io.BytesIO(data)).read_all()
