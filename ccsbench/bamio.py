"""Just enough BAM for the benchmark: write a subreads BAM (+ .pbi) that
repeats a pool of simulated ZMWs under fresh hole numbers, and read back
the records and the report that the program writes.

Written for the benchmark from the SAM/BAM specification and the PacBio
.pbi layout; it shares no code with the program, whose reader is part of
what the benchmark measures.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_TARGET_PAYLOAD = 65280
EOF_MARKER = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
MOVIE = "m00001_260817_000000"
# the chemistry the port ships a model for (BINDINGKIT 101-894-200)
_DS = ("READTYPE=SUBREAD;BINDINGKIT=101-894-200;SEQUENCINGKIT=101-826-100;"
       "BASECALLERVERSION=5.0.0;FRAMERATEHZ=100.0")
HEADER_TEXT = ("@HD\tVN:1.6\tSO:unknown\tpb:5.0.0\n"
               f"@RG\tID:sim0001\tPL:PACBIO\tDS:{_DS}\tPU:{MOVIE}\n")
# hole numbers have HOLE_DIGITS digits, so a record's bytes differ between
# copies only in the hole number
HOLE_BASE, HOLE_DIGITS = 1_000_000, 7
_NIB = np.array([1, 2, 4, 8], dtype=np.uint8)
_NIB_TO_CODE = np.full(16, -1, dtype=np.int8)
_NIB_TO_CODE[[1, 2, 4, 8]] = [0, 1, 2, 3]


def _pack_nibbles(codes: np.ndarray) -> bytes:
    nibs = _NIB[np.asarray(codes, np.int64)]
    if len(nibs) % 2:
        nibs = np.concatenate([nibs, np.zeros(1, np.uint8)])
    return ((nibs[0::2] << 4) | nibs[1::2]).astype(np.uint8).tobytes()


def _block(payload: bytes, level: int) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    data = c.compress(payload) + c.flush()
    head = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"
            + struct.pack("<H", len(data) + 25))
    return head + data + struct.pack("<II", zlib.crc32(payload), len(payload))


class _Bgzf:
    def __init__(self, path: str, level: int):
        self.fh = open(path, "wb")
        self.level = level
        self.buf = bytearray()
        self.coffset = 0

    @property
    def voffset(self) -> int:
        return (self.coffset << 16) | len(self.buf)

    def write(self, data: bytes) -> None:
        self.buf += data
        while len(self.buf) >= _TARGET_PAYLOAD:
            self.flush(_TARGET_PAYLOAD)

    def flush(self, n=None) -> None:
        n = len(self.buf) if n is None else n
        if n:
            block = _block(bytes(self.buf[:n]), self.level)
            del self.buf[:n]
            self.fh.write(block)
            self.coffset += len(block)

    def close(self) -> None:
        self.flush()
        self.fh.write(EOF_MARKER)
        self.fh.close()


def _tag_i(tag: bytes, v: int) -> bytes:
    return tag + b"i" + struct.pack("<i", v)


def _tag_array(tag: bytes, sub: bytes, arr: np.ndarray) -> bytes:
    return tag + b"B" + sub + struct.pack("<I", arr.size) + arr.tobytes()


def zmw_record_parts(z) -> list[tuple]:
    """One simulated ZMW as record templates: (name prefix, name suffix,
    body after the name up to the zm tag, tags after it, qs, qe, cx), so
    that ``write_subreads`` only drops in a hole number. A member with
    kinetics (``z.pws``) gets ``ip`` and ``pw`` as ``B:C`` arrays."""
    parts = []
    qpos = 0
    for p, (read, cx) in enumerate(zip(z.subreads, z.cx)):
        qs, qe = qpos, qpos + len(read)
        qpos = qe + 40
        suffix = f"/{qs}_{qe}".encode() + b"\x00"
        l_seq = len(read)
        body = _pack_nibbles(read) + b"\xff" * l_seq
        tags = (_tag_i(b"qs", qs) + _tag_i(b"qe", qe)
                + b"cxC" + struct.pack("<B", cx) + _tag_i(b"np", 1)
                + _tag_array(b"sn", b"f", np.asarray(z.snr, np.float32))
                + b"rqf" + struct.pack("<f", 0.8) + b"RGZsim0001\x00")
        if z.pws is not None:
            tags += (_tag_array(b"ip", b"C", np.asarray(z.ipds[p], np.uint8))
                     + _tag_array(b"pw", b"C", np.asarray(z.pws[p], np.uint8)))
        parts.append((l_seq, suffix, body, tags, qs, qe, cx))
    return parts


def write_subreads(path: str, pool_parts: list, holes_of_members,
                   level: int = 1) -> list[int]:
    """Write ``path`` and ``path.pbi``: for each (hole, member) of
    ``holes_of_members`` in order, the member's records under that hole.
    Each ZMW ends a BGZF block; returns the file offset at which each ZMW
    ends, so that the file can be cut after any ZMW."""
    name_pre = f"{MOVIE}/".encode()
    bg = _Bgzf(path, level)
    text = HEADER_TEXT.encode()
    bg.write(b"BAM\x01" + struct.pack("<i", len(text)) + text
             + struct.pack("<i", 0))
    bg.flush()
    zm, qs_l, qe_l, cx_l, voffs, ends = [], [], [], [], [], []
    for hole, member in holes_of_members:
        hb = str(hole).encode()
        if len(hb) != HOLE_DIGITS:
            raise ValueError(f"hole {hole} is not {HOLE_DIGITS} digits")
        zm_tag = _tag_i(b"zm", hole)
        for l_seq, suffix, body, tags, qs, qe, cx in pool_parts[member]:
            name = name_pre + hb + suffix
            rec = struct.pack("<iiBBHHHiiii", -1, -1, len(name), 255, 4680,
                              0, 4, l_seq, -1, -1, 0) + name + body \
                + zm_tag + tags
            voffs.append(bg.voffset)
            bg.write(struct.pack("<i", len(rec)) + rec)
            zm.append(hole)
            qs_l.append(qs)
            qe_l.append(qe)
            cx_l.append(cx)
        bg.flush()
        ends.append(bg.coffset)
    bg.close()
    n = len(zm)
    pbi = _Bgzf(path + ".pbi", level)
    pbi.write(b"PBI\x01" + struct.pack("<IHI", 0x040000, 0, n) + b"\x00" * 18
              + np.zeros(n, np.int32).tobytes()
              + np.asarray(qs_l, np.int32).tobytes()
              + np.asarray(qe_l, np.int32).tobytes()
              + np.asarray(zm, np.int32).tobytes()
              + np.full(n, 0.8, np.float32).tobytes()
              + np.asarray(cx_l, np.uint8).tobytes()
              + np.asarray(voffs, np.uint64).tobytes())
    pbi.close()
    return ends


# ---- reading what the program wrote ----

_SCALAR = {b"c": "<b", b"C": "<B", b"s": "<h", b"S": "<H", b"i": "<i",
           b"I": "<I", b"f": "<f", b"A": "<c"}
_ARRAY = {b"c": np.int8, b"C": np.uint8, b"s": np.int16, b"S": np.uint16,
          b"i": np.int32, b"I": np.uint32, b"f": np.float32}


def _inflate(path: str) -> bytes:
    raw = open(path, "rb").read()
    out, off = [], 0
    while off < len(raw):
        if raw[off:off + 4] != b"\x1f\x8b\x08\x04":
            raise IOError(f"{path}: not a BGZF block at {off}")
        xlen = struct.unpack_from("<H", raw, off + 10)[0]
        bsize = None
        i = off + 12
        while i < off + 12 + xlen:
            slen = struct.unpack_from("<H", raw, i + 2)[0]
            if raw[i:i + 2] == b"BC":
                bsize = struct.unpack_from("<H", raw, i + 4)[0] + 1
            i += 4 + slen
        if bsize is None:
            raise IOError(f"{path}: BGZF block without its size")
        out.append(zlib.decompress(raw[off + 12 + xlen:off + bsize - 8], -15))
        off += bsize
    return b"".join(out)


def _tags(buf: bytes, off: int) -> dict:
    tags = {}
    while off + 3 <= len(buf):
        tag, t = buf[off:off + 2].decode(), buf[off + 2:off + 3]
        off += 3
        if t in _SCALAR:
            (v,) = struct.unpack_from(_SCALAR[t], buf, off)
            off += struct.calcsize(_SCALAR[t])
        elif t in (b"Z", b"H"):
            end = buf.index(0, off)
            v, off = buf[off:end], end + 1
        elif t == b"B":
            dt = _ARRAY[buf[off:off + 1]]
            (n,) = struct.unpack_from("<I", buf, off + 1)
            off += 5
            v = np.frombuffer(buf, dt, n, off).copy()
            off += n * np.dtype(dt).itemsize
        else:
            raise IOError(f"unknown BAM tag type {t!r}")
        tags[tag] = v
    return tags


def read_records(path: str) -> list[dict]:
    """Every record of a BAM: name, seq (int8 codes), qual (uint8) and the
    tags."""
    data = _inflate(path)
    if data[:4] != b"BAM\x01":
        raise IOError(f"{path}: not a BAM file")
    (l_text,) = struct.unpack_from("<i", data, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 8 + l_name
    out = []
    while off < len(data):
        (size,) = struct.unpack_from("<i", data, off)
        body = data[off + 4:off + 4 + size]
        off += 4 + size
        l_name, n_cig, l_seq = body[8], struct.unpack_from("<H", body, 12)[0], \
            struct.unpack_from("<i", body, 16)[0]
        p = 32
        name = body[p:p + l_name - 1].decode()
        p += l_name + 4 * n_cig
        packed = np.frombuffer(body, np.uint8, (l_seq + 1) // 2, p)
        nibs = np.empty(2 * len(packed), np.uint8)
        nibs[0::2], nibs[1::2] = packed >> 4, packed & 15
        p += (l_seq + 1) // 2
        qual = np.frombuffer(body, np.uint8, l_seq, p).copy()
        p += l_seq
        out.append({"name": name, "seq": _NIB_TO_CODE[nibs[:l_seq]],
                    "qual": qual, "tags": _tags(body, p)})
    return out


def read_report(path: str) -> dict:
    """The counts of a ccs_report.txt, by label: 'ZMWs input', 'ZMWs pass
    filters', ..., one entry per line that holds a count."""
    out = {}
    with open(path) as fh:
        for line in fh:
            k, _, v = line.partition(":")
            words = v.split()
            if words and words[0].replace(",", "").isdigit():
                out.setdefault(k.strip(), int(words[0].replace(",", "")))
    return out
