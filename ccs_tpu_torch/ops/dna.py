"""DNA sequence encoding utilities.

Device-side convention: bases are int8 codes A=0, C=1, G=2, T=3; PAD=-1 (any
negative value is padding / invalid). Host-side sequences are Python ``bytes``
of ASCII ``ACGTN``.
"""

from __future__ import annotations

import numpy as np

A, C, G, T = 0, 1, 2, 3
PAD = -1
N_BASES = 4

_ENCODE = np.full(256, PAD, dtype=np.int8)
for i, b in enumerate(b"ACGT"):
    _ENCODE[b] = i
    _ENCODE[ord(chr(b).lower())] = i
_DECODE = np.frombuffer(b"ACGT", dtype=np.uint8)

# BAM 4-bit nibble codes: =ACMGRSVTWYHKDBN -> our codes (non-ACGT -> PAD)
_NIB_TO_CODE = np.full(16, PAD, dtype=np.int8)
_NIB_TO_CODE[1] = A  # A
_NIB_TO_CODE[2] = C  # C
_NIB_TO_CODE[4] = G  # G
_NIB_TO_CODE[8] = T  # T
_CODE_TO_NIB = np.array([1, 2, 4, 8], dtype=np.uint8)

_COMP = np.array([T, G, C, A], dtype=np.int8)


def encode(seq: bytes | str) -> np.ndarray:
    """ASCII sequence -> int8 codes (non-ACGT -> PAD)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _ENCODE[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray) -> bytes:
    """int8 codes -> ASCII bytes; PAD/invalid -> 'N'."""
    codes = np.asarray(codes)
    valid = (codes >= 0) & (codes < 4)
    out = np.full(codes.shape, ord("N"), dtype=np.uint8)
    out[valid] = _DECODE[codes[valid].astype(np.int64)]
    return out.tobytes()


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of int8 codes (PAD maps to PAD)."""
    codes = np.asarray(codes)
    out = np.where(codes >= 0, _COMP[np.clip(codes, 0, 3)], codes)
    return out[::-1].copy()


def revcomp_str(seq: bytes) -> bytes:
    return decode(revcomp(encode(seq)))


def pack_nibbles(codes: np.ndarray) -> bytes:
    """int8 codes -> BAM 4-bit packed SEQ field (bam-output.md: 0.5 byte/base)."""
    codes = np.asarray(codes)
    nibs = np.where((codes >= 0) & (codes < 4), _CODE_TO_NIB[np.clip(codes, 0, 3)], 15)
    nibs = nibs.astype(np.uint8)
    if len(nibs) % 2:
        nibs = np.concatenate([nibs, np.zeros(1, dtype=np.uint8)])
    return ((nibs[0::2] << 4) | nibs[1::2]).tobytes()


def unpack_nibbles(packed: bytes, length: int) -> np.ndarray:
    """BAM 4-bit packed SEQ -> int8 codes of given length."""
    raw = np.frombuffer(packed, dtype=np.uint8)
    nibs = np.empty(len(raw) * 2, dtype=np.uint8)
    nibs[0::2] = raw >> 4
    nibs[1::2] = raw & 0xF
    return _NIB_TO_CODE[nibs[:length]]
