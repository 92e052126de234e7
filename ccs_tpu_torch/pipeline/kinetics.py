"""HiFi kinetics averaging (component C14).

reference docs, faq/kinetics.md: ``--hifi-kinetics`` adds per-strand
averaged IPD/PW to polished reads. Forward (``fi``/``fp``/``fn``) is the
orientation of SEQ; reverse (``ri``/``rp``/``rn``) is stored in the reverse
strand's native orientation. If one orientation was filtered out entirely,
its lists are empty and its pass count zero (kinetics.md:15-18).

Frame counts use the PacBio lossy 8-bit "codec V1" (bam-output.md tags
``B,C``): 0-63 direct, then 2/4/8-frame steps.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ccs_tpu_torch.ops import dna
from ccs_tpu_torch.ops.align import guided_align


def codec_v1_decode(codes: np.ndarray) -> np.ndarray:
    c = np.asarray(codes, dtype=np.int64)
    out = np.where(c < 64, c,
                   np.where(c < 128, (c - 64) * 2 + 64,
                            np.where(c < 192, (c - 128) * 4 + 192,
                                     (c - 192) * 8 + 448)))
    return out.astype(np.uint16)


def codec_v1_encode(frames: np.ndarray) -> np.ndarray:
    f = np.asarray(frames, dtype=np.int64)
    out = np.where(f < 64, f,
                   np.where(f < 192, (f - 64) // 2 + 64,
                            np.where(f < 448, (f - 192) // 4 + 128,
                                     np.minimum((f - 448) // 8 + 192, 255))))
    return out.astype(np.uint8)


@dataclasses.dataclass
class KineticsEntry:
    """One subread's contribution, already oriented to the consensus strand
    buckets: ``read`` is in forward-consensus orientation if strand==0, in
    native (unflipped) orientation if strand==1."""
    read: np.ndarray                 # int8 codes, oriented per strand rules
    ipd: Optional[np.ndarray]        # codec-V1 uint8, same orientation as read
    pw: Optional[np.ndarray]
    strand: int                      # 0 fwd, 1 rev
    full_length: bool = True


@dataclasses.dataclass
class KineticsResult:
    fi: np.ndarray  # fwd IPD (codec V1), len == consensus
    fp: np.ndarray  # fwd PW
    fn: int         # fwd complete passes
    ri: np.ndarray  # rev IPD, reverse-native orientation
    rp: np.ndarray  # rev PW
    rn: int


def _average_one_strand(target: np.ndarray,
                        entries: list[KineticsEntry]) -> tuple[np.ndarray, np.ndarray, int]:
    L = len(target)
    ipd_sum = np.zeros(L, dtype=np.float64)
    pw_sum = np.zeros(L, dtype=np.float64)
    cov = np.zeros(L, dtype=np.int64)
    n_pass = 0
    for e in entries:
        if e.ipd is None or e.pw is None:
            continue
        aln = guided_align(e.read, target)
        if aln is None:
            continue
        n_pass += int(e.full_length)
        ipd = codec_v1_decode(e.ipd)
        pw = codec_v1_decode(e.pw)
        i = j = 0
        for length, op in aln.cigar:
            if op == "M":
                idx = np.arange(length)
                ipd_sum[j + idx] += ipd[i + idx]
                pw_sum[j + idx] += pw[i + idx]
                cov[j:j + length] += 1
                i += length
                j += length
            elif op == "D":
                j += length
            else:
                i += length
    safe = np.maximum(cov, 1)
    return (codec_v1_encode(np.round(ipd_sum / safe)),
            codec_v1_encode(np.round(pw_sum / safe)),
            n_pass)


def average_kinetics(consensus: np.ndarray,
                     entries: Sequence[KineticsEntry]) -> KineticsResult:
    """Average subread kinetics per strand in consensus coordinates."""
    fwd = [e for e in entries if e.strand == 0]
    rev = [e for e in entries if e.strand == 1]
    if fwd:
        fi, fp, fn = _average_one_strand(consensus, fwd)
    else:
        fi = fp = np.zeros(0, dtype=np.uint8)
        fn = 0
    if rev:
        # reverse-strand averaging happens against the reverse-complement
        # consensus so ri/rp come out in reverse-native orientation
        ri, rp, rn = _average_one_strand(dna.revcomp(consensus), rev)
    else:
        ri = rp = np.zeros(0, dtype=np.uint8)
        rn = 0
    return KineticsResult(fi, fp, fn, ri, rp, rn)
