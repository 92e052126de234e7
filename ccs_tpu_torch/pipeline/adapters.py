"""Adapter / artifact classifiers (component C15).

- ``ma``/``ac`` tags from subread ``cx`` ADAPTER_BEFORE_BAD/AFTER_BAD flags
  (reference docs, faq/missing-adapters.md:7-28). Flags are per subread
  in subread orientation; strand maps them onto molecule left/right.
- fail-read classes (fail-reads.md:12-21, reports-aux-files.md:38-43):
  adapter concatenation (read is mostly adapter), adapter palindrome
  (miscalled adapter with reverse-complemented insert), adapter residue
  (adapter sequence near either end) — detected against the standard
  SMRTbell adapter; also the ``ff`` fail-flag bitmask.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ccs_tpu_torch.ops import dna
from ccs_tpu_torch.ops.align import anchor_chain, guided_align

# cx LocalContextFlags (PacBio BAM spec)
CX_ADAPTER_BEFORE = 0x1
CX_ADAPTER_AFTER = 0x2
CX_BARCODE_BEFORE = 0x4
CX_BARCODE_AFTER = 0x8
CX_FORWARD_PASS = 0x10
CX_REVERSE_PASS = 0x20
CX_ADAPTER_BEFORE_BAD = 0x40
CX_ADAPTER_AFTER_BAD = 0x80

# ff fail-flag bitmask (fail-reads.md:12-21)
FF_BELOW_Q20 = 0x1
FF_CONTROL = 0x2
FF_SINGLE_STRAND = 0x4
FF_MEDIAN_SUBREAD = 0x8
FF_ADAPTER_CONCAT = 0x10
FF_ADAPTER_PALINDROME = 0x20
FF_ADAPTER_RESIDUE = 0x40

# standard SMRTbell hairpin adapter (public)
SMRTBELL_ADAPTER = dna.encode(b"ATCTCTCTCTTTTCCTCCTCCTCCGTTGTTGTTGTTGAGAGAGAT")


@dataclasses.dataclass
class AdapterInfo:
    ac: np.ndarray  # [detected_left, missing_left, detected_right, missing_right]
    ma: int         # 0x1 missing left, 0x2 missing right


def adapter_counts(cx_flags: Sequence[int], strands: Sequence[int]) -> AdapterInfo:
    """Aggregate per-subread adapter evidence onto molecule left/right."""
    det_l = miss_l = det_r = miss_r = 0
    for cx, strand in zip(cx_flags, strands):
        before_ok = bool(cx & CX_ADAPTER_BEFORE)
        after_ok = bool(cx & CX_ADAPTER_AFTER)
        before_bad = bool(cx & CX_ADAPTER_BEFORE_BAD)
        after_bad = bool(cx & CX_ADAPTER_AFTER_BAD)
        # a reverse-pass subread's 'before' is the molecule's right side
        l_ok, l_bad = (before_ok, before_bad) if strand == 0 else (after_ok, after_bad)
        r_ok, r_bad = (after_ok, after_bad) if strand == 0 else (before_ok, before_bad)
        det_l += l_ok and not l_bad
        miss_l += l_bad
        det_r += r_ok and not r_bad
        miss_r += r_bad
    ma = 0
    if miss_l > det_l:
        ma |= 0x1
    if miss_r > det_r:
        ma |= 0x2
    return AdapterInfo(
        ac=np.asarray([det_l, miss_l, det_r, miss_r], dtype=np.int32), ma=ma)


def _adapter_hits(seq: np.ndarray, k: int = 11,
                  min_anchors: int = 4) -> list[int]:
    """Approximate adapter hit positions in seq (anchor-chain based).

    The adapter is the anchor template (its k-mers are unique within it), so
    repeated adapter copies in ``seq`` still produce hits. min_anchors = 4:
    two co-linear random 11-mer matches occur in ~5% of random 15 kb
    sequences and three in ~2% (measured; the round-4 24-ZMW sample was
    too small to expose it), while a real adapter copy carries ~35
    anchors — four co-linear anchors keep full sensitivity with a
    negligible false-positive rate at any read length."""
    hits = []
    for adapter in (SMRTBELL_ADAPTER, dna.revcomp(SMRTBELL_ADAPTER)):
        chain = anchor_chain(seq, adapter, k)
        if len(chain) >= min_anchors:
            hits.append(int(chain[0, 0]))
    return hits


def classify_adapter_artifacts(seq: np.ndarray,
                               end_margin: int = 100) -> int:
    """Returns an ff-style bitmask of adapter artifact classes for seq."""
    L = len(seq)
    if L == 0:
        return 0
    flags = 0
    hits = _adapter_hits(seq)
    if hits:
        # concatenation: read is (mostly) adapter copies
        if L <= 3 * len(SMRTBELL_ADAPTER):
            flags |= FF_ADAPTER_CONCAT
        elif any(h < end_margin or h > L - end_margin - len(SMRTBELL_ADAPTER)
                 for h in hits):
            flags |= FF_ADAPTER_RESIDUE
        else:
            # interior adapter: palindrome check — the two flanks should be
            # reverse complements of each other
            h = hits[0]
            a, b = seq[:h], seq[h + len(SMRTBELL_ADAPTER):]
            n = min(len(a), len(b), 500)
            if n > 50:
                # if b ~= revcomp(a), then revcomp(b) ~= a: compare prefixes
                aln = guided_align(dna.revcomp(b)[:n], a[:n])
                if aln is not None and aln.identity() > 0.75:
                    flags |= FF_ADAPTER_PALINDROME
                else:
                    flags |= FF_ADAPTER_RESIDUE
            else:
                flags |= FF_ADAPTER_RESIDUE
    return flags
