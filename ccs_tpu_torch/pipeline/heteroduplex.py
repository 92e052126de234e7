"""Heteroduplex / single-strand artifact detection (component C5).

reference docs, how-does-ccs-work.md:65-72: a heteroduplex is a >20bp
single difference between the two strands of the SMRTbell. Such molecules
fail with status HETERODUPLEXES (default mode); small heteroduplexes are
kept and only lower the local QV.

Detection here is anchor-span based (host, cheap): for every draft position
we compare the local read-span excess of forward-strand vs reverse-strand
subreads. A one-strand insertion of length L shows up as ~L extra read bases
over a short draft interval for every subread of that strand and none of the
other. We flag the ZMW when the median strand difference exceeds the
threshold anywhere.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

PROBE_STEP = 8     # draft positions between probes
# span must exceed the detection threshold (~21bp) plus the event size the
# draft may absorb; a span shorter than the event saturates the measured
# difference below threshold
PROBE_SPAN = 64


def strand_span_difference(rpos_list: Sequence[Optional[np.ndarray]],
                           strands: Sequence[int],
                           draft_len: int,
                           span: int = PROBE_SPAN) -> np.ndarray:
    """Per-probe |median span excess fwd - median span excess rev|.

    Returns an array over probe positions (empty if either strand lacks
    mapped subreads).
    """
    T = draft_len
    if T < span * 2:
        return np.zeros(0, dtype=np.float64)
    probes = np.arange(0, T - span, PROBE_STEP)
    per_strand: dict[int, list[np.ndarray]] = {0: [], 1: []}
    for rpos, strand in zip(rpos_list, strands):
        if rpos is None:
            continue
        spans = rpos[probes + span] - rpos[probes]
        excess = spans.astype(np.float64) - span
        per_strand[strand].append(excess)
    if not per_strand[0] or not per_strand[1]:
        return np.zeros(0, dtype=np.float64)
    med_f = np.median(np.stack(per_strand[0]), axis=0)
    med_r = np.median(np.stack(per_strand[1]), axis=0)
    return np.abs(med_f - med_r)


def detect_heteroduplex(rpos_list: Sequence[Optional[np.ndarray]],
                        strands: Sequence[int],
                        draft_len: int,
                        min_len: int = 21) -> bool:
    """True if the strands differ by a single event of > min_len-1 bases.

    Multi-scale probes: on noisy molecules the pileup draft partially
    absorbs a one-strand insertion and smears the divergence over more
    than one probe span, capping the measured difference below threshold —
    wider spans integrate the whole event (measured: a 40 bp heteroduplex
    at ~14%/base error peaked at 18 under the 64 bp probe alone).

    One stacked [S, T+1] coordinate matrix serves all three scales
    (identical math to per-scale strand_span_difference: the constant
    -span inside each strand's median cancels in the difference)."""
    live = [(r, s) for r, s in zip(rpos_list, strands) if r is not None]
    if not live:
        return False
    st = np.asarray([s for _, s in live])
    if not (st == 0).any() or not (st == 1).any():
        return False
    R = np.stack([np.asarray(r, dtype=np.int64) for r, _ in live])
    fwd = st == 0
    for span in (PROBE_SPAN, 2 * PROBE_SPAN, 4 * PROBE_SPAN):
        if draft_len < span * 2:
            continue
        probes = np.arange(0, draft_len - span, PROBE_STEP)
        spans = R[:, probes + span] - R[:, probes]        # [S, P]
        med_f = np.median(spans[fwd], axis=0)
        med_r = np.median(spans[~fwd], axis=0)
        if len(probes) and np.max(np.abs(med_f - med_r)) >= min_len:
            return True
    return False


def detect_heteroduplex_pileup(draft: np.ndarray,
                               oriented_reads: Sequence[np.ndarray],
                               strands: Sequence[int],
                               p_threshold: float = 1e-3,
                               min_sites: int = 1) -> bool:
    """--hd-finder substitution detector (mode-heteroduplex-filtering.md:25-31):
    align subreads to the draft, build a strand-split pileup, and use
    Fisher's exact test to find substitution sites with significant strand
    bias (each strand agreeing internally on a different base)."""
    from scipy.stats import fisher_exact
    from ccs_tpu_torch.ops.align import guided_align

    T = len(draft)
    counts = np.zeros((2, T, 4), dtype=np.int64)  # [strand, pos, base]
    for read, strand in zip(oriented_reads, strands):
        aln = guided_align(read, draft, sub_cost=6, gap_cost=2, gap_open=2)
        if aln is None:
            continue
        i = j = 0
        for length, op in aln.cigar:
            if op == "M":
                idx = np.arange(length)
                counts[strand, j + idx, np.clip(read[i + idx], 0, 3)] += 1
                i += length
                j += length
            elif op == "D":
                j += length
            else:
                i += length
    cov = counts.sum(axis=2)             # [2, T]
    if cov[0].max() == 0 or cov[1].max() == 0:
        return False
    maj = counts.argmax(axis=2)          # [2, T]
    # candidate sites: both strands covered >=3 and majority bases differ
    cand = (cov[0] >= 3) & (cov[1] >= 3) & (maj[0] != maj[1])
    n_sites = 0
    for j in np.nonzero(cand)[0]:
        b0, b1 = maj[0, j], maj[1, j]
        table = [[counts[0, j, b0], counts[0, j, b1]],
                 [counts[1, j, b0], counts[1, j, b1]]]
        _, p = fisher_exact(table)
        if p < p_threshold:
            n_sites += 1
            if n_sites >= min_sites:
                return True
    return False
