"""Windowing (component C4): split the draft into ~22bp ±2bp windows.

reference docs, how-does-ccs-work.md:57-63: target size 22bp, ±2bp
overlap, boundaries never inside simple repeats (homopolymers up to 4-mer
repeats) to reduce window-edge cases. Windowing turns O(L²) polishing into
O(L): every window from every ZMW becomes one row of the batched device
polish (SURVEY.md §5 long-context row).

Host-side: cheap, data-dependent bookkeeping. Emits fixed-shape padded
arrays for the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def repeat_runs(seq: np.ndarray, max_period: int = 4) -> np.ndarray:
    """Boolean mask: True where position is inside a simple repeat
    (≥2 consecutive periods of period ≤ max_period)."""
    seq = np.asarray(seq)
    T = len(seq)
    delta = np.zeros(T + 1, dtype=np.int64)
    for p in range(1, max_period + 1):
        if T < 2 * p:
            continue
        eq = seq[p:] == seq[:-p]  # eq[i]: seq[i+p] == seq[i]
        # run[i] = # consecutive eq's ending at i; a maximal eq-run [a..b]
        # with length >= p covers template span [a+p-1 .. b+p]; the hit
        # stretch (run >= p) is [a+p-1 .. b], so each maximal hit stretch
        # [s..e] paints [s .. e+p]. Painted via a difference array.
        idx = np.arange(T - p)
        run = idx - np.maximum.accumulate(np.where(~eq, idx, -1))
        hit = run >= p
        starts = np.nonzero(hit & ~np.concatenate([[False], hit[:-1]]))[0]
        ends = np.nonzero(hit & ~np.concatenate([hit[1:], [False]]))[0]
        np.add.at(delta, starts, 1)
        np.add.at(delta, np.minimum(ends + p + 1, T), -1)
    return np.cumsum(delta[:-1]) > 0


@dataclasses.dataclass
class Window:
    core_a: int  # [core_a, core_b) — this window's exclusive slice of the draft
    core_b: int
    ext_a: int   # [ext_a, ext_b) — with ±overlap margins
    ext_b: int


def cut_windows(draft: np.ndarray, size: int = 22, overlap: int = 2,
                max_shift: int = 8) -> list[Window]:
    """Cut repeat-aware windows over the draft."""
    T = len(draft)
    if T == 0:
        return []
    rep = repeat_runs(draft)
    cuts = [0]
    pos = 0
    while pos + size < T:
        j = pos + size
        # shift the cut right, out of a repeat run (bounded)
        shift = 0
        while j < T and shift < max_shift and rep[min(j, T - 1)]:
            j += 1
            shift += 1
        if j >= T:
            break
        cuts.append(j)
        pos = j
    cuts.append(T)
    wins = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        wins.append(Window(
            core_a=a, core_b=b,
            ext_a=max(0, a - overlap), ext_b=min(T, b + overlap),
        ))
    return wins


@dataclasses.dataclass
class WindowBatch:
    """Fixed-shape device inputs for one ZMW's windows.

    tpl        [W, T_CAP] int8   extended window templates (PAD-filled)
    tlen       [W] int32
    core_start [W] int32         core slice within the window template
    core_end   [W] int32
    reads      [W, C, R_CAP] int8
    rlens      [W, C] int32      (-1 = absent lane)
    full_len   [W, C] bool       subread lane is a full-length pass
    coverage   [W] int32         live lanes per window
    priority   [W, T_CAP] f32    candidate-polish priority (C7; 0 = skip)
    """
    tpl: np.ndarray
    tlen: np.ndarray
    core_start: np.ndarray
    core_end: np.ndarray
    reads: np.ndarray
    rlens: np.ndarray
    full_len: np.ndarray
    coverage: np.ndarray
    priority: np.ndarray
    windows: list[Window]


def candidate_priority(draft: np.ndarray,
                       rpos_list: list,
                       reads: list[np.ndarray]) -> np.ndarray:
    """Per-draft-position polish priority (component C7).

    how-does-ccs-work.md:80-85 / performance.md:90-93: a heuristic picks the
    positions likely to need polishing (pileup disagreement); homopolymers
    are always polished. Positions with zero priority are skipped by the
    candidate polish loop — the documented >=2x speedup, sublinear in
    passes. Disagreement evidence per subread = base mismatch at the
    interpolated read coordinate OR local indel activity (coordinate step
    != 1); interpolation slop between anchors only ever ADDS candidates.
    """
    T = len(draft)
    cnt = np.zeros(T, np.int64)
    ncov = np.zeros(T, np.int64)
    for rpos, read in zip(rpos_list, reads):
        if rpos is None:
            continue
        lo = np.asarray(rpos[:T], dtype=np.int64)
        hi = np.asarray(rpos[1:T + 1], dtype=np.int64)
        live = hi > lo
        code = read[np.clip(lo, 0, max(len(read) - 1, 0))] if len(read) \
            else np.full(T, -1, np.int8)
        base = np.where(code >= 0, code % 4, code)  # packed base+4*pw codes
        mism = (base != draft) | (hi - lo != 1)
        cnt += (mism & live)
        ncov += live
    frac = cnt / np.maximum(ncov, 1)
    cand = (cnt >= np.minimum(2, np.maximum(ncov, 1))) & \
        (cnt * 100 >= 15 * ncov) & (ncov > 0)
    # dilate by 1: an error's evidence bleeds into its neighbors' contexts
    cand[:-1] |= cand[1:]
    cand[1:] |= cand[:-1]
    pri = np.where(cand, 0.5 + frac, 0.0).astype(np.float32)
    # homopolymer runs (>=3) are always polished
    return np.maximum(pri,
                      np.where(hp_run_mask(draft), np.float32(0.5), 0.0))


def hp_run_mask(draft: np.ndarray, min_run: int = 3) -> np.ndarray:
    """Positions inside a homopolymer run of length >= min_run (always
    polished — how-does-ccs-work.md:80-85)."""
    T = len(draft)
    hp = np.zeros(T, dtype=bool)
    if T >= min_run:
        run = (draft[1:] == draft[:-1])
        hp3 = run[1:] & run[:-1]            # center of a >=3 run
        idx = np.nonzero(hp3)[0]
        hp[idx] = True
        hp[idx + 1] = True
        hp[idx + 2] = True
    return hp


def candidate_priority_from_stats(draft: np.ndarray, stats: np.ndarray,
                                  min_cov: float = 4.0,
                                  abs_floor: float = 2.5,
                                  frac: float = 0.35,
                                  dilate: int = 0) -> np.ndarray:
    """Per-draft-position polish priority from REAL pileup evidence (C7).

    ``stats`` is [T, 3] f32 (cov, agree, indel) recorded by the draft
    pileup's final vote round (real affine alignments of every subread —
    pipeline.draft._pileup_consensus), replacing the anchor-interpolation
    heuristic that flagged ~100% of positions and made the documented >=2x
    candidate-skip saving (performance.md:90-93) unreachable. A position is
    a candidate iff the pileup shows real ambiguity:

    - disagreement mass (cov - agree + indel evidence) >= max(abs_floor,
      frac * cov), or
    - thin coverage (cov < min_cov: too few votes to trust agreement), or
    - inside a homopolymer run >= 3 (always polished per the reference).

    No dilation by default: a substitution/deletion at p is fixable by the
    mutation set AT p, and a missing base at junction j carries ins-vote
    evidence attributed to BOTH j-1 and j, so the fixing position is always
    flagged by its own evidence. Measured on 8x 2 kb/10-pass SNR-9 ZMWs:
    36% flagged, consensus errors 45 vs 47 exhaustive (selection-gated
    polish loses nothing). Positions the polisher skips keep their draft
    base and take the calibrated clean-position QV (polish_fused).
    """
    T = len(draft)
    cov = stats[:, 0].astype(np.float64)
    agree = stats[:, 1].astype(np.float64)
    indel = stats[:, 2].astype(np.float64)
    disagree = cov - agree + indel
    cand = (cov < min_cov) | (disagree >= np.maximum(abs_floor, frac * cov))
    for _ in range(dilate):
        cand[:-1] |= cand[1:]
        cand[1:] |= cand[:-1]
    denom = np.maximum(cov, 1.0)
    pri = np.where(cand, 0.5 + disagree / denom, 0.0).astype(np.float32)
    return np.maximum(pri,
                      np.where(hp_run_mask(draft), np.float32(0.5), 0.0))


def build_window_batch(draft: np.ndarray,
                       rpos_list: list[np.ndarray],
                       reads: list[np.ndarray],
                       full_length: list[bool],
                       t_cap: int = 44, r_cap: int = 47, c_cap: int = 32,
                       size: int = 22, overlap: int = 4,
                       max_insertion_size: int = 30,
                       pri_draft: Optional[np.ndarray] = None) -> WindowBatch:
    """Slice every mapped subread into every window.

    ``rpos_list[s][j]`` = read coordinate of subread s at draft position j
    (from its alignment to the draft, or interpolated from anchors).
    Component C6 (how-does-ccs-work.md:74-78): a slice carrying an insertion
    larger than ``max_insertion_size`` relative to the window is spurious
    sequencing activity that confounds window polishing — that lane is
    dropped for that window instead of feeding a wrong global alignment.
    """
    wins = cut_windows(draft, size=size, overlap=overlap)
    W = len(wins)
    S = len(reads)
    C = min(S, c_cap)
    if S > C:
        # lane overflow: full-length passes claim lanes first (stable order,
        # so the alternating strands stay balanced) instead of dropping
        # whichever passes happened to sort last — ec semantics use "all
        # subreads" (accuracy-vs-passes.md:15-29), so the evidence kept
        # should be the best available, not the first encountered
        order = sorted(range(S), key=lambda s: (not full_length[s], s))
        rpos_list = [rpos_list[s] for s in order]
        reads = [reads[s] for s in order]
        full_length = [full_length[s] for s in order]
    ext_a = np.asarray([w.ext_a for w in wins], dtype=np.int64)
    ext_b = np.asarray([w.ext_b for w in wins], dtype=np.int64)
    win_len = ext_b - ext_a
    L = np.minimum(win_len, t_cap)

    # template / priority / core bookkeeping: one [W, t_cap] gather each
    j = np.arange(t_cap)
    gidx = ext_a[:, None] + j[None, :]
    valid_t = j[None, :] < L[:, None]
    gclip = np.minimum(gidx, max(len(draft) - 1, 0))
    tpl = np.where(valid_t, draft[gclip], -1).astype(np.int8)
    if pri_draft is None:
        pri_draft = candidate_priority(draft, rpos_list, reads)
    priority = np.where(valid_t, pri_draft[gclip], 0.0).astype(np.float32)
    tlen = L.astype(np.int32)
    core_start = (np.asarray([w.core_a for w in wins]) - ext_a).astype(
        np.int32)
    core_end = np.minimum(
        np.asarray([w.core_b for w in wins]) - ext_a, L).astype(np.int32)

    out_reads = np.full((W, C, r_cap), -1, dtype=np.int8)
    rlens = np.full((W, C), -1, dtype=np.int32)
    fl = np.zeros((W, C), dtype=bool)
    flat = out_reads.reshape(-1)
    # trim threshold also honors the device read cap: a slice that would
    # silently truncate at r_cap instead gets its insertion burst excised,
    # keeping the window-end evidence intact
    keep_cap = np.minimum(win_len + 8, r_cap)
    trim_thresh = np.minimum(win_len + max_insertion_size, r_cap)

    # all (read, window) pairs at once: one [S, W] coordinate block, one
    # lane-assignment cumsum, ONE flat scatter for every easy slice (the
    # per-read Python pass was a measurable slice of host prepare time)
    live_rows = [s for s in range(S) if rpos_list[s] is not None]
    if live_rows:
        rpos_all = np.stack([np.asarray(rpos_list[s], dtype=np.int64)
                             for s in live_rows])            # [S', T+1]
        los = rpos_all[:, ext_a]                             # [S', W]
        his = rpos_all[:, ext_b]
        spans = his - los
        # order-preserving per-window lane index (same fill order as the
        # sequential loop: reads in input order claim lanes first)
        pre_valid = spans > 0
        lanes = np.cumsum(pre_valid, axis=0) - pre_valid     # [S', W]
        valid = pre_valid & (lanes < C)
        trim = valid & (spans > trim_thresh)
        easy = valid & ~trim
        si, wi = np.nonzero(easy)
        if len(wi):
            lens = np.minimum(spans[si, wi], r_cap)
            read_off = np.asarray(
                [0] + [len(reads[s]) for s in live_rows[:-1]],
                np.int64).cumsum()
            reads_flat = (np.concatenate([reads[s] for s in live_rows])
                          if live_rows else np.empty(0, np.int8))
            rep = np.repeat(np.arange(len(wi)), lens)
            off = np.arange(int(lens.sum())) - np.repeat(
                np.cumsum(lens) - lens, lens)
            src = (read_off[si] + los[si, wi])[rep] + off
            dest = ((wi * C + lanes[si, wi]) * r_cap)[rep] + off
            flat[dest] = reads_flat[src]
            rlens[wi, lanes[si, wi]] = lens
            fl[wi, lanes[si, wi]] = np.asarray(
                [full_length[live_rows[s]] for s in si], bool) \
                if len(si) else False
        for s, w in zip(*np.nonzero(trim)):
            # large-insertion trim (C6, how-does-ccs-work.md:74-78): excise
            # the oversized insertion burst instead of dropping the whole
            # lane (the rest of the pass is good evidence). The burst sits
            # at the largest read-coordinate jump of the window span; cut
            # the excess out around it, keeping win_len + a small slack.
            rpos = rpos_list[live_rows[s]]
            rd = reads[live_rows[s]]
            lo, hi = int(los[s, w]), int(his[s, w])
            keep = int(keep_cap[w])
            a, b = int(ext_a[w]), int(ext_b[w])
            steps = np.diff(np.asarray(rpos[a:b + 1], dtype=np.int64))
            j_burst = int(np.argmax(steps))
            cut = int(rpos[a + j_burst]) + 1
            excess = (hi - lo) - keep
            left = rd[lo:min(cut, lo + keep)]
            right = rd[max(cut + excess, cut):hi]
            piece = np.concatenate([left, right])[:r_cap]
            lane = int(lanes[s, w])
            out_reads[w, lane, :len(piece)] = piece
            rlens[w, lane] = len(piece)
            fl[w, lane] = full_length[live_rows[s]]
        coverage = np.minimum(pre_valid.sum(axis=0), C).astype(np.int32)
    else:
        coverage = np.zeros(W, dtype=np.int32)
    return WindowBatch(tpl, tlen, core_start, core_end, out_reads, rlens,
                       fl, coverage, priority, wins)
