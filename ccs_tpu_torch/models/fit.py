"""Chemistry parameter fitting (SURVEY.md §7 hard-part 6).

A framework-free copy of ``ccs_tpu.models.fit`` on the port's own modules.
PacBio ships per-chemistry Arrow parameter bundles (chemistry.md:27-56)
whose values are not public, so this module estimates the tables from
data: (template, read) pairs — from the simulator in tests, or from real
subreads aligned to their draft consensus in production
(``fit_from_zmws``).

Method: alignment-based counting (hard EM). Each read is aligned to its
template with the native affine aligner; walking the cigar assigns every
read base / template step to one HMM event in its dinucleotide context:

- ``M`` column at template position j: a **Match** emission of the read
  base (ctx = 4*tpl[j-1] + tpl[j]).
- ``I`` column at template boundary j: **Branch** if the inserted base
  equals tpl[j] (the model's branch copies the pending template base,
  models/chemistry.py), else **Stick** with the inserted base.
- ``D`` column at j: a **Delete**.

Counts normalize (with Laplace smoothing) into ``trans`` / ``emit_match`` /
``emit_stick`` per SNR bin. Pulse widths, when provided, are histogrammed
separately for Match vs Branch/Stick emissions; the fitted factors are the
likelihood ratios P(pw bin | event class) / P(pw bin), which satisfy the
ArrowParams gauge E_prior[pw_match] = 1 by construction
(how-does-ccs-work.md:88-95 keys the model on ctx + PW + SNR).

Hard-assignment bias note: MAP alignments slightly over-assign errors to
indels vs the marginal posterior, so recovered rates carry a few-percent
relative bias — well inside the accuracy the consensus needs (the polisher
marginalizes over alignments; tests assert recovery within tolerance).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np

from ccs_tpu_torch.models.chemistry import (ArrowParams, N_CTX, N_PW_BINS,
                                            N_SNR_BINS, default_params)
from ccs_tpu_torch.ops.align import guided_align


@dataclasses.dataclass
class FitCounts:
    """Sufficient statistics; accumulate over pairs, then ``to_params``."""
    trans: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((N_SNR_BINS, N_CTX, 4)))
    emit_match: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((N_SNR_BINS, N_CTX, 4)))
    emit_stick: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((N_SNR_BINS, N_CTX, 4)))
    pw_match: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((N_SNR_BINS, N_PW_BINS)))
    pw_ins: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((N_SNR_BINS, N_PW_BINS)))


def accumulate_pair(counts: FitCounts, tpl: np.ndarray, read: np.ndarray,
                    snr_bin: int, pw_bins: Optional[np.ndarray] = None
                    ) -> bool:
    """Count one (template, read) pair; returns False if alignment failed."""
    tpl = np.asarray(tpl, np.int8)
    read = np.asarray(read, np.int8)
    if len(tpl) < 2 or len(read) < 2:
        return False
    aln = guided_align(read, tpl, sub_cost=6, gap_cost=2, gap_open=2)
    if aln is None or aln.identity() < 0.5:
        return False
    prev = np.concatenate([tpl[:1], tpl[:-1]]).astype(np.int64)
    ctx_at = 4 * prev + tpl                      # ctx of template position j
    s = snr_bin
    i = j = 0
    T = len(tpl)
    for length, op in aln.cigar:
        if op == "M":
            for _ in range(length):
                c = ctx_at[j]
                counts.trans[s, c, 0] += 1.0
                counts.emit_match[s, c, read[i]] += 1.0
                if pw_bins is not None:
                    counts.pw_match[s, pw_bins[i]] += 1.0
                i += 1
                j += 1
        elif op == "D":
            for _ in range(length):
                b = tpl[j]
                in_run = (j + 1 < T and tpl[j + 1] == b) or \
                    (j > 0 and tpl[j - 1] == b)
                # the aligner parks run deletions at the run START (ctx
                # prev->b), but the generative event is equally likely at
                # any run position (ctx b->b) — attribute run events to the
                # homopolymer context or hp rates bias low
                c = 4 * b + b if in_run else ctx_at[j]
                counts.trans[s, c, 3] += 1.0
                j += 1
        else:  # I — insertion at boundary j
            cj = ctx_at[min(j, T - 1)]
            pending = tpl[j] if j < T else -1
            prev_base = tpl[j - 1] if j > 0 else -1
            for _ in range(length):
                b = read[i]
                if b == pending or b == prev_base:
                    # branch (a duplicate of a neighboring template base —
                    # the aligner may park the I on either side of a run);
                    # run duplicates attribute to the homopolymer context
                    nxt2 = tpl[j + 1] if j + 1 < T else -1
                    in_run = (b == pending and b == nxt2) or \
                        (b == pending and b == prev_base)
                    c = 4 * b + b if in_run else (
                        cj if b == pending else ctx_at[j - 1])
                    counts.trans[s, c, 1] += 1.0
                else:
                    counts.trans[s, cj, 2] += 1.0
                    counts.emit_stick[s, cj, b] += 1.0
                if pw_bins is not None:
                    counts.pw_ins[s, pw_bins[i]] += 1.0
                i += 1
    return True


def counts_to_params(counts: FitCounts, name: str = "fitted",
                     snr_edges: Optional[np.ndarray] = None,
                     pw_edges: Optional[np.ndarray] = None,
                     alpha: float = 1.0) -> ArrowParams:
    """Normalize counts into a valid ArrowParams (Laplace-smoothed).

    SNR bins with no data fall back to the nearest populated bin so the
    table has no undefined rows.
    """
    base = default_params(name)
    if snr_edges is None:
        snr_edges = base.snr_edges
    if pw_edges is None:
        pw_edges = base.pw_edges

    trans = counts.trans + alpha
    emit_match = counts.emit_match + alpha
    # stick never emits the template's current base
    cur = np.arange(N_CTX) % 4
    emit_stick = counts.emit_stick + alpha
    emit_stick[:, np.arange(N_CTX), cur] = 0.0

    seen = counts.trans.sum(axis=(1, 2)) > 0               # per snr bin
    if not seen.any():
        raise ValueError("no aligned pairs to fit from")
    # nearest-populated-bin fallback
    bins = np.arange(N_SNR_BINS)
    pop = bins[seen]
    nearest = pop[np.argmin(np.abs(bins[:, None] - pop[None, :]), axis=1)]
    trans = trans[nearest]
    emit_match = emit_match[nearest]
    emit_stick = emit_stick[nearest]

    trans = trans / trans.sum(-1, keepdims=True)
    emit_match = emit_match / emit_match.sum(-1, keepdims=True)
    emit_stick = emit_stick / np.maximum(
        emit_stick.sum(-1, keepdims=True), 1e-12)

    # pulse-width likelihood-ratio factors; bin 0 (unknown) pinned to 1
    pw_match = np.ones((N_SNR_BINS, N_PW_BINS), np.float64)
    pw_ins = np.ones((N_SNR_BINS, N_PW_BINS), np.float64)
    nm = counts.pw_match[nearest]
    ni = counts.pw_ins[nearest]
    have_pw = (nm[:, 1:].sum(-1) + ni[:, 1:].sum(-1)) > 0
    for s in np.nonzero(have_pw)[0]:
        m = nm[s, 1:] + alpha
        i = ni[s, 1:] + alpha
        pm = m / m.sum()
        pi = i / i.sum()
        marg = (m + i) / (m + i).sum()
        pw_match[s, 1:] = pm / marg
        pw_ins[s, 1:] = pi / marg

    p = ArrowParams(
        name=name,
        snr_edges=np.asarray(snr_edges, np.float32),
        trans=trans.astype(np.float32),
        emit_match=emit_match.astype(np.float32),
        emit_stick=emit_stick.astype(np.float32),
        pw_edges=np.asarray(pw_edges, np.float32),
        pw_match=pw_match.astype(np.float32),
        pw_ins=pw_ins.astype(np.float32),
    )
    p.validate()
    return p


def fit_from_pairs(pairs: Iterable[tuple], name: str = "fitted",
                   snr_edges: Optional[np.ndarray] = None,
                   pw_edges: Optional[np.ndarray] = None) -> ArrowParams:
    """Fit from an iterable of (tpl, read, snr_bin[, pw_bins]) tuples."""
    counts = FitCounts()
    n = 0
    for pair in pairs:
        tpl, read, snr_bin = pair[0], pair[1], int(pair[2])
        pw_bins = pair[3] if len(pair) > 3 else None
        if accumulate_pair(counts, tpl, read, snr_bin, pw_bins):
            n += 1
    if n == 0:
        raise ValueError("no aligned pairs to fit from")
    return counts_to_params(counts, name=name, snr_edges=snr_edges,
                            pw_edges=pw_edges)


def fit_from_zmws(zmws, params_hint: Optional[ArrowParams] = None,
                  name: str = "fitted") -> ArrowParams:
    """Fit from real ZMWs: draft each molecule, then count every oriented
    subread against its own draft (the production calibration path — the
    draft is ~99% accurate, how-does-ccs-work.md:46-47, so residual draft
    error adds <1% absolute to the fitted error rates)."""
    from ccs_tpu_torch.ops import dna
    from ccs_tpu_torch.pipeline.draft import generate_draft

    hint = params_hint or default_params()
    counts = FitCounts()
    n = 0
    for z in zmws:
        subs = z.subreads
        if len(subs) < 3:
            continue
        dr = generate_draft([s.seq for s in subs],
                            [s.full_length for s in subs])
        if dr.draft is None:
            continue
        sb = int(hint.snr_bin(float(np.mean(z.snr))))
        for s, strand, mapped in zip(subs, dr.strands, dr.mapped):
            if not mapped:
                continue
            read = dna.revcomp(s.seq) if strand else s.seq
            pw_bins = None
            if s.pw is not None:
                pw = s.pw[::-1] if strand else s.pw
                pw_bins = hint.pw_bin(pw)
            if accumulate_pair(counts, dr.draft, read, sb, pw_bins):
                n += 1
    if n == 0:
        raise ValueError("no usable ZMWs to fit from")
    return counts_to_params(counts, name=name, snr_edges=hint.snr_edges,
                            pw_edges=hint.pw_edges)
