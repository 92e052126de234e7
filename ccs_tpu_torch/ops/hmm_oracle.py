"""NumPy log-space oracle for the Arrow-style pair-HMM (SURVEY.md §4.2(1)).

The port's own copy of ``ccs_tpu.ops.hmm_oracle``. Slow, simple,
obviously-correct reference implementation used to validate the batched
forward and scorers. Semantics defined in ccs_tpu_torch.models.chemistry.

Indexing convention: ``alpha[i, j]`` = probability of having emitted the read
prefix ``read[:i]`` and sitting at template position ``j`` (about to act on
``tpl[j]``). Transitions out of position ``j`` use the dinucleotide context
``ctx[j] = 4*tpl[j-1] + tpl[j]`` (position 0 uses ``prev = tpl[0]``).
Insertions are disallowed at ``j == T`` (past the end), so the process
terminates exactly when the read is exhausted at ``j == T``.
"""

from __future__ import annotations

import numpy as np

from ccs_tpu_torch.models.chemistry import ArrowParams

NEG_INF = -1e30


def position_tables(tpl: np.ndarray, params: ArrowParams, snr_bin: int):
    """Per-template-position probability tables.

    Returns (match_emit [T,4], ins_emit [T,4], del_p [T]):
    - match_emit[j, b] = P(Match at j, emitting read base b), advances j
    - ins_emit[j, b]   = P(Branch/Stick at j emitting b), stays at j
    - del_p[j]         = P(Delete at j), advances j silently
    """
    tpl = np.asarray(tpl, dtype=np.int64)
    T = len(tpl)
    prev = np.concatenate([tpl[:1], tpl[:-1]])
    ctx = 4 * prev + tpl
    trans = params.trans[snr_bin][ctx]          # [T, 4]
    em = params.emit_match[snr_bin][ctx]        # [T, 4]
    es = params.emit_stick[snr_bin][ctx]        # [T, 4]
    match_emit = trans[:, 0:1] * em
    onehot = np.eye(4)[tpl]
    ins_emit = trans[:, 1:2] * onehot + trans[:, 2:3] * es
    del_p = trans[:, 3]
    return match_emit, ins_emit, del_p


def decode_read(read: np.ndarray, params: ArrowParams, snr_bin: int):
    """Split packed read codes (base + 4*pw_bin, chemistry.pack_read_pw)
    into bases [R] and per-base log pw factors (lfm, lfi) for Match and
    Branch/Stick emissions. Plain-base reads (codes 0..3) are pw bin 0
    (unknown) whose factors are pinned to 1."""
    codes = np.asarray(read, dtype=np.int64)
    bases = codes % 4
    w = codes // 4
    lfm = np.log(params.pw_match[snr_bin][w])
    lfi = np.log(params.pw_ins[snr_bin][w])
    return bases, lfm, lfi


def forward_matrix(tpl, read, params: ArrowParams, snr_bin: int = 0) -> np.ndarray:
    """Full log-space forward matrix alpha [R+1, T+1]."""
    match_emit, ins_emit, del_p = position_tables(tpl, params, snr_bin)
    bases, lfm, lfi = decode_read(read, params, snr_bin)
    T, R = len(tpl), len(read)
    with np.errstate(divide="ignore"):
        lme = np.log(match_emit)
        lie = np.log(ins_emit)
        ldp = np.log(del_p)
    alpha = np.full((R + 1, T + 1), NEG_INF)
    alpha[0, 0] = 0.0
    for j in range(1, T + 1):  # delete chain on row 0
        alpha[0, j] = alpha[0, j - 1] + ldp[j - 1]
    for i in range(1, R + 1):
        b = int(bases[i - 1])
        for j in range(T + 1):
            terms = []
            if j > 0:
                terms.append(alpha[i - 1, j - 1] + lme[j - 1, b] + lfm[i - 1])
                terms.append(alpha[i, j - 1] + ldp[j - 1])
            if j < T:
                terms.append(alpha[i - 1, j] + lie[j, b] + lfi[i - 1])
            alpha[i, j] = _logsumexp(terms) if terms else NEG_INF
    return alpha


def forward_ll(tpl, read, params: ArrowParams, snr_bin: int = 0) -> float:
    """Log-likelihood log P(read | tpl), marginalized over alignments."""
    if len(tpl) == 0:
        return 0.0 if len(read) == 0 else NEG_INF
    return float(forward_matrix(tpl, read, params, snr_bin)[len(read), len(tpl)])


def backward_matrix(tpl, read, params: ArrowParams, snr_bin: int = 0) -> np.ndarray:
    """Log-space backward matrix beta [R+1, T+1]; beta[0,0] == total LL."""
    match_emit, ins_emit, del_p = position_tables(tpl, params, snr_bin)
    bases, lfm, lfi = decode_read(read, params, snr_bin)
    T, R = len(tpl), len(read)
    with np.errstate(divide="ignore"):
        lme = np.log(match_emit)
        lie = np.log(ins_emit)
        ldp = np.log(del_p)
    beta = np.full((R + 1, T + 1), NEG_INF)
    beta[R, T] = 0.0
    for i in range(R, -1, -1):
        for j in range(T, -1, -1):
            if i == R and j == T:
                continue
            terms = []
            if j < T:
                if i < R:
                    terms.append(beta[i + 1, j + 1] + lme[j, int(bases[i])]
                                 + lfm[i])
                terms.append(beta[i, j + 1] + ldp[j])
                if i < R:
                    terms.append(beta[i + 1, j] + lie[j, int(bases[i])]
                                 + lfi[i])
            elif i < R:
                pass  # no insertions at j == T
            beta[i, j] = _logsumexp(terms) if terms else NEG_INF
    return beta


def brute_force_ll(tpl, read, params: ArrowParams, snr_bin: int = 0) -> float:
    """Exponential-time path enumeration (independent of the DP formulation).

    Only usable for very small tpl/read (≤ ~8 bp).
    """
    match_emit, ins_emit, del_p = position_tables(tpl, params, snr_bin)
    bases, lfm, lfi = decode_read(read, params, snr_bin)
    fm, fi = np.exp(lfm), np.exp(lfi)
    T = len(tpl)

    def rec(i: int, j: int) -> float:
        if j == T:
            return 1.0 if i == len(read) else 0.0
        total = del_p[j] * rec(i, j + 1)
        if i < len(read):
            b = int(bases[i])
            total += fm[i] * match_emit[j, b] * rec(i + 1, j + 1)
            total += fi[i] * ins_emit[j, b] * rec(i + 1, j)
        return total

    p = rec(0, 0)
    return float(np.log(p)) if p > 0 else NEG_INF


def _logsumexp(terms) -> float:
    arr = np.asarray(terms)
    m = arr.max()
    if m <= NEG_INF:
        return NEG_INF
    return float(m + np.log(np.exp(arr - m).sum()))
