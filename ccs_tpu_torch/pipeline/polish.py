"""TEST ORACLE — the round-1 dense Arrow polishing loop, kept ONLY as an
independent implementation for cross-checking the fused product path
(pipeline.polish_fused); no product code imports this module.

Counterpart of ``ccs_tpu.pipeline.polish``, with its names. For every
position, test whether the summed subread log-likelihood improves by
substituting one of the other three nucleotides, inserting one of four
after the position, or deleting the position; apply the best improvement;
repeat until no beneficial mutation remains. QVs fall out of the same
mutation scores at convergence.

All windows advance in lock-step; converged windows become no-ops through
an active mask. The JAX ``lax.while_loop`` is a host loop here: its
condition is one device-to-host read per iteration. Mutation scoring is
either a full re-forward of every mutant template (``scoring="dense"``, the
brute force: ``ops.hmm_forward.forward_batch`` over [window x mutation x
subread] lanes, chunked over mutations) or column bridging
(``scoring="cols"``, ``ops.hmm_cols``). Equivalent mutants (deleting any
base of a homopolymer run, inserting x anywhere along a run of x) build
the same template, so their brute-force scores are bit-identical and the
first maximum is the leftmost member, whatever the device.

Round-1 enumeration: M = 8T + 4; mutation m < 8T is position m // 8 with
kind m % 8: kinds 0-2 substitute (tpl[pos]+1+kind) % 4, 3 deletes pos, 4-7
insert base kind-4 after pos; m >= 8T prepends base m - 8T before
position 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ccs_tpu_torch.ops.hmm_cols import (MUTS_PER_POS, bridge_scores,
                                        build_columns, mutation_ops_at,
                                        prepend_ops, score_mutants_cols)
from ccs_tpu_torch.ops.hmm_forward import forward_batch

NEG = -1e30


class PolishState(NamedTuple):
    tpl: torch.Tensor         # [B, T] int8
    tlen: torch.Tensor        # [B] int32
    core_start: torch.Tensor  # [B] int32
    core_end: torch.Tensor    # [B] int32
    ll: torch.Tensor          # [B] f32 current summed log-likelihood
    active: torch.Tensor      # [B] bool still improving
    n_iter: torch.Tensor      # [B] int32 iterations executed
    mut_lls: torch.Tensor     # [B, M] f32 mutation scores of the last-scored
                              # template (the final one at convergence)


def _gather_t(tpl, idx):
    """tpl [B, T] gathered along the template axis by idx [B, ..., T]
    (broadcast over the middle axes)."""
    B, T = tpl.shape
    src = tpl.reshape((B,) + (1,) * (idx.dim() - 2) + (T,)).expand(
        idx.shape[:-1] + (T,))
    return torch.gather(src, -1, idx)


def make_mutants(tpl, tlen):
    """All single-edit mutants of each template.

    tpl [B, T] -> mut_tpl [B, M, T] int8, mut_tlen [B, M] int32, valid
    [B, M] bool, M = 8T + 4 (module docstring)."""
    B, T = tpl.shape
    dev = tpl.device
    M = MUTS_PER_POS * T
    m = torch.arange(M, device=dev)
    pos = (m // MUTS_PER_POS)[None, :, None]               # [1, M, 1]
    kind = (m % MUTS_PER_POS)[None, :, None]
    j = torch.arange(T, device=dev)[None, None, :]         # [1, 1, T]
    t = tpl.long()[:, None, :]                             # [B, 1, T]
    shape = (B, M, T)
    base_at = _gather_t(tpl.long(), pos.expand(B, M, 1))   # [B, M, 1]

    sub_tpl = torch.where((j == pos) & (kind <= 2), (base_at + 1 + kind) % 4,
                          t)
    # delete: shift left at pos; the tail is padding
    del_idx = (j + (j >= pos).long()).clamp(0, T - 1)
    del_tpl = _gather_t(tpl.long(), del_idx.expand(shape))
    del_tpl = torch.where(j == T - 1, -1, del_tpl)
    # insert after pos: the new base at pos+1, the suffix shifted right
    shifted = _gather_t(tpl.long(), (j - 1).clamp(0, T - 1).expand(shape))
    ins_tpl = torch.where(j <= pos, t,
                          torch.where(j == pos + 1, kind - 4, shifted))
    mut_tpl = torch.where(kind <= 2, sub_tpl,
                          torch.where(kind == 3, del_tpl, ins_tpl))

    tl = tlen.long()[:, None]                              # [B, 1]
    kind1 = kind[..., 0]
    mut_tlen = tl + torch.where(kind1 == 3, -1, (kind1 >= 4).long())
    mut_tpl = torch.where(j < mut_tlen[..., None], mut_tpl, -1)

    # 4 prepends: base b at index 0, everything shifted right
    bases = torch.arange(4, device=dev)[None, :, None]
    jp = j.expand(1, 4, T)
    pre = torch.where(jp == 0, bases,
                      _gather_t(tpl.long(), (jp - 1).clamp(0, T - 1)
                                .expand(B, 4, T)))
    pre_tlen = (tl + 1).expand(B, 4)
    pre = torch.where(jp < pre_tlen[..., None], pre, -1)
    return (torch.cat([mut_tpl, pre], dim=1).to(torch.int8),
            torch.cat([mut_tlen, pre_tlen], dim=1).to(torch.int32),
            mutation_valid(tlen, T))


def score_mutants(mut_tpl, mut_tlen, valid, snr_bin, reads, rlens, tables,
                  m_chunk: int = 32):
    """Summed-over-subreads LL of every mutant by a full forward of its
    template: [B, M], NEG where ``valid`` is False. Chunked over the
    mutation axis to bound the live [B, m_chunk, C, R+1] state."""
    B, M, T = mut_tpl.shape
    _, C, R = reads.shape
    outs = []
    for m0 in range(0, M, m_chunk):
        mt = mut_tpl[:, m0:m0 + m_chunk]
        mc = mt.shape[1]
        ll = forward_batch(
            mt.reshape(B * mc, T), mut_tlen[:, m0:m0 + mc].reshape(B * mc),
            snr_bin.repeat_interleave(mc),
            reads[:, None].expand(B, mc, C, R).reshape(B * mc, C, R),
            rlens[:, None].expand(B, mc, C).reshape(B * mc, C), tables)
        outs.append(_sum_lanes(ll).reshape(B, mc))
    return torch.where(valid, torch.cat(outs, dim=1), NEG)


def mutation_valid(tlen, T: int):
    """Validity mask of make_mutants' enumeration without building mutants:
    [B, 8T+4] bool."""
    dev = tlen.device
    m = torch.arange(MUTS_PER_POS * T, device=dev)
    pos, kind = (m // MUTS_PER_POS)[None, :], (m % MUTS_PER_POS)[None, :]
    tl = tlen.long()[:, None]
    valid = pos < tl
    valid = valid & ((kind != 3) | (tl > 1))
    valid = valid & ((kind < 4) | (tl < T))
    pre_valid = (tl < T).expand(tlen.shape[0], 4)
    return torch.cat([valid, pre_valid], dim=1)


def apply_mutation(tpl, tlen, core_start, core_end, mut_id, is_first=None):
    """Apply mutation ``mut_id`` (per row) to each template and update the
    core offsets so stitching stays exact. ``is_first`` marks the globally
    first window of each ZMW (a prepended base belongs to its core).
    Returns (tpl, tlen, core_start, core_end)."""
    B, T = tpl.shape
    dev = tpl.device
    if is_first is None:
        is_first = torch.zeros(B, dtype=torch.bool, device=dev)
    mut_id = mut_id.long()
    tlen, cs, ce = tlen.long(), core_start.long(), core_end.long()
    t = tpl.long()
    is_pre = mut_id >= MUTS_PER_POS * T
    reg_id = torch.where(is_pre, 0, mut_id)
    pos = reg_id // MUTS_PER_POS
    kind = reg_id % MUTS_PER_POS
    j = torch.arange(T, device=dev)[None, :]
    p, k = pos[:, None], kind[:, None]
    base_at = torch.gather(t, 1, p)
    sub_tpl = torch.where(j == p, (base_at + 1 + k) % 4, t)
    del_tpl = torch.gather(t, 1, (j + (j >= p).long()).clamp(0, T - 1))
    shifted = torch.gather(t, 1, (j - 1).clamp(0, T - 1).expand(B, T))
    ins_tpl = torch.where(j <= p, t, torch.where(j == p + 1, k - 4, shifted))
    out = torch.where(k <= 2, sub_tpl, torch.where(k == 3, del_tpl, ins_tpl))

    new_tlen = tlen + torch.where(kind == 3, -1, (kind >= 4).long())
    out = torch.where(j < new_tlen[:, None], out, -1)
    # core-offset bookkeeping: edit index = pos (sub/del) or pos+1 (ins).
    # An insertion landing exactly at core_start is pushed OUT (grows the
    # left margin), one landing exactly at core_end is kept IN: a base
    # inserted at the junction of two windows' cores is emitted by exactly
    # one of them (the left window).
    edit_idx = torch.where(kind >= 4, pos + 1, pos)
    zero = torch.zeros_like(pos)
    shift_start = torch.where(kind == 3, -(edit_idx < cs).long(),
                              torch.where(kind >= 4, (edit_idx <= cs).long(),
                                          zero))
    shift_end = torch.where(kind == 3, -(edit_idx < ce).long(),
                            torch.where(kind >= 4, (edit_idx <= ce).long(),
                                        zero))

    # prepend: base (mut_id - 8T) inserted before index 0
    pre_base = (mut_id - MUTS_PER_POS * T).clamp(0, 3)
    pre_tpl = torch.where(j == 0, pre_base[:, None], shifted)
    pre_tlen = tlen + 1
    pre_tpl = torch.where(j < pre_tlen[:, None], pre_tpl, -1)
    # the first window with core_start == 0 keeps the prepended base in-core
    pre_cs = torch.where(is_first & (cs == 0), cs, cs + 1)

    out = torch.where(is_pre[:, None], pre_tpl, out).to(torch.int8)
    new_tlen = torch.where(is_pre, pre_tlen, new_tlen)
    new_cs = torch.where(is_pre, pre_cs, cs + shift_start)
    new_ce = torch.where(is_pre, ce + 1, ce + shift_end)
    return (out, new_tlen.to(torch.int32), new_cs.to(torch.int32),
            new_ce.to(torch.int32))


def _qv_from_deltas(delta):
    """QV per template position from sub+del score deltas [B, T, 4]: p_err
    from the LL ratio of the best template against its mutated
    counterparts. Returns (qv, p_err)."""
    alt = torch.where(torch.isfinite(delta) & (delta > NEG / 2), delta, NEG)
    s = torch.exp(alt.clamp(max=30.0)).sum(-1)
    p_err = s / (1.0 + s)
    qv = -10.0 * torch.log10(p_err.clamp_min(1e-9))
    return qv.clamp(0.0, 93.0), p_err


class CandPolishState(NamedTuple):
    tpl: torch.Tensor         # [B, T] int8
    tlen: torch.Tensor        # [B] int32
    core_start: torch.Tensor  # [B] int32
    core_end: torch.Tensor    # [B] int32
    ll: torch.Tensor          # [B] f32
    active: torch.Tensor      # [B] bool
    n_iter: torch.Tensor      # [B] int32
    priority: torch.Tensor    # [B, T] f32 candidate priority (0 = skip)


def _sum_lanes(ll):
    """[B, C] -> [B], subreads summed in a fixed order."""
    acc = ll[:, 0]
    for c in range(1, ll.shape[1]):
        acc = acc + ll[:, c]
    return acc


def _polish_candidates(tpl, tlen, core_start, core_end, snr_bin, reads,
                       rlens, tables, priority, max_iters: int, m_chunk: int,
                       k_cand: int, is_first):
    """Candidate-filtered polish: each iteration scores, by column
    bridging, only the 8 mutations (+4 prepends) of the K highest-priority
    positions of each window. Tried positions drop to priority 0 unless
    they still carry an improving mutation; an accepted edit re-flags its
    +-2 neighbourhood (the only operators the edit changed), so every
    flagged candidate is eventually scored and convergence means no flagged
    mutation improves. QVs come from a final sub+del scan of every position
    of the converged template. Returns (state, qv, p_err)."""
    B, T = tpl.shape
    dev = tpl.device
    K = min(k_cand, T)
    ll0 = _sum_lanes(forward_batch(tpl, tlen, snr_bin, reads, rlens, tables))
    has_cov = (rlens >= 0).any(-1)
    j_t = torch.arange(T, device=dev)[None, :]
    if priority is None:
        priority = torch.ones((B, T), dtype=torch.float32, device=dev)
    priority = torch.where((j_t < tlen.long()[:, None]) & has_cov[:, None],
                           priority.to(torch.float32), 0.0)
    s = CandPolishState(tpl, tlen.to(torch.int32),
                        core_start.to(torch.int32), core_end.to(torch.int32),
                        ll0, has_cov & (priority > 0).any(-1),
                        torch.zeros(B, dtype=torch.int32, device=dev),
                        priority)
    kind8 = torch.arange(MUTS_PER_POS, device=dev).repeat(K)[None].expand(
        B, MUTS_PER_POS * K)
    n_reg = MUTS_PER_POS * K

    while _loop_on(s.active, s.n_iter, max_iters):
        columns = build_columns(s.tpl, s.tlen, snr_bin, reads, rlens, tables)
        # the K highest priorities, the lowest position first among equal
        # ones (lax.top_k's order)
        vals, idx = torch.sort(s.priority, dim=-1, descending=True,
                               stable=True)
        vals, idx = vals[:, :K], idx[:, :K]
        pos8 = idx.repeat_interleave(MUTS_PER_POS, dim=1)  # [B, 8K]
        reg = mutation_ops_at(s.tpl, s.tlen, snr_bin, tables, pos8, kind8)
        pre = prepend_ops(s.tpl, s.tlen, snr_bin, tables)
        ops = tuple(torch.cat([r, p], dim=1) for r, p in zip(reg, pre))
        lls = bridge_scores(reads, rlens, snr_bin, tables, columns, ops,
                            m_chunk=m_chunk)
        tl = s.tlen.long()[:, None]
        v = (pos8 < tl) & (vals.repeat_interleave(MUTS_PER_POS, dim=1) > 0)
        v = v & ((kind8 != 3) | (tl > 1))
        v = v & ((kind8 < 4) | (tl < T))
        v_pre = (tl < T).expand(B, 4)
        lls = torch.where(torch.cat([v, v_pre], dim=1), lls, NEG)

        best = lls.argmax(dim=-1)
        best_ll = torch.gather(lls, 1, best[:, None])[:, 0]
        improved = (best_ll > s.ll + 1e-3) & s.active
        reg_best = best.clamp(max=n_reg - 1)[:, None]
        sel_pos = torch.gather(pos8, 1, reg_best)[:, 0]
        sel_kind = torch.gather(kind8, 1, reg_best)[:, 0]
        is_pre = best >= n_reg
        mut_id = torch.where(is_pre, MUTS_PER_POS * T + (best - n_reg),
                             sel_pos * MUTS_PER_POS + sel_kind)
        new_tpl, new_tlen, cs, ce = apply_mutation(
            s.tpl, s.tlen, s.core_start, s.core_end, mut_id, is_first)

        # tried positions drop to 0, except those that still carry an
        # improving mutation (only the global best is applied per
        # iteration; runners-up must stay flagged or their improvements
        # are lost)
        pos_ll = lls[:, :n_reg].reshape(B, K, MUTS_PER_POS).amax(dim=-1)
        pos_imp = pos_ll > s.ll[:, None] + 1e-3
        pri = s.priority.scatter(1, idx, torch.where(pos_imp, vals, 0.0))
        # indel edits shift positions: remap priorities to new coordinates
        p = sel_pos[:, None]
        del_src = (j_t + (j_t >= p).long()).clamp(0, T - 1)
        ins_src = torch.where(j_t <= p, j_t, j_t - 1).clamp(0, T - 1)
        pre_src = (j_t - 1).clamp(0, T - 1)
        src = torch.where(is_pre[:, None], pre_src,
                          torch.where((sel_kind == 3)[:, None], del_src,
                                      torch.where((sel_kind >= 4)[:, None],
                                                  ins_src, j_t)))
        shifted = torch.gather(pri, 1, src)
        # re-flag the edited neighbourhood (its bridge operators changed)
        e = torch.where(is_pre, 0, torch.where(sel_kind >= 4, sel_pos + 1,
                                               sel_pos))[:, None]
        nb = (j_t >= e - 2) & (j_t <= e + 2)
        pri_new = torch.where(improved[:, None],
                              torch.where(nb, 1.0, shifted), pri)
        eff_tlen = torch.where(improved, new_tlen, s.tlen)
        pri_new = torch.where(j_t < eff_tlen.long()[:, None], pri_new, 0.0)

        sel = improved[:, None]
        s = CandPolishState(
            tpl=torch.where(sel, new_tpl, s.tpl),
            tlen=torch.where(improved, new_tlen, s.tlen),
            core_start=torch.where(improved, cs, s.core_start),
            core_end=torch.where(improved, ce, s.core_end),
            ll=torch.where(improved, best_ll, s.ll),
            active=(pri_new > 0).any(-1) & has_cov,
            n_iter=s.n_iter + s.active.to(torch.int32),
            priority=pri_new)

    # final QV scan: sub+del of every position of the final template
    columns = build_columns(s.tpl, s.tlen, snr_bin, reads, rlens, tables)
    posq = torch.arange(T, device=dev).repeat_interleave(4)[None].expand(
        B, 4 * T)
    kindq = torch.arange(4, device=dev).repeat(T)[None].expand(B, 4 * T)
    opsq = mutation_ops_at(s.tpl, s.tlen, snr_bin, tables, posq, kindq)
    llq = bridge_scores(reads, rlens, snr_bin, tables, columns, opsq,
                        m_chunk=m_chunk)
    tl = s.tlen.long()[:, None]
    vq = (posq < tl) & ((kindq != 3) | (tl > 1))
    delta = torch.where(vq, llq - s.ll[:, None], NEG).reshape(B, T, 4)
    qv, p_err = _qv_from_deltas(delta)
    return s, qv, p_err


def _loop_on(active, n_iter, max_iters: int) -> bool:
    """The loop condition: any row active and no row at max_iters (one
    device-to-host read)."""
    if active.numel() == 0:
        return False
    n_act, it = torch.stack([active.sum(), n_iter.amax().long()]).tolist()
    return n_act > 0 and it < max_iters


def polish_windows(tpl, tlen, core_start, core_end, snr_bin, reads, rlens,
                   tables, max_iters: int = 40, m_chunk: int = 32,
                   is_first=None, scoring: str = "cols",
                   heuristics: bool = False, k_cand: int = 12,
                   priority=None):
    """Iterate best-mutation steps until convergence (all windows in
    lock-step); returns (state, qv [B, T], p_err [B, T]).

    ``is_first``: bool [B], True for the globally first window of each ZMW.
    ``scoring``: "cols" scores mutants by column bridging (``ops.hmm_cols``);
    "dense" re-runs a full forward per mutant (the brute force).
    ``heuristics``: the candidate-filtered loop, only positions with
    positive ``priority`` [B, T] are polished (``_polish_candidates``)."""
    B, T = tpl.shape
    dev = tpl.device
    if is_first is None:
        is_first = torch.zeros(B, dtype=torch.bool, device=dev)
    if heuristics:
        return _polish_candidates(tpl, tlen, core_start, core_end, snr_bin,
                                  reads, rlens, tables, priority, max_iters,
                                  m_chunk, k_cand, is_first)
    if scoring not in ("cols", "dense"):
        raise ValueError(f"scoring must be 'cols' or 'dense', not {scoring!r}")
    ll0 = _sum_lanes(forward_batch(tpl, tlen, snr_bin, reads, rlens, tables))
    has_cov = (rlens >= 0).any(-1)
    M = MUTS_PER_POS * T + 4
    s = PolishState(tpl, tlen.to(torch.int32), core_start.to(torch.int32),
                    core_end.to(torch.int32), ll0, has_cov,
                    torch.zeros(B, dtype=torch.int32, device=dev),
                    torch.full((B, M), NEG, dtype=torch.float32, device=dev))

    while _loop_on(s.active, s.n_iter, max_iters):
        if scoring == "cols":
            columns = build_columns(s.tpl, s.tlen, snr_bin, reads, rlens,
                                    tables)
            lls = score_mutants_cols(s.tpl, s.tlen, snr_bin, reads, rlens,
                                     tables, columns,
                                     mutation_valid(s.tlen, T),
                                     m_chunk=m_chunk)
        else:
            mut_tpl, mut_tlen, valid = make_mutants(s.tpl, s.tlen)
            lls = score_mutants(mut_tpl, mut_tlen, valid, snr_bin, reads,
                                rlens, tables, m_chunk=m_chunk)
        best = lls.argmax(dim=-1)
        best_ll = torch.gather(lls, 1, best[:, None])[:, 0]
        improved = (best_ll > s.ll + 1e-3) & s.active
        new_tpl, new_tlen, cs, ce = apply_mutation(
            s.tpl, s.tlen, s.core_start, s.core_end, best, is_first)
        sel = improved[:, None]
        s = PolishState(
            tpl=torch.where(sel, new_tpl, s.tpl),
            tlen=torch.where(improved, new_tlen, s.tlen),
            core_start=torch.where(improved, cs, s.core_start),
            core_end=torch.where(improved, ce, s.core_end),
            ll=torch.where(improved, best_ll, s.ll),
            active=improved,
            n_iter=s.n_iter + s.active.to(torch.int32),
            # keep the scores of the template they were computed FOR: on
            # the final (non-improving) iteration they describe the final
            # template, which is what QV needs
            mut_lls=torch.where(sel, s.mut_lls, lls))

    # QV from the last-scored mutation set: 3 subs + deletion (kinds 0..3)
    delta = (s.mut_lls[:, :MUTS_PER_POS * T]
             - s.ll[:, None]).reshape(B, T, MUTS_PER_POS)
    qv, p_err = _qv_from_deltas(delta[..., :4])
    return s, qv, p_err


def absolute_layout(lls, tpl):
    """Round-1 scores [B, 8T+4] in the fused loop's absolute layout
    [B, 9T+4] (``pipeline.polish_fused``: m = 9p + k, k 0..3 base k at p,
    4 deletes p, 5..8 insert base k-5 after p, then the 4 prepends); the
    self-substitution slots are NEG."""
    B, T = tpl.shape
    dev = tpl.device
    p = torch.arange(T, device=dev).repeat_interleave(9)[None, :]
    k = torch.arange(9, device=dev).repeat(T)[None, :]
    cur = tpl.long().repeat_interleave(9, dim=1)
    rel = torch.where(k <= 3, (k - cur - 1) % 4, k - 1)   # kind 3: delete
    pre = MUTS_PER_POS * T + torch.arange(4, device=dev)
    src = torch.cat([MUTS_PER_POS * p + rel, pre[None, :].expand(B, 4)],
                    dim=1)
    out = torch.gather(lls, 1, src)
    is_self = torch.cat([(k <= 3) & (k == cur),
                         torch.zeros((B, 4), dtype=torch.bool, device=dev)],
                        dim=1)
    return torch.where(is_self, NEG, out)
