"""Fused exhaustive polish loop on PyTorch tensors.

Counterpart of ``ccs_tpu.pipeline.polish_fused`` (see its docstring for the
algorithm): every iteration scores all single-point mutations of every
window (or, in sparse mode, those at candidate positions), applies all
improving mutations that are >= 3 positions apart, and stops when no
mutation improves; the final scores give the per-base QVs.

Mutation enumeration (absolute base): m = 9*p + k for template position p
with k 0..3 substitute base k at p (k == tpl[p] is the invalid no-op),
k 4 delete p, k 5..8 insert base k-5 after p; plus 4 trailing prepends.
M = 9*T + 4.

The JAX ``lax.while_loop`` is a host loop here: its condition costs one
device-to-host read per iteration. Compaction is a real gather: each
iteration re-scores only the rows that changed, and the results are
bit-identical to the uncompacted loop because the scorer's per-row result
does not depend on the batch. The loop's two host waits on the device (the
condition's read and compaction's ``torch.nonzero``) are ``sync`` spans of
the caller's ``telemetry`` recorder. Updates are out of place unless a comment
says otherwise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ccs_tpu_torch import telemetry
from ccs_tpu_torch.ops.hmm_score import score_dense, score_sparse
from ccs_tpu_torch.ops.tables import load_clean_perr

NEG = -1e30
KINDS = 9  # 4 sub + 1 del + 4 ins per position


def mutation_valid_new(tpl, tlen):
    """Validity mask of the 9-kind enumeration: [B, 9T+4] bool."""
    B, T = tpl.shape
    dev = tpl.device
    p = torch.arange(T, device=dev).repeat_interleave(KINDS)[None, :]
    k = torch.arange(KINDS, device=dev).repeat(T)[None, :]
    cur = tpl.long().repeat_interleave(KINDS, dim=1)
    tl = tlen.long()[:, None]
    v = p < tl
    v = v & ((k > 3) | (k != cur))      # sub to self is a no-op
    v = v & ((k != 4) | (tl > 1))       # keep >= 1 base
    v = v & ((k < 5) | (tl < T))        # room to grow
    pre_v = (tlen < T)[:, None].expand(B, 4)
    return torch.cat([v, pre_v], dim=1)


def expand_cand(cand):
    """[B, T] candidate mask -> [B, 9T+4] mutation-slot mask (prepends are
    always scored)."""
    B = cand.shape[0]
    reg = cand.repeat_interleave(KINDS, dim=1)
    return torch.cat([reg, torch.ones((B, 4), dtype=cand.dtype,
                                      device=cand.device)], dim=1)


def _class_max(vals, is_start):
    """Max of ``vals`` [B, N, ...] over each run of consecutive slots along
    dim 1 (a run begins where ``is_start``), written back to every slot."""
    seg = torch.cumsum(is_start.long(), dim=1) - 1
    out = torch.full_like(vals, NEG).scatter_reduce(1, seg, vals, "amax")
    return torch.gather(out, 1, seg)


def equalize_equivalent(lls, tpl):
    """Give every valid member of a class of equivalent mutations the same
    score, the class maximum.

    Deleting any base of a homopolymer run yields one template, and so do
    inserting base x at any junction along a run of x (the prepend is the
    junction before position 0). In exact arithmetic such mutations score
    the same and selection takes the leftmost; computed scores differ in
    the last bits, by summation order, so the kernel and the plain version
    could pick different members and move a core boundary differently.
    Equal scores make the leftmost member win on every device."""
    B, T = tpl.shape
    dev = tpl.device
    t = tpl.long()
    reg = lls[:, :KINDS * T].reshape(B, T, KINDS)
    valid = reg > NEG / 2
    # deletions: runs of equal bases
    start = torch.ones((B, T), dtype=torch.bool, device=dev)
    start[:, 1:] = t[:, 1:] != t[:, :-1]          # in place on a fresh tensor
    dl = reg[..., 4]
    dl = torch.where(valid[..., 4], _class_max(dl, start), dl)
    # insertions of x: junction 0 is the prepend, junction 1+p follows p;
    # junction 1+p continues the class of junction p when tpl[p] == x
    junc = torch.cat([lls[:, KINDS * T:, None].transpose(1, 2),
                      reg[..., 5:]], dim=1)        # [B, T+1, 4]
    x = torch.arange(4, device=dev)[None, None, :]
    jstart = torch.cat([torch.ones((B, 1, 4), dtype=torch.bool, device=dev),
                        t[:, :, None] != x], dim=1)
    jvalid = junc > NEG / 2
    junc = torch.where(jvalid, _class_max(junc, jstart), junc)
    reg = torch.cat([reg[..., :4], dl[..., None], junc[:, 1:]], dim=-1)
    return torch.cat([reg.reshape(B, KINDS * T), junc[:, 0]], dim=1)


def score_all(tpl, tlen, snr_bin, reads, rlens, tables, cand=None):
    """Masked mutation scores (invalid slots NEG, equivalent mutations
    equalized) and ll0. ``cand`` [B, T] bool selects candidate-sparse
    scoring: only flagged positions carry scores; ll0 stays exact."""
    if cand is None:
        lls, ll0 = score_dense(tpl, tlen, snr_bin, reads, rlens, tables)
        valid = mutation_valid_new(tpl, tlen)
    else:
        lls, ll0 = score_sparse(tpl, tlen, snr_bin, reads, rlens, cand,
                                tables)
        valid = mutation_valid_new(tpl, tlen) & expand_cand(cand)
    return equalize_equivalent(torch.where(valid, lls, NEG), tpl), ll0


# ---------------------------------------------------------------------------
# selection: improving, spaced (>= 3 apart) mutation set per window
# ---------------------------------------------------------------------------

def _shift_val(x, off, fill):
    """x[..., j+off] with fill outside; off may be negative."""
    if off > 0:
        pad = torch.full_like(x[..., :off], fill)
        return torch.cat([x[..., off:], pad], dim=-1)
    if off < 0:
        pad = torch.full_like(x[..., :(-off)], fill)
        return torch.cat([pad, x[..., :off]], dim=-1)
    return x


def select_mutations(lls, ll, priority, T: int, thresh: float = 1e-3):
    """Pick the improving mutation set to apply this iteration: per
    position the best of its 9 kinds, then a local-argmax filter of radius
    2 (leftmost wins ties). Returns (sel [B,T] bool, pkind [B,T], pre_sel
    [B], pre_base [B], pbest [B,T])."""
    B = lls.shape[0]
    reg = lls[:, :KINDS * T].reshape(B, T, KINDS)
    delta = reg - ll[:, None, None]
    pbest = delta.amax(dim=-1)
    pkind = delta.argmax(dim=-1).to(torch.int32)      # first maximum
    imp = pbest > thresh
    if priority is not None:
        imp = imp & (priority > 0.0)
    val = torch.where(imp, pbest, NEG)
    sel = imp
    for off in (1, 2):
        sel = sel & (val > _shift_val(val, -off, NEG))   # strictly beat left
        sel = sel & (val >= _shift_val(val, off, NEG))   # ties: left wins
    pre_delta = lls[:, KINDS * T:] - ll[:, None]          # [B, 4]
    pre_best = pre_delta.amax(dim=-1)
    pre_base = pre_delta.argmax(dim=-1).to(torch.int32)
    head = val[:, :3].amax(dim=-1)
    pre_sel = (pre_best > thresh) & (pre_best >= head)
    sel = torch.cat([sel[:, :3] & ~pre_sel[:, None], sel[:, 3:]], dim=1)
    return sel, pkind, pre_sel, pre_base, pbest


# ---------------------------------------------------------------------------
# apply: build the multi-edited template with core-offset bookkeeping
# ---------------------------------------------------------------------------

def apply_mutations(tpl, tlen, cs, ce, priority, sel, pkind, pre_sel,
                    pre_base, is_first, single=None):
    """Apply the selected spaced mutation set to each window; see the JAX
    counterpart for the single-edit fallback, the core-offset junction
    convention and the priority remap. Returns (tpl, tlen, cs, ce,
    priority, improved)."""
    B, T = tpl.shape
    dev = tpl.device
    j = torch.arange(T, device=dev)[None, :]
    tlen = tlen.long()
    in_tpl = j < tlen[:, None]
    pkind = pkind.long()

    op_ins = sel & (pkind >= 5)
    op_del = sel & (pkind == 4)
    n_new = tlen + op_ins.sum(-1) - op_del.sum(-1) + pre_sel.long()
    ovf = n_new > T
    if single is not None:
        ovf = ovf | single
    # first selected position (argmax of a 0/1 row returns the first 1)
    first_sel = sel.to(torch.uint8).argmax(dim=-1)
    sel_single = sel & (j == first_sel[:, None]) & sel.any(-1, keepdim=True)
    sel = torch.where(ovf[:, None], sel_single & ~pre_sel[:, None], sel)
    pre_applied = pre_sel      # prepend alone never overflows (tlen < T)
    op_sub = sel & (pkind <= 3)
    op_del = sel & (pkind == 4)
    op_ins = sel & (pkind >= 5)

    base1 = torch.where(op_sub, pkind, tpl.long())
    emit1 = in_tpl & ~op_del
    emit2 = in_tpl & op_ins
    ec = emit1.long() + emit2.long()
    start = pre_applied.long()[:, None] + torch.cumsum(ec, -1) - ec
    newlen = pre_applied.long() + ec.sum(-1)

    pos1 = torch.where(emit1, start, -1)
    pos2 = torch.where(emit2, start + 1, -1)
    tgt = torch.arange(T, device=dev)[None, None, :]
    oh1 = pos1[:, :, None] == tgt                        # [B, T, T]
    oh2 = pos2[:, :, None] == tgt
    val1 = (base1[:, :, None] * oh1).sum(1)
    val2 = ((pkind - 5)[:, :, None] * oh2).sum(1)
    cov1 = oh1.any(1)
    cov2 = oh2.any(1)
    out = torch.where(cov1, val1, torch.where(cov2, val2, -1))
    out = torch.where(pre_applied[:, None] & (j == 0),
                      pre_base.long()[:, None], out)
    out = torch.where(j < newlen[:, None], out, -1).to(torch.int8)

    # core offsets (deltas in ORIGINAL coordinates, then summed)
    csn = cs.long()[:, None]
    cen = ce.long()[:, None]
    d_cs = ((op_ins & (j + 1 <= csn)).sum(-1)
            - (op_del & (j < csn)).sum(-1)
            + (pre_applied & ~(is_first & (cs == 0))).long())
    d_ce = ((op_ins & (j + 1 <= cen)).sum(-1)
            - (op_del & (j < cen)).sum(-1)
            + pre_applied.long())
    ncs = (cs.long() + d_cs).to(torch.int32)
    nce = (ce.long() + d_ce).to(torch.int32)

    if priority is not None:
        nbh = sel
        for off in (1, 2):
            nbh = nbh | _shift_val(sel, off, False) | _shift_val(sel, -off,
                                                                 False)
        nbh = nbh | (pre_applied[:, None] & (j <= 2))
        pri = torch.maximum(priority, nbh.to(priority.dtype))
        npri = (torch.where(emit1, pri, 0.0)[:, :, None] * oh1).sum(1) \
            + oh2.any(1).to(torch.float32)
        npri = torch.where(pre_applied[:, None] & (j == 0), 1.0, npri)
        npri = torch.where(j < newlen[:, None], npri, 0.0)
    else:
        npri = None
    return (out, newlen.to(torch.int32), ncs, nce, npri,
            sel.any(-1) | pre_applied)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

class FusedPolishState(NamedTuple):
    tpl: torch.Tensor         # [B, T] int8
    tlen: torch.Tensor        # [B] int32
    core_start: torch.Tensor  # [B] int32
    core_end: torch.Tensor    # [B] int32
    ll: torch.Tensor          # [B] f32 exact LL of tpl (from the scorer)
    lls: torch.Tensor         # [B, M] mutation scores OF tpl
    active: torch.Tensor      # [B] bool
    n_iter: torch.Tensor      # [B] int32
    priority: torch.Tensor    # [B, T] f32 candidate mask


def _qv_from_lls(lls, ll, tpl, tlen):
    """QV per template position from the final mutation scores: error mass
    of every DISTINCT counterpart template touching the position (deletes
    of a homopolymer run count once, at its last base; an insertion counts
    only where the inserted base differs from the next template base).
    Returns (qv [B,T], p_err [B,T])."""
    B, T = tpl.shape
    dev = tpl.device
    reg = lls[:, :KINDS * T].reshape(B, T, KINDS)
    sub_del = reg[..., :5]
    k = torch.arange(5, device=dev)[None, None, :]
    tpl_l = tpl.long()
    is_self = k == tpl_l.clamp(0, 3)[..., None]
    nxt = torch.cat([tpl_l[:, 1:], torch.full((B, 1), -1, dtype=torch.long,
                                              device=dev)], dim=1)
    j = torch.arange(T, device=dev)[None, :]
    tl = tlen.long()[:, None]
    in_tpl = j < tl
    run_last = (nxt != tpl_l) | (j + 1 >= tl)
    dup_del = (k == 4) & ~run_last[..., None]
    delta = torch.where(is_self | dup_del, NEG, sub_del - ll[:, None, None])
    alt = torch.where(delta > NEG / 2, delta, NEG)
    s = torch.exp(torch.clamp(alt, max=30.0)).sum(-1)
    ins = reg[..., 5:] - ll[:, None, None]
    b = torch.arange(4, device=dev)[None, None, :]
    dup_ins = (b == nxt[..., None]) & (j + 1 < tl)[..., None]
    ins = torch.where(dup_ins | ~in_tpl[..., None], NEG, ins)
    s = s + torch.where(ins > NEG / 2, torch.exp(torch.clamp(ins, max=30.0)),
                        0.0).sum(-1)
    p_err = s / (1.0 + s)
    qv = -10.0 * torch.log10(torch.clamp(p_err, min=1e-9))
    return torch.clamp(qv, 0.0, 93.0), p_err


def clean_perr(tables, cov, snr_bin):
    """Calibrated error probability of a clean (non-candidate) position,
    keyed by (snr bin, coverage); see the JAX counterpart."""
    tab = tables.get("clean_perr")
    if tab is None:
        tab = torch.as_tensor(load_clean_perr(), device=cov.device)
    c = cov.long().clamp(0, tab.shape[1] - 1)
    s = snr_bin.long().clamp(0, tab.shape[0] - 1)
    return tab[s, c]


def polish_windows_fused(tpl, tlen, core_start, core_end, snr_bin, reads,
                         rlens, tables, max_iters: int = 40, is_first=None,
                         priority=None, thresh: float = 0.02,
                         careful_after: int = 6, compact: bool = False,
                         sparse: bool = False, rec=None):
    """Exhaustive multi-apply polish until no mutation improves.

    Returns (state, qv [B,T], p_err [B,T]). ``priority`` (candidate mask)
    acts as a selection mask; None = exhaustive. ``sparse`` scores only
    the candidate positions. ``compact`` re-scores only the rows that
    changed in each iteration (the counterpart of the JAX loop's in-jit
    tail compaction); results are bit-identical either way. After
    ``careful_after`` iterations a window applies one edit at a time.
    ``rec``: the ``telemetry.Recorder`` of the ``sync`` spans, or None.
    """
    B, T = tpl.shape
    dev = tpl.device
    if is_first is None:
        is_first = torch.zeros(B, dtype=torch.bool, device=dev)
    tlen = tlen.to(torch.int32)
    j = torch.arange(T, device=dev)[None, :]
    if priority is None:
        priority = torch.ones((B, T), dtype=torch.float32, device=dev)
    priority = torch.where(j < tlen[:, None], priority.to(torch.float32), 0.0)

    def score(t, tl, pri, sb, rd, rl):
        return score_all(t, tl, sb, rd, rl, tables,
                         cand=(pri > 0.0) if sparse else None)

    def body(s):
        sel, pkind, pre_sel, pre_base, _ = select_mutations(
            s.lls, s.ll, s.priority, T, thresh=thresh)
        sel = sel & s.active[:, None]
        pre_sel = pre_sel & s.active
        ntpl, nlen, ncs, nce, npri, improved = apply_mutations(
            s.tpl, s.tlen, s.core_start, s.core_end, s.priority, sel, pkind,
            pre_sel, pre_base, is_first, single=s.n_iter >= careful_after)
        m = improved[:, None]
        tpl2 = torch.where(m, ntpl, s.tpl)
        tlen2 = torch.where(improved, nlen, s.tlen)
        pri2 = torch.where(m, npri, s.priority)
        if not compact:
            lls2, ll2 = score(tpl2, tlen2, pri2, snr_bin, reads, rlens)
        else:
            # score only the rows that changed; rows not re-scored keep the
            # scores of their unchanged template (in-place writes into
            # fresh copies)
            with telemetry.span(rec, "sync"):
                rows = torch.nonzero(improved).squeeze(1)
            lls2, ll2 = s.lls.clone(), s.ll.clone()
            if rows.numel():
                lls_g, ll_g = score(tpl2[rows], tlen2[rows], pri2[rows],
                                    snr_bin[rows], reads[rows], rlens[rows])
                lls2[rows] = lls_g
                ll2[rows] = ll_g
        return FusedPolishState(
            tpl=tpl2, tlen=tlen2,
            core_start=torch.where(improved, ncs, s.core_start),
            core_end=torch.where(improved, nce, s.core_end),
            ll=ll2, lls=lls2, active=improved,
            n_iter=s.n_iter + s.active.to(torch.int32),
            priority=pri2)

    lls0, ll0 = score(tpl, tlen, priority, snr_bin, reads, rlens)
    has_cov = (rlens >= 0).any(-1)
    # a row enters the loop only if its initial scores hold an improving
    # mutation it would select
    sel0, _pk, pre0, _pb, _ = select_mutations(lls0, ll0, priority, T,
                                               thresh=thresh)
    state = FusedPolishState(
        tpl=tpl, tlen=tlen, core_start=core_start.to(torch.int32),
        core_end=core_end.to(torch.int32), ll=ll0, lls=lls0,
        active=has_cov & (sel0.any(-1) | pre0),
        n_iter=torch.zeros(B, dtype=torch.int32, device=dev),
        priority=priority)

    while True:
        # the loop condition: one device -> host read per iteration
        if B == 0:
            break
        flags = torch.stack([
            state.active.sum(),
            torch.where(state.active, state.n_iter, 0).amax().long(),
        ])
        with telemetry.span(rec, "sync"):
            n_act, it = flags.tolist()
        if not (n_act > 0 and it < max_iters):
            break
        state = body(state)

    qv, p_err = _qv_from_lls(state.lls, state.ll, state.tpl, state.tlen)
    if sparse:
        # clean (non-candidate) positions carry no mutation scores; their
        # p_err comes from the calibrated table
        cov = (rlens >= 0).sum(-1)
        pc = clean_perr(tables, cov, snr_bin)                  # [B]
        ncm = (state.priority <= 0.0) & (j < state.tlen[:, None])
        p_err = torch.where(ncm, pc[:, None], p_err)
        qv_c = torch.clamp(-10.0 * torch.log10(torch.clamp(pc, min=1e-9)),
                           0.0, 93.0)
        qv = torch.where(ncm, qv_c[:, None], qv)
    return state, qv, p_err
