"""Column-form pair-HMM in plain PyTorch: forward/backward columns and
O(R) mutation scoring by column bridging.

Counterpart of ``ccs_tpu.ops.hmm_cols`` (see its docstring for the
algebra). This is the port's CPU path and the oracle the CUDA scorer
(``csrc/hmm_score.cu``) is held against.

Every reduction here runs in a fixed order that does not depend on the
batch size — 4-term emission sums and the sum over subreads are written
out term by term — so a row scores to the same bits alone or inside any
batch. The polish loop's compaction relies on that.

Shapes follow the JAX package:
  tpl [B,T] int8, tlen [B], snr_bin [B], reads [B,C,R] int8 (base + 4*pw),
  rlens [B,C] (-1 = absent subread).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ccs_tpu_torch.ops.tables import position_tables

TINY = 1e-30
NEG = -1e30


class HmmColumns(NamedTuple):
    cols: torch.Tensor     # [B, C, T+2, R+1]  cols[k] = col_{k-1}; [0] = e_0
    ls_col: torch.Tensor   # [B, C, T+2]       log-scale of each column
    betas: torch.Tensor    # [B, C, T+1, R+1]  u_j (pre-solve), j = 0..T
    ls_beta: torch.Tensor  # [B, C, T+1]
    ll: torch.Tensor       # [B, C]            log P(read | template); 0 if absent


def _oh_pw(reads, snr_bin, tables):
    """Pulse-width-scaled one-hot planes of the read base: (ohm, ohi)
    [B,C,R,4] for Match and Branch/Stick emissions; pads are all-zero."""
    r = reads.long()
    c = r.clamp(0, 15)
    oh = F.one_hot(c % 4, 4).to(torch.float32) * (r >= 0)[..., None]
    w = c // 4
    sb = snr_bin.long()[:, None, None]
    fm = tables["pw_match"][sb, w]
    fi = tables["pw_ins"][sb, w]
    return oh * fm[..., None], oh * fi[..., None]


def _contract4(oh, vec4):
    """sum_x oh[..., x] * vec4[..., x], term by term. oh [B,C,R,4];
    vec4 broadcastable to [B,C,R,4] after unsqueezing."""
    return (oh[..., 0] * vec4[..., 0] + oh[..., 1] * vec4[..., 1]
            + oh[..., 2] * vec4[..., 2] + oh[..., 3] * vec4[..., 3])


def _solve_fwd(y, a):
    """Exact prefix recurrence w[i] = y[i] + a[i]*w[i-1] along the last
    axis, by doubling."""
    n = y.shape[-1]
    x, c = y, a
    d = 1
    while d < n:
        x = x + c * F.pad(x[..., :-d], (d, 0))
        c = c * F.pad(c[..., :-d], (d, 0))
        d *= 2
    return x


def _solve_bwd(y, a):
    """Exact suffix recurrence w[i] = y[i] + a[i]*w[i+1] along the last axis."""
    n = y.shape[-1]
    x, c = y, a
    d = 1
    while d < n:
        x = x + c * F.pad(x[..., d:], (0, d))
        c = c * F.pad(c[..., d:], (0, d))
        d *= 2
    return x


def _shift1(v):
    return F.pad(v[..., :-1], (1, 0))


def _padded_tables(tpl, tlen, snr_bin, tables):
    """position_tables with identity padding beyond tlen (dp=1, me=ie=0)."""
    me, ie, dp = position_tables(tpl, snr_bin, tables)
    T = tpl.shape[-1]
    in_tpl = torch.arange(T, device=tpl.device)[None, :] < tlen[:, None]
    dp = torch.where(in_tpl, dp, 1.0)
    ie = torch.where(in_tpl[..., None], ie, 0.0)
    me = torch.where(in_tpl[..., None], me, 0.0)
    return me, ie, dp


def build_columns(tpl, tlen, snr_bin, reads, rlens, tables) -> HmmColumns:
    """Forward + backward column matrices and the total log-likelihood."""
    B, T = tpl.shape
    _, C, R = reads.shape
    me, ie, dp = _padded_tables(tpl, tlen, snr_bin, tables)
    ohm, ohi = _oh_pw(reads, snr_bin, tables)              # [B,C,R,4]
    rl = rlens.long()
    dev = tpl.device

    def emit_r(ohx, vec4):
        """[B,4] -> [B,C,R+1] with entry i = f_i * vec4[base_i], 0 at i=0."""
        return F.pad(_contract4(ohx, vec4[:, None, None, :]), (1, 0))

    e0 = torch.zeros((B, C, R + 1), dtype=torch.float32, device=dev)
    e0[..., 0] = 1.0
    zero_b = torch.zeros((B, C), dtype=torch.float32, device=dev)
    one4 = torch.ones(B, dtype=torch.float32, device=dev)
    zero4 = torch.zeros((B, 4), dtype=torch.float32, device=dev)

    # ---- forward: col_j for j = 0..T ----
    col, ls = e0, zero_b
    cols, lss = [e0], [zero_b]
    for j in range(T + 1):
        dpj = dp[:, j - 1] if j > 0 else one4
        me4 = me[:, j - 1] if j > 0 else zero4
        ie4 = ie[:, j] if j < T else zero4
        y = dpj[:, None, None] * col + emit_r(ohm, me4) * _shift1(col)
        new = _solve_fwd(y, emit_r(ohi, ie4))
        s = new.amax(dim=-1, keepdim=True).clamp_min(TINY)
        col = new / s
        ls = ls + torch.log(s[..., 0])
        cols.append(col)
        lss.append(ls)
    cols_t = torch.stack(cols, dim=2)                      # [B,C,T+2,R+1]
    ls_col = torch.stack(lss, dim=2)                       # [B,C,T+2]

    # total LL: col_T[rl] (identity padding => boundary T carries the end)
    idx = rl.clamp(0, R)
    final = torch.gather(col, -1, idx[..., None])[..., 0]
    ll = torch.log(final.clamp_min(TINY)) + ls
    ll = torch.where(rl < 0, 0.0, ll)

    # ---- backward: u_j (pre-insertion-solve sensitivities), j = T..0 ----
    # u_j pairs with a post-solve forward column: LL = sum_i col_j[i] u_j[i]
    # (pairing with the full beta_j would double-count paths that revisit
    # column j through its insertion chain).
    i_idx = torch.arange(R + 1, device=dev)[None, None, :]
    betaT = (i_idx == idx[..., None]).to(torch.float32)
    beta, ls = betaT, zero_b
    us = [None] * T
    lsu = [None] * T
    for j in range(T - 1, -1, -1):
        # backward uses the emission of read base i+1: shift left
        me_rs = F.pad(_contract4(ohm, me[:, j][:, None, None, :]), (0, 1))
        ie_rs = F.pad(_contract4(ohi, ie[:, j][:, None, None, :]), (0, 1))
        up = F.pad(beta[..., 1:], (0, 1))
        u = dp[:, j][:, None, None] * beta + me_rs * up
        su = u.amax(dim=-1, keepdim=True).clamp_min(TINY)
        us[j] = u / su
        lsu[j] = ls + torch.log(su[..., 0])
        new = _solve_bwd(u, ie_rs)
        s = new.amax(dim=-1, keepdim=True).clamp_min(TINY)
        beta = new / s
        ls = ls + torch.log(s[..., 0])
    betas = torch.stack(us + [betaT], dim=2)               # [B,C,T+1,R+1]
    ls_beta = torch.stack(lsu + [zero_b], dim=2)
    return HmmColumns(cols=cols_t, ls_col=ls_col, betas=betas,
                      ls_beta=ls_beta, ll=ll)


def _ctx_params(prev, cur, snr_bin, tables):
    """Arrow params for arbitrary (prev, cur) base pairs: (me4 [...,4],
    ie4 [...,4], dp [...]); mirrors position_tables."""
    cur_c = cur.clamp(0, 3)
    ctx = 4 * prev.clamp(0, 3) + cur_c
    trans = tables["trans"][snr_bin, ctx]                  # [..., 4]
    em = tables["emit_match"][snr_bin, ctx]
    es = tables["emit_stick"][snr_bin, ctx]
    onehot = F.one_hot(cur_c, 4).to(trans.dtype)
    me4 = trans[..., 0:1] * em
    ie4 = trans[..., 1:2] * onehot + trans[..., 2:3] * es
    return me4, ie4, trans[..., 3]


def mutation_ops_at(tpl, tlen, snr_bin, tables, posb, kindb):
    """Bridge operators for an arbitrary mutation set (position, kind).

    posb/kindb: int [B, P] — template position and RELATIVE kind (0-2
    substitution to (tpl[pos]+1+kind)%4, 3 deletion, 4-7 insert base
    kind-4 after pos). Returns (me4 [B,P,3,4], ie4 [B,P,3,4], dp [B,P,3],
    start [B,P], qidx [B,P]): the three operators map col_{start-1} (cols
    index ``start``) to the boundary scored against u_{qidx}.
    """
    B, T = tpl.shape
    me_o, ie_o, dp_o = _padded_tables(tpl, tlen, snr_bin, tables)
    tpl_l = tpl.long()
    kind = kindb.long()
    posb = posb.long()
    P_ = posb.shape[1]
    bi = torch.arange(B, device=tpl.device)[:, None]
    tl = tlen.long()[:, None]
    sb = snr_bin.long()[:, None]

    def t_at(i):
        return torch.gather(tpl_l, 1, i.clamp(0, T - 1))

    t_p = t_at(posb)
    t_prev = torch.where(posb > 0, t_at(posb - 1), -1)     # -1: use cur
    t_next = t_at(posb + 1)
    has_next = (posb + 1) < tl

    is_sub = kind <= 2
    is_del = kind == 3
    is_ins = kind >= 4
    x = torch.where(is_sub, (t_p + 1 + kind) % 4, kind - 4)

    zero4 = torch.zeros((B, P_, 4), dtype=torch.float32, device=tpl.device)

    def P(prev, cur):
        prev = torch.where(prev < 0, cur, prev)
        return _ctx_params(prev, cur, sb, tables)

    def orig_me_dp(p):
        ok = (p >= 0) & (p < tl)
        pc = p.clamp(0, T - 1)
        me = torch.where(ok[..., None], me_o[bi, pc], 0.0)
        dp = torch.where(ok, dp_o[bi, pc], 1.0)
        return me, dp

    def orig_ie(p):
        ok = (p >= 0) & (p < tl)
        pc = p.clamp(0, T - 1)
        return torch.where(ok[..., None], ie_o[bi, pc], 0.0)

    # substitution (base at pos becomes x)
    me_px, ie_px, dp_px = P(t_prev, x)                     # new pos p
    me_xn, ie_xn, dp_xn = P(x, t_next)                     # new pos p+1
    hn4 = has_next[..., None]
    me_pm1, dp_pm1 = orig_me_dp(posb - 1)
    sub_ops = (
        (me_pm1, ie_px, dp_pm1),
        (me_px, torch.where(hn4, ie_xn, 0.0), dp_px),
        (torch.where(hn4, me_xn, 0.0), orig_ie(posb + 2),
         torch.where(has_next, dp_xn, 1.0)),
    )
    # deletion (pos removed; new pos p = old p+1 with new prev)
    me_dn, ie_dn, dp_dn = P(t_prev, t_next)
    del_ops = (
        (me_pm1, torch.where(hn4, ie_dn, 0.0), dp_pm1),
        (torch.where(hn4, me_dn, 0.0), orig_ie(posb + 2),
         torch.where(has_next, dp_dn, 1.0)),
        (zero4, zero4, torch.ones_like(dp_pm1)),
    )
    # insertion of x between pos and pos+1
    me_tx, ie_tx, dp_tx = P(t_p, x)
    me_p, dp_p = orig_me_dp(posb)
    ins_ops = (
        (me_p, ie_tx, dp_p),
        (me_tx, torch.where(hn4, ie_xn, 0.0), dp_tx),
        (torch.where(hn4, me_xn, 0.0), orig_ie(posb + 2),
         torch.where(has_next, dp_xn, 1.0)),
    )

    def pick(o):
        su, de, im = sub_ops[o], del_ops[o], ins_ops[o]
        s4, d4 = is_sub[..., None], is_del[..., None]
        me4 = torch.where(s4, su[0], torch.where(d4, de[0], im[0]))
        ie4 = torch.where(s4, su[1], torch.where(d4, de[1], im[1]))
        dp = torch.where(is_sub, su[2], torch.where(is_del, de[2], im[2]))
        return me4, ie4, dp

    ops = [pick(o) for o in range(3)]
    start = torch.where(is_ins, posb + 1, posb)
    qidx = torch.minimum(posb + 2, tl)
    me4 = torch.stack([o[0] for o in ops], dim=2)          # [B,P,3,4]
    ie4 = torch.stack([o[1] for o in ops], dim=2)
    dp4 = torch.stack([o[2] for o in ops], dim=2)          # [B,P,3]
    return me4, ie4, dp4, start, qidx


def prepend_ops(tpl, tlen, snr_bin, tables):
    """Bridge operators for the 4 prepend mutations (base x before index 0):
    (me4 [B,4,3,4], ie4 [B,4,3,4], dp [B,4,3], start [B,4], qidx [B,4])."""
    B, T = tpl.shape
    dev = tpl.device
    _me_o, ie_o, _dp_o = _padded_tables(tpl, tlen, snr_bin, tables)
    x0 = torch.arange(4, device=dev)[None, :].expand(B, 4)
    sb4 = snr_bin.long()[:, None]
    t0 = tpl[:, 0].long()[:, None].expand(B, 4)
    me_xx, ie_xx, dp_xx = _ctx_params(x0, x0, sb4, tables)
    me_x0, ie_x0, dp_x0 = _ctx_params(x0, t0, sb4, tables)
    ie_1 = torch.where((tlen > 1)[:, None], ie_o[:, min(1, T - 1)], 0.0)
    one4 = torch.ones((B, 4), dtype=torch.float32, device=dev)
    z44 = torch.zeros((B, 4, 4), dtype=torch.float32, device=dev)
    pre_ops = [
        (z44, ie_xx, one4),
        (me_xx, ie_x0, dp_xx),
        (me_x0, ie_1[:, None, :].expand(B, 4, 4), dp_x0),
    ]
    start = torch.zeros((B, 4), dtype=torch.long, device=dev)
    qidx = torch.minimum(torch.ones((B, 4), dtype=torch.long, device=dev),
                         tlen.long()[:, None])
    me4 = torch.stack([o[0] for o in pre_ops], dim=2)
    ie4 = torch.stack([o[1] for o in pre_ops], dim=2)
    dp4 = torch.stack([o[2] for o in pre_ops], dim=2)
    return me4, ie4, dp4, start, qidx


def bridge_scores(reads, rlens, snr_bin, tables, columns: HmmColumns, ops,
                  m_chunk: int = 28):
    """Summed-over-subreads LL of each mutation in ``ops`` by column
    bridging: [B, M]. Mutations are processed ``m_chunk`` at a time to
    bound the [B, C, m_chunk, R+1] intermediates."""
    me4, ie4, dp4, start, qidx = ops
    B, M = start.shape
    _, C, R = reads.shape
    ohm, ohi = _oh_pw(reads, snr_bin, tables)              # [B,C,R,4]
    ohm_m = ohm[:, :, None]                                # [B,C,1,R,4]
    ohi_m = ohi[:, :, None]
    live = (rlens >= 0)[:, :, None]
    outs = []
    for m0 in range(0, M, m_chunk):
        sl = slice(m0, min(M, m0 + m_chunk))
        s_c, q_c = start[:, sl], qidx[:, sl]
        mc = s_c.shape[1]
        sidx = s_c[:, None, :, None].expand(B, C, mc, R + 1)
        v = torch.gather(columns.cols, 2, sidx)            # [B,C,mc,R+1]
        ls_v = torch.gather(columns.ls_col, 2, s_c[:, None].expand(B, C, mc))
        for o in range(3):
            me_r = F.pad(_contract4(ohm_m, me4[:, None, sl, o, None, :]),
                         (1, 0))                           # [B,C,mc,R+1]
            ie_r = F.pad(_contract4(ohi_m, ie4[:, None, sl, o, None, :]),
                         (1, 0))
            y = dp4[:, None, sl, o, None] * v + me_r * _shift1(v)
            v = _solve_fwd(y, ie_r)
        qix = q_c[:, None, :, None].expand(B, C, mc, R + 1)
        beta = torch.gather(columns.betas, 2, qix)
        ls_b = torch.gather(columns.ls_beta, 2, q_c[:, None].expand(B, C, mc))
        dot = (v * beta).sum(dim=-1)
        ll = torch.log(dot.clamp_min(TINY)) + ls_v + ls_b  # [B,C,mc]
        ll = torch.where(live, ll, 0.0)
        acc = ll[:, 0]
        for c in range(1, C):                              # fixed order
            acc = acc + ll[:, c]
        outs.append(acc)
    return torch.cat(outs, dim=1)
