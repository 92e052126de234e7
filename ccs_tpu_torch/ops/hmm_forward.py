"""Batched Arrow pair-HMM forward log-likelihoods in plain PyTorch.

Counterpart of ``ccs_tpu.ops.hmm_jax``'s ``forward_batch`` (its scan
``_forward_batch_scan``) and ``snr_bin_for``; the rest of that module lives
in ``ops.tables``. This is the brute-force side of the checks: the round-1
polish loop (``pipeline.polish``) scores a mutant by a full forward of its
own template, so the scorers' bridged mutation scores are held against
forwards that share none of the bridging algebra.

The forward runs by template columns: column j holds, for every read
prefix i, the probability of having emitted read[:i] and standing at
template boundary j,

    col_j = SolveIns_{ie[j]}( dp[j-1] * col_{j-1} + me[j-1][r_i] * shift(col_{j-1}) )

with col_{-1} = e_0, no insertion past the template's end, and identity
steps (dp = 1, me = ie = 0) beyond each lane's tlen, so col_T carries the
end of every template. The insertion chain w[i] = y[i] + ie[r_i] * w[i-1]
is solved exactly (``hmm_cols._solve_fwd``), and so is the delete chain
(one dp factor a column); the JAX scan truncates deletion runs at depth 8,
a < 1e-7 relative difference. Each column is rescaled by its maximum, the
log of the scale accumulated. In float32 a column entry, and the end
probability, are floored at TINY relative to the column's maximum, as in the
JAX package; in float64 (tables passed as float64) at float64's smallest
normal number, so that a float64 forward gives the LL of a read far longer
than its template, which float32 clamps.

Shapes follow the JAX package:
  tpl [B,T] int8 (pad -1), tlen [B], snr_bin [B], reads [B,C,R] int8
  (base + 4*pw, pad -1), rlens [B,C] (< 0: absent lane)
  -> ll [B,C] f32 log P(read | tpl); exactly 0 for absent lanes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ccs_tpu_torch.ops.hmm_cols import _contract4, _oh_pw, _shift1, _solve_fwd
from ccs_tpu_torch.ops.tables import position_tables

TINY = 1e-30


def forward_batch(tpl, tlen, snr_bin, reads, rlens, tables) -> torch.Tensor:
    """log P(read | template) of every (window, subread) lane: [B, C] f32,
    on the device of ``tpl``."""
    B, T = tpl.shape
    _, C, R = reads.shape
    dev = tpl.device
    me, ie, dp = position_tables(tpl, snr_bin, tables)      # [B,T,4],[B,T]
    in_tpl = torch.arange(T, device=dev)[None, :] < tlen.long()[:, None]
    me = torch.where(in_tpl[..., None], me, 0.0)
    ie = torch.where(in_tpl[..., None], ie, 0.0)
    dp = torch.where(in_tpl, dp, 1.0)

    ohm, ohi = _oh_pw(reads, snr_bin, tables)              # [B,C,R,4]

    def emit(oh, vec4):
        """[B,4] -> [B,C,R+1]: entry i = f_i * vec4[base_i], 0 at i = 0."""
        return F.pad(_contract4(oh, vec4[:, None, None, :]), (1, 0))

    dt = ohm.dtype
    tiny = TINY if dt == torch.float32 else torch.finfo(dt).tiny
    col = torch.zeros((B, C, R + 1), dtype=dt, device=dev)
    col[..., 0] = 1.0
    ls = torch.zeros((B, C), dtype=dt, device=dev)
    zero = torch.zeros((B, C, R + 1), dtype=dt, device=dev)
    for j in range(T + 1):
        if j > 0:
            y = (dp[:, j - 1, None, None] * col
                 + emit(ohm, me[:, j - 1]) * _shift1(col))
        else:
            y = col
        col = _solve_fwd(y, emit(ohi, ie[:, j]) if j < T else zero)
        s = col.amax(dim=-1, keepdim=True).clamp_min(tiny)
        col = col / s
        ls = ls + torch.log(s[..., 0])
    rl = rlens.long()
    final = torch.gather(col, -1, rl.clamp(0, R)[..., None])[..., 0]
    ll = torch.log(final.clamp_min(tiny)) + ls
    return torch.where(rl < 0, 0.0, ll)


def snr_bin_for(snr_mean: torch.Tensor, tables: dict) -> torch.Tensor:
    """SNR binning on the device, matching ArrowParams.snr_bin."""
    return torch.searchsorted(tables["snr_edges"], snr_mean,
                              right=False).to(torch.int32)
