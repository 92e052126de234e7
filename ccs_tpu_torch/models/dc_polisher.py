"""DeepConsensus-style learned window polisher on PyTorch tensors.

Counterpart of ``ccs_tpu.models.dc_polisher`` (see its docstring for the
design and what the model earns): low-quality windows of the Arrow polish
are processed by a per-position MLP over the scorer's own features; its
confident corrections are applied and re-scored by Arrow, and ``rq``
averages the model's calibrated QVs on processed windows
(revio.md:29-53). The shipped ``data/dc_v0.npz`` is the JAX package's file,
byte for byte; ``DcModel`` reads and writes the same ``.npz`` format, so a
model either package writes loads in the other.

The weights live in a ``DcNet`` (a ``torch.nn.Module`` whose parameters
carry the names of ``DcModel``'s fields) on an explicit device; the model's
matrix products run in float32 (TF32 stays off, torch's default). Entry
points take tensors on any device; training runs on the device its caller
names (CUDA unless asked otherwise).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ccs_tpu_torch import telemetry
from ccs_tpu_torch.ops.align import guided_align
from ccs_tpu_torch.ops.tables import params_to_torch
from ccs_tpu_torch.pipeline.draft import _pileup_consensus
from ccs_tpu_torch.pipeline.polish_fused import (_qv_from_lls, _shift_val,
                                                 apply_mutations,
                                                 polish_windows_fused,
                                                 score_all)
from ccs_tpu_torch.sim.simulator import simulate_read

N_CLASSES = 10  # keep, sub A/C/G/T, delete, insert A/C/G/T after
KINDS = 9
ERR_UPWEIGHT = 12.0  # class-imbalance weight on error positions in the
                     # training loss; inference de-biases the error head by
                     # dividing the odds back out (sigmoid(logit - log(w)))
WEIGHTS = ("w1", "b1", "w2", "b2", "w_cls", "b_cls", "w_err", "b_err")


@dataclasses.dataclass
class DcModel:
    """Weights of the window-refinement MLP (host-side container)."""
    w1: np.ndarray   # [F, H]
    b1: np.ndarray   # [H]
    w2: np.ndarray   # [H, H]
    b2: np.ndarray   # [H]
    w_cls: np.ndarray  # [H, 10]
    b_cls: np.ndarray  # [10]
    w_err: np.ndarray  # [H, 1]
    b_err: np.ndarray  # [1]
    ctx: int = 2       # +-ctx positions of feature context
    conf: float = 2.0  # calibrated correction-confidence threshold (logits
                       # of margin over 'keep')
    sub_ok: int = 1    # calibrated: substitutions allowed (0 = indel-only)

    def save(self, path: str) -> None:
        np.savez(path, **{f.name: getattr(self, f.name)
                          for f in dataclasses.fields(self)})

    @staticmethod
    def load(path: str) -> "DcModel":
        with np.load(path) as z:
            conv = {"ctx": int, "conf": float, "sub_ok": int}
            return DcModel(**{k: conv.get(k, lambda v: v)(z[k])
                              for k in z.files})

    def module(self, device) -> "DcNet":
        """The weights, copied, as a torch module on ``device`` (the
        counterpart of the JAX package's ``tree()``)."""
        return DcNet(self, device)

    def with_weights(self, net: "DcNet") -> "DcModel":
        """This model with ``net``'s weights copied back to numpy."""
        return dataclasses.replace(self, **{
            k: getattr(net, k).detach().cpu().numpy().copy() for k in WEIGHTS})


class DcNet(torch.nn.Module):
    """The MLP's weights as float32 parameters named as ``DcModel``'s
    fields; ``dc_forward`` computes the model."""

    def __init__(self, model: DcModel, device):
        super().__init__()
        for k in WEIGHTS:
            setattr(self, k, torch.nn.Parameter(torch.tensor(
                np.asarray(getattr(model, k)), dtype=torch.float32,
                device=torch.device(device))))


N_BASE_FEATS = KINDS + 7  # 9 deltas + qv + cov + runlen + 4 base one-hot
N_PILEUP_FEATS = 3        # per-read pileup evidence vs the polished
                          # template: disagree frac, indel-vote frac, cov
                          # support frac


def init_model(rng: np.random.Generator, hidden: int = 64, *,
               n_feats: Optional[int] = None,
               ctx: int = 2) -> DcModel:
    F_ = (n_feats or N_BASE_FEATS) * (2 * ctx + 1)
    s = 1.0 / np.sqrt(F_)
    return DcModel(
        w1=rng.normal(0, s, (F_, hidden)).astype(np.float32),
        b1=np.zeros(hidden, np.float32),
        w2=rng.normal(0, 1 / np.sqrt(hidden), (hidden, hidden)).astype(
            np.float32),
        b2=np.zeros(hidden, np.float32),
        w_cls=np.zeros((hidden, N_CLASSES), np.float32),
        b_cls=np.zeros(N_CLASSES, np.float32),
        w_err=np.zeros((hidden, 1), np.float32),
        b_err=np.zeros(1, np.float32),
        ctx=ctx)


def window_features(tpl, tlen, lls, ll, qv, coverage, extra=None):
    """Per-position feature tensor [B, T, N_BASE_FEATS(+E)] from the final
    polish state, on the device of ``tpl``.

    tpl [B,T] int8, lls [B, 9T+4], ll [B], qv [B,T], coverage [B];
    ``extra`` [B, T, E] appends raw per-read evidence channels (e.g.
    pileup_extra_features)."""
    B, T = tpl.shape
    dev = tpl.device
    reg = lls[:, :KINDS * T].reshape(B, T, KINDS)
    delta = torch.clamp(reg - ll[:, None, None], -40.0, 10.0) / 10.0
    j = torch.arange(T, device=dev)[None, :]
    in_tpl = j < tlen[:, None]
    qvf = torch.where(in_tpl, qv, 0.0)[..., None] / 40.0
    covf = (coverage.to(torch.float32) / 16.0)[:, None, None].expand(B, T, 1)
    # homopolymer run length at each position (run containing j), capped 8:
    # the left-run length by an 8-step recurrence
    same_prev = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=dev),
                           tpl[:, 1:] == tpl[:, :-1]], dim=1)
    left = torch.zeros((B, T), dtype=torch.int32, device=dev)
    for _ in range(8):
        prev = torch.cat([torch.zeros((B, 1), dtype=torch.int32, device=dev),
                          left[:, :-1]], dim=1)
        left = torch.where(same_prev, prev + 1, 0)
    run = (left + 1).to(torch.float32) / 8.0
    base_oh = (tpl.long()[..., None] == torch.arange(4, device=dev)) & \
        in_tpl[..., None]
    parts = [delta, qvf, covf, run[..., None], base_oh.to(torch.float32)]
    if extra is not None:
        parts.append(torch.as_tensor(extra, dtype=torch.float32, device=dev))
    feats = torch.cat(parts, dim=-1)
    return torch.where(in_tpl[..., None], feats, 0.0)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def pileup_extra_features(tpl, tlen, reads, rlens) -> np.ndarray:
    """Per-read pileup evidence channels [B, T, 3] vs the (polished)
    template, from affine alignments of every window read slice (native
    ccs_pileup_draft vote stats). Host-side numpy.

    Channels (coverage-normalized): disagree = (cov - agree)/cov,
    indel-vote frac, cov support = cov/lanes. Windows where the pileup's
    consensus length differs from the template keep zero features."""
    tpl, tlen, reads, rlens = (_numpy(a) for a in (tpl, tlen, reads, rlens))
    B, T = tpl.shape
    out = np.zeros((B, T, N_PILEUP_FEATS), np.float32)
    for b in range(B):
        tl = int(tlen[b])
        rds = [reads[b, c, :rlens[b, c]] % 4 for c in range(reads.shape[1])
               if rlens[b, c] > 0]
        if tl <= 0 or not rds:
            continue
        _d, _m, _i, _w, st, _r = _pileup_consensus(
            np.ascontiguousarray(tpl[b, :tl]) % 4, rds, want_stats=True)
        if st is None or len(st) != tl:
            continue
        cov = np.maximum(st[:, 0], 1.0)
        out[b, :tl, 0] = (st[:, 0] - st[:, 1]) / cov
        out[b, :tl, 1] = st[:, 2] / cov
        out[b, :tl, 2] = st[:, 0] / max(len(rds), 1)
    return out


def _stack_context(feats, ctx: int):
    parts = []
    for off in range(-ctx, ctx + 1):
        if off < 0:
            p = F.pad(feats[:, :off], (0, 0, -off, 0))
        elif off > 0:
            p = F.pad(feats[:, off:], (0, 0, 0, off))
        else:
            p = feats
        parts.append(p)
    return torch.cat(parts, dim=-1)


def dc_forward(net: DcNet, feats, ctx: int):
    """Model forward: (class logits [B,T,10], error logit [B,T])."""
    x = _stack_context(feats, ctx)
    h = torch.tanh(x @ net.w1 + net.b1)
    h = torch.tanh(h @ net.w2 + net.b2)
    return h @ net.w_cls + net.b_cls, (h @ net.w_err + net.b_err)[..., 0]


def apply_corrections(tpl, tlen, cs, ce, cls, allow,
                      conf_thresh: float = 2.0, allow_sub: bool = True):
    """Apply per-position argmax corrections where the win margin over
    'keep' exceeds ``conf_thresh`` logits and ``allow`` [B] is set;
    ``allow_sub=False`` restricts them to indels. Classes map to the
    (sel, pkind) encoding of pipeline.polish_fused.apply_mutations, spaced
    >= 3 apart by the same local-argmax rule (first index wins ties).

    Returns (ntpl, nlen, ncs, nce, applied_mask [B])."""
    B, T = tpl.shape
    dev = tpl.device
    margin = cls - cls[..., 0:1]                      # vs keep
    alt = margin[..., 1:]                             # [B, T, 9]
    if not allow_sub:                                 # classes 1..4 = subs
        alt = torch.cat([torch.full_like(alt[..., :4], -1e30), alt[..., 4:]],
                        dim=-1)
    best = alt.amax(dim=-1)
    kind = alt.argmax(dim=-1).to(torch.int32)         # 0..8 == polish kinds
    j = torch.arange(T, device=dev)[None, :]
    ok = (best > conf_thresh) & (j < tlen[:, None]) & allow[:, None]
    val = torch.where(ok, best, -1e30)
    sel = ok
    for off in (1, 2):
        sel = sel & (val > _shift_val(val, -off, -1e30))
        sel = sel & (val >= _shift_val(val, off, -1e30))
    no = torch.zeros(B, dtype=torch.bool, device=dev)
    ntpl, nlen, ncs, nce, _pri, applied = apply_mutations(
        tpl, tlen, cs, ce, None, sel, kind, no,
        torch.zeros(B, dtype=torch.int32, device=dev), no)
    return ntpl, nlen, ncs, nce, applied


@torch.no_grad()
def refine_chunk(net: DcNet, ctx: int, tables: dict, state, qv,
                 reads, rlens, snr_bin,
                 qv_thresh: float = 25.0, conf_thresh: float = 2.0,
                 allow_sub: bool = True, rec=None):
    """Revio-shaped post-polish refinement of one window chunk
    (revio.md:29-53):

    1. windows whose mean core QV < ``qv_thresh`` (and that have reads)
       are processed by the model;
    2. confident corrections are applied to those windows;
    3. if any window was corrected, the chunk's refined templates are
       re-scored by the dense Arrow scorer for the final per-base QVs (one
       host read per chunk decides it);
    4. ``qv_rq`` is the model's calibrated QV on processed windows and the
       Arrow QV elsewhere, the stream ``rq`` averages.

    Returns (tpl, tlen, cs, ce, qv_out, qv_rq, processed [B]). The host
    read of step 3 is a ``sync`` span of ``rec`` (a ``telemetry.Recorder``,
    or None)."""
    B, T = state.tpl.shape
    dev = state.tpl.device
    coverage = (rlens >= 0).sum(-1).to(torch.int32)
    feats = window_features(state.tpl, state.tlen, state.lls, state.ll, qv,
                            coverage)
    cls, err = dc_forward(net, feats, ctx)
    j = torch.arange(T, device=dev)[None, :]
    core = (j >= state.core_start[:, None]) & (j < state.core_end[:, None])
    n_core = torch.clamp(core.sum(-1), min=1)
    win_qv = torch.where(core, qv, 0.0).sum(-1) / n_core
    processed = (win_qv < qv_thresh) & (coverage > 0)
    ntpl, nlen, ncs, nce, applied = apply_corrections(
        state.tpl, state.tlen, state.core_start, state.core_end, cls,
        processed, conf_thresh, allow_sub=allow_sub)

    qv_out = qv
    with telemetry.span(rec, "sync"):
        any_applied = bool(applied.any())
    if any_applied:
        lls2, ll2 = score_all(ntpl, nlen, snr_bin, reads, rlens, tables)
        qv2, _pe = _qv_from_lls(lls2, ll2, ntpl, nlen)
        qv_out = torch.where(applied[:, None], qv2, qv)
    # model QV for the rq stream on processed windows; the error head is
    # de-biased for the training upweight so its probabilities are
    # mass-calibrated (see err_head_quality)
    p_err = torch.sigmoid(err - math.log(ERR_UPWEIGHT))
    qv_dc = torch.clamp(-10.0 * torch.log10(torch.clamp(p_err, min=1e-9)),
                        0.0, 93.0)
    qv_rq = torch.where(processed[:, None], qv_dc, qv_out)
    qv_rq = torch.where(j < nlen[:, None], qv_rq, 0.0)
    return ntpl, nlen, ncs, nce, qv_out, qv_rq, processed


def builtin_model() -> Optional[DcModel]:
    import os
    path = os.path.join(os.path.dirname(__file__), "data", "dc_v0.npz")
    if os.path.exists(path):
        return DcModel.load(path)
    return None


# ---------------------------------------------------------------------------
# training (offline / test-time; produces models/data/dc_v0.npz)
# ---------------------------------------------------------------------------

def make_training_batch(n_windows: int, params_gen, params_score,
                        rng: np.random.Generator, t_len=(26, 33),
                        coverage=(4, 16), t_cap: int = 44,
                        r_cap: int = 39, snr_bin: int = 3,
                        per_read: bool = False, device=None):
    """Simulate windows with ``params_gen`` (the TRUE chemistry), polish
    them on ``device`` (None: the first CUDA device; raises without one)
    with ``params_score`` (the assumed chemistry), and
    label each position of the POLISHED template with the correction class
    that moves it toward the truth. Draws from ``rng`` in the JAX package's
    order. Returns (state, qv, coverage, features, labels, weights,
    truths); state, qv and features are tensors on ``device``."""
    from ccs_tpu_torch.cli import resolve_device
    device = resolve_device(device)[0]
    W = n_windows
    # per-window coverage sampled across the production range so the model
    # never faces a coverage domain shift at inference
    if isinstance(coverage, int):
        lo = hi = coverage
    else:
        lo, hi = coverage
    cov_w = rng.integers(lo, hi + 1, W)
    c_max = int(cov_w.max())
    truth_list = []
    tpl = np.full((W, t_cap), -1, np.int8)
    tlen = np.zeros(W, np.int32)
    reads = np.full((W, c_max, r_cap), -1, np.int8)
    rlens = np.full((W, c_max), -1, np.int32)
    for b in range(W):
        tl = int(rng.integers(*t_len))
        t = rng.integers(0, 4, tl).astype(np.int8)
        truth_list.append(t)
        corrupt = t.copy()
        for _ in range(int(rng.integers(0, 2))):
            p = int(rng.integers(0, tl))
            corrupt[p] = (corrupt[p] + 1) % 4
        tpl[b, :tl] = corrupt
        tlen[b] = tl
        for c in range(int(cov_w[b])):
            r = simulate_read(t, params_gen, snr_bin, rng)[:r_cap]
            reads[b, c, :len(r)] = r
            rlens[b, c] = len(r)
    tables = params_to_torch(params_score, device)
    on_dev = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    state, qv, _p = polish_windows_fused(
        on_dev(tpl), on_dev(tlen), on_dev(np.zeros(W, np.int32)),
        on_dev(tlen.copy()), on_dev(np.full(W, snr_bin, np.int32)),
        on_dev(reads), on_dev(rlens), tables, max_iters=40)
    out_tpl = _numpy(state.tpl)
    out_tlen = _numpy(state.tlen)
    extra = (pileup_extra_features(out_tpl, out_tlen, reads, rlens)
             if per_read else None)
    feats = window_features(state.tpl, state.tlen, state.lls, state.ll, qv,
                            on_dev(cov_w.astype(np.int32)), extra=extra)
    # labels: class per position of the polished template (0 = keep)
    labels = np.zeros((W, t_cap), np.int64)
    weights = np.zeros((W, t_cap), np.float32)
    for b in range(W):
        L = int(out_tlen[b])
        cons = out_tpl[b, :L]
        aln = guided_align(cons, truth_list[b], band=16)
        if aln is None:
            continue
        weights[b, :L] = 1.0
        i = j = 0
        for ln, op in aln.cigar:
            if op == "M":
                for q in range(ln):
                    if cons[i + q] != truth_list[b][j + q]:
                        labels[b, i + q] = 1 + int(truth_list[b][j + q])
                i += ln
                j += ln
            elif op == "I":            # consensus extra base -> delete it
                for q in range(ln):
                    labels[b, min(i + q, L - 1)] = 5
                i += ln
            else:                      # missing base -> insert after i-1
                labels[b, max(i - 1, 0)] = 6 + int(truth_list[b][j])
                j += ln
    return (state, qv, cov_w.astype(np.int32), feats,
            labels, weights, [np.asarray(t) for t in truth_list])


def dc_loss(net: DcNet, feats, labels, weights, ctx: int):
    """The training loss: per-position class cross-entropy plus the error
    head's binary cross-entropy, error positions upweighted."""
    logits, err = dc_forward(net, feats, ctx)
    ce = F.cross_entropy(logits.reshape(-1, N_CLASSES), labels.reshape(-1),
                         reduction="none").reshape(labels.shape)
    is_err = (labels > 0).to(torch.float32)
    bce = F.binary_cross_entropy_with_logits(err, is_err, reduction="none")
    # class imbalance: errors are ~1% of positions — upweight them
    w = weights * (1.0 + ERR_UPWEIGHT * is_err)
    return ((ce + bce) * w).sum() / torch.clamp(w.sum(), min=1.0)


def make_train_step(net: DcNet, ctx: int, lr: float):
    """One Adam step on ``dc_loss`` (optax.adam's rule and defaults);
    returns fn(feats, labels, weights) -> loss tensor (no host read)."""
    opt = torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)

    def step(feats, labels, weights):
        opt.zero_grad(set_to_none=True)
        loss = dc_loss(net, feats, labels, weights, ctx)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def train(params_gen, params_score, steps: int = 300, n_windows: int = 256,
          hidden: int = 48, ctx: int = 2, lr: float = 3e-3,
          seed: int = 0, batches: int = 4, log=None,
          per_read: bool = False, device=None) -> DcModel:
    """Train the refinement model under chemistry mismatch on ``device``
    (None: the first CUDA device; raises without one). ``per_read``
    appends the pileup evidence channels (N_PILEUP_FEATS)."""
    from ccs_tpu_torch.cli import resolve_device
    device = resolve_device(device)[0]
    rng = np.random.default_rng(seed)
    n_feats = N_BASE_FEATS + (N_PILEUP_FEATS if per_read else 0)
    model = init_model(rng, hidden=hidden, ctx=ctx, n_feats=n_feats)
    net = model.module(device)
    data = []
    for _ in range(batches):
        _st, _qv, _cov, feats, labels, weights, _tr = make_training_batch(
            n_windows, params_gen, params_score, rng, per_read=per_read,
            device=device)
        data.append((feats, torch.from_numpy(labels).to(device),
                     torch.from_numpy(weights).to(device)))

    step = make_train_step(net, ctx, lr)
    for it in range(steps):
        loss = step(*data[it % len(data)])
        if log and it % 50 == 0:
            log(f"dc train step {it}: loss {float(loss):.4f}")
    out = model.with_weights(net)
    # Calibrate the confidence threshold on HELD-OUT data: keep the one
    # that minimizes residual errors after applying corrections, so the
    # model only fires where its margin has proven, out of sample, to beat
    # Arrow.
    out.conf, out.sub_ok = calibrate_conf(
        out, params_gen, params_score, seed=seed + 1000,
        n_windows=n_windows, log=log, per_read=per_read, device=device)
    return out


def err_head_quality(model: DcModel, state, feats, labels, in_tpl=None):
    """Held-out quality of the de-biased error head: returns
    (discrimination, mass_ratio) where discrimination = mean predicted
    error probability at TRUE residual-error positions over the mean at
    clean positions, and mass_ratio = total predicted error mass over the
    actual error count. Runs on the device of ``feats``."""
    dev = feats.device
    with torch.no_grad():
        _cls, err = dc_forward(model.module(dev), feats, model.ctx)
    p = torch.sigmoid(err - math.log(ERR_UPWEIGHT))
    B, T = state.tpl.shape
    if in_tpl is None:
        in_tpl = torch.arange(T, device=dev)[None, :] < state.tlen[:, None]
    lab = torch.as_tensor(labels, device=dev) > 0
    is_err = lab & in_tpl
    clean = ~lab & in_tpl
    p_err_mean = float(torch.where(is_err, p, 0.0).sum()
                       / torch.clamp(is_err.sum(), min=1))
    p_clean_mean = float(torch.where(clean, p, 0.0).sum()
                         / torch.clamp(clean.sum(), min=1))
    mass = float(torch.where(in_tpl, p, 0.0).sum())
    n_err = float(is_err.sum())
    return (p_err_mean / max(p_clean_mean, 1e-9),
            mass / max(n_err, 1.0))


def calibrate_conf(model: DcModel, params_gen, params_score, seed: int,
                   n_windows: int = 192, log=None,
                   grid=(1.0, 1.5, 2.0, 3.0, 4.0, 6.0),
                   per_read: bool = False, device=None):
    """Pick the (threshold, allow-substitutions) pair minimizing held-out
    residual errors. Returns (inf, 1) when nothing strictly helps (model
    then never fires)."""
    rng = np.random.default_rng(seed)
    state, _qv, _cov, feats, _labels, _weights, truths = make_training_batch(
        n_windows, params_gen, params_score, rng, per_read=per_read,
        device=device)
    base = residual_errors(_numpy(state.tpl), _numpy(state.tlen), truths)
    with torch.no_grad():
        cls, _err = dc_forward(model.module(feats.device), feats, model.ctx)
    allow = torch.ones(len(truths), dtype=torch.bool, device=feats.device)
    best = (float("inf"), 1)
    best_err = base
    for sub_ok in (1, 0):
        for th in grid:
            ntpl, nlen, _cs, _ce, _ap = apply_corrections(
                state.tpl, state.tlen, state.core_start, state.core_end,
                cls, allow, conf_thresh=th, allow_sub=bool(sub_ok))
            err = residual_errors(_numpy(ntpl), _numpy(nlen), truths)
            if log:
                log(f"dc calibrate: thresh {th} sub_ok {sub_ok} -> {err} "
                    f"errors (base {base})")
            if err < best_err:
                best_err, best = err, (th, sub_ok)
    return best


def residual_errors(tpl, tlen, truths) -> int:
    """Total edit errors of each template row vs its truth (banded)."""
    tot = 0
    for b in range(len(truths)):
        cons = np.asarray(tpl[b, :int(tlen[b])])
        aln = guided_align(cons, truths[b], band=16)
        if aln is None:
            tot += len(truths[b])
            continue
        i = j = 0
        for ln, op in aln.cigar:
            if op == "M":
                tot += int((cons[i:i + ln] != truths[b][j:j + ln]).sum())
                i += ln
                j += ln
            elif op == "I":
                tot += ln
                i += ln
            else:
                tot += ln
                j += ln
    return tot
