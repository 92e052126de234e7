"""Exhaustive and candidate-sparse pair-HMM mutation scoring.

``score_dense`` and ``score_sparse`` are the counterparts of
``ccs_tpu.ops.hmm_score_pallas.score_all_pallas`` / ``score_sparse_pallas``:
per window they return the exact current-template log-likelihood ``ll0``
[B] and the summed-over-subreads log-likelihood of every single-point
mutation, ``lls`` [B, 9T+4] f32 in the absolute layout m = 9p + k
(k 0..3 substitute base k at p, 4 delete p, 5..8 insert base k-5 after
p; then 4 prepends). ``lls`` is unmasked: the self-substitution slot, the
positions p >= tlen and (sparse) the positions without ``cand`` hold exact
0; the caller applies the validity mask.

On a CUDA tensor each wrapper launches the hand-written Hopper kernel in
``csrc/hmm_score.cu`` (or raises); on a CPU tensor it runs its plain
PyTorch version, ``score_dense_plain`` / ``score_sparse_plain``, built on
``ops.hmm_cols``. ``score_dense.launches`` and ``score_sparse.launches``
count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ccs_tpu_torch.ops import hmm_cols

KINDS = 9
# the kernels hold a column in registers, at most 4 cells per lane
MAX_READ_CAP = 127


def _absolute_ops(tpl, tlen, snr_bin, tables):
    """Bridge operators of the 9-kind absolute enumeration + prepends."""
    B, T = tpl.shape
    dev = tpl.device
    p = torch.arange(T, device=dev).repeat_interleave(KINDS)[None, :]
    k_new = torch.arange(KINDS, device=dev).repeat(T)[None, :]
    p = p.expand(B, KINDS * T)
    k_new = k_new.expand(B, KINDS * T)
    cur = torch.gather(tpl.long(), 1, p)
    # relative kind of mutation_ops_at: sub -> (k-cur-1)%4, del -> 3,
    # ins base k-5 -> k-1
    old_kind = torch.where(k_new <= 3, (k_new - cur - 1) % 4,
                           torch.where(k_new == 4, 3, k_new - 1))
    reg = hmm_cols.mutation_ops_at(tpl, tlen, snr_bin, tables, p, old_kind)
    pre = hmm_cols.prepend_ops(tpl, tlen, snr_bin, tables)
    return tuple(torch.cat([r, q], dim=1) for r, q in zip(reg, pre))


def scored_slots(tpl, tlen, cand=None):
    """[B, 9T+4] bool: the slots the kernels write (everything else is 0):
    positions p < tlen (and cand[p] when given) minus the self-substitution,
    plus the 4 prepends."""
    B, T = tpl.shape
    dev = tpl.device
    k = torch.arange(KINDS, device=dev).repeat(T)[None, :]
    cur = tpl.long().clamp(0, 3).repeat_interleave(KINDS, dim=1)
    pos_ok = torch.arange(T, device=dev)[None, :] < tlen[:, None]
    if cand is not None:
        pos_ok = pos_ok & cand
    reg = pos_ok.repeat_interleave(KINDS, dim=1) & ((k > 3) | (k != cur))
    return torch.cat([reg, torch.ones((B, 4), dtype=torch.bool,
                                      device=dev)], dim=1)


def score_dense_plain(tpl, tlen, snr_bin, reads, rlens, tables):
    """Plain PyTorch version of the dense kernel: (lls [B, 9T+4], ll0 [B])."""
    columns = hmm_cols.build_columns(tpl, tlen, snr_bin, reads, rlens, tables)
    ll0 = columns.ll[:, 0]
    for c in range(1, columns.ll.shape[1]):                # fixed order
        ll0 = ll0 + columns.ll[:, c]
    ops = _absolute_ops(tpl, tlen, snr_bin, tables)
    lls = hmm_cols.bridge_scores(reads, rlens, snr_bin, tables, columns, ops)
    return torch.where(scored_slots(tpl, tlen), lls, 0.0), ll0


def score_sparse_plain(tpl, tlen, snr_bin, reads, rlens, cand, tables):
    """Plain PyTorch version of the sparse kernel: the dense scores with
    exact 0 at every position without ``cand``."""
    lls, ll0 = score_dense_plain(tpl, tlen, snr_bin, reads, rlens, tables)
    return torch.where(scored_slots(tpl, tlen, cand), lls, 0.0), ll0


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _launch(wrapper, fn_name, tpl, tlen, snr_bin, reads, rlens, cand, tables):
    from ccs_tpu_torch.ops import _build
    dev = tpl.device
    if dev.type != "cuda":
        raise RuntimeError(f"the CUDA scorer cannot run on {dev}")
    B, T = tpl.shape
    _, C, R = reads.shape
    _build.check_tensor("tpl", tpl, torch.int8, (B, T), dev)
    _build.check_tensor("tlen", tlen, torch.int32, (B,), dev)
    _build.check_tensor("snr_bin", snr_bin, torch.int32, (B,), dev)
    _build.check_tensor("reads", reads, torch.int8, (B, C, R), dev)
    _build.check_tensor("rlens", rlens, torch.int32, (B, C), dev)
    if cand is not None:
        _build.check_tensor("cand", cand, torch.bool, (B, T), dev)
    if R > MAX_READ_CAP:
        raise ValueError(f"reads of up to {R} bases: the CUDA scorer takes "
                         f"a read cap of at most {MAX_READ_CAP}")
    ctx, pw = tables["ctx"], tables["pw"]
    n_snr = ctx.shape[0]
    _build.check_tensor("ctx table", ctx, torch.float32, (n_snr, 16, 9), dev)
    _build.check_tensor("pw table", pw, torch.float32, (n_snr, 8), dev)
    lls = torch.empty((B, KINDS * T + 4), dtype=torch.float32, device=dev)
    ll0 = torch.empty((B,), dtype=torch.float32, device=dev)
    if B == 0:
        return lls, ll0
    lib = _build.load_library()
    ptr = ctypes.c_void_p
    args = [ptr(tpl.data_ptr()), ptr(tlen.data_ptr()),
            ptr(snr_bin.data_ptr()), ptr(reads.data_ptr()),
            ptr(rlens.data_ptr())]
    if cand is not None:
        args.append(ptr(cand.data_ptr()))
    args += [ptr(ctx.data_ptr()), ptr(pw.data_ptr()), ptr(lls.data_ptr()),
             ptr(ll0.data_ptr()), B, T, C, R, n_snr,
             ptr(torch.cuda.current_stream(dev).cuda_stream)]
    with torch.cuda.device(dev):
        rc = getattr(lib, fn_name)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {rc} "
                           f"({_build.error_string(rc)})")
    _build.count_launch(wrapper)
    return lls, ll0


def score_dense(tpl, tlen, snr_bin, reads, rlens, tables):
    """Exhaustive mutation scores + exact ll0 for every window (see module
    docstring). Kernel on CUDA tensors, plain version on CPU tensors."""
    if tpl.device.type == "cpu":
        return score_dense_plain(tpl, tlen, snr_bin, reads, rlens, tables)
    return _launch(score_dense, "ccs_hmm_score_dense", tpl, tlen, snr_bin,
                   reads, rlens, None, tables)


def score_sparse(tpl, tlen, snr_bin, reads, rlens, cand, tables):
    """Candidate-sparse scores: exact ll0, mutation LLs at positions with
    ``cand`` [B, T] bool set (prepends always), exact 0 elsewhere."""
    if tpl.device.type == "cpu":
        return score_sparse_plain(tpl, tlen, snr_bin, reads, rlens, cand,
                                  tables)
    return _launch(score_sparse, "ccs_hmm_score_sparse", tpl, tlen, snr_bin,
                   reads, rlens, cand, tables)


score_dense.launches = 0
score_sparse.launches = 0
