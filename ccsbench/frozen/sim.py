"""Frozen copy of the port's subread simulator and the model it samples.

Copied from ``ccs_tpu_torch/sim/simulator.py`` (``simulate_read``,
``sample_pw_frames``, and ``simulate_zmw`` with full passes, with or without
pulse widths),
``ccs_tpu_torch/models/chemistry.py`` (``default_params``: the simulator's
generative model is built in code and reads no data file) and
``ccs_tpu_torch/ops/dna.py`` (``revcomp``). The benchmark makes its inputs
with this copy so that a later change to the program cannot change the
traffic it is measured on. ``ccsbench/tests/test_ccsbench_frozen.py`` holds
it equal to the program's simulator at fixed seeds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

N_CTX = 16
N_SNR_BINS = 8

CX_FULL = 3          # adapter before and after: a full pass

_COMP = np.array([3, 2, 1, 0], dtype=np.int8)


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of int8 codes A=0 C=1 G=2 T=3 (pad -1 stays)."""
    codes = np.asarray(codes)
    out = np.where(codes >= 0, _COMP[np.clip(codes, 0, 3)], codes)
    return out[::-1].copy()


@dataclasses.dataclass
class SimParams:
    """The tables of the generative pair-HMM, indexed [snr_bin, ctx, ...]
    with ctx = 4 * previous base + current base."""
    snr_edges: np.ndarray
    trans: np.ndarray         # match, branch, stick, delete
    emit_match: np.ndarray
    emit_stick: np.ndarray

    def snr_bin(self, snr) -> np.ndarray:
        return np.searchsorted(self.snr_edges, np.asarray(snr))


def default_params() -> SimParams:
    """~90 % subread accuracy, with mild SNR and homopolymer modulation."""
    rng_snr = np.linspace(3.0, 14.0, N_SNR_BINS)
    snr_edges = 0.5 * (rng_snr[:-1] + rng_snr[1:])
    trans = np.zeros((N_SNR_BINS, N_CTX, 4), dtype=np.float64)
    emit_match = np.zeros((N_SNR_BINS, N_CTX, 4), dtype=np.float64)
    emit_stick = np.zeros((N_SNR_BINS, N_CTX, 4), dtype=np.float64)
    for b in range(N_SNR_BINS):
        scale = 1.4 - 0.7 * b / (N_SNR_BINS - 1)
        for ctx in range(N_CTX):
            prev, cur = ctx // 4, ctx % 4
            homo = 1.5 if prev == cur else 1.0
            p_branch = min(0.045 * scale * homo, 0.25)
            p_stick = min(0.025 * scale, 0.25)
            p_del = min(0.045 * scale * homo, 0.25)
            p_match = 1.0 - p_branch - p_stick - p_del
            trans[b, ctx] = (p_match, p_branch, p_stick, p_del)
            p_mis = min(0.015 * scale, 0.2)
            em = np.full(4, p_mis / 3)
            em[cur] = 1.0 - p_mis
            emit_match[b, ctx] = em
            es = np.full(4, 1.0 / 3.0)
            es[cur] = 0.0
            emit_stick[b, ctx] = es
    return SimParams(snr_edges=snr_edges.astype(np.float32),
                     trans=trans.astype(np.float32),
                     emit_match=emit_match.astype(np.float32),
                     emit_stick=emit_stick.astype(np.float32))


def simulate_read(tpl: np.ndarray, params: SimParams, snr_bin: int,
                  rng: np.random.Generator,
                  return_classes: bool = False) -> np.ndarray:
    """Draw one read from the generative HMM: at template position j a
    geometric number of branch/stick insertions, then a match or a delete.
    ``return_classes`` also returns each base's event class (0 match,
    1 branch, 2 stick); it draws nothing more from ``rng``."""
    tpl = np.asarray(tpl, dtype=np.int64)
    T = len(tpl)
    if T == 0:
        e = np.empty(0, dtype=np.int8)
        return (e, e.copy()) if return_classes else e
    prev = np.concatenate([tpl[:1], tpl[:-1]])
    ctx = 4 * prev + tpl
    trans = params.trans[snr_bin][ctx]
    em = params.emit_match[snr_bin][ctx]
    es = params.emit_stick[snr_bin][ctx]
    p_stay = trans[:, 1] + trans[:, 2]
    k = rng.geometric(np.clip(1.0 - p_stay, 1e-9, 1.0)) - 1
    leave_match = rng.random(T) < trans[:, 0] / np.maximum(
        trans[:, 0] + trans[:, 3], 1e-12)
    cum_em = np.cumsum(em, axis=1)
    mbase = np.minimum(
        (rng.random(T)[:, None] * cum_em[:, -1:] > cum_em).sum(axis=1), 3)
    parent = np.repeat(np.arange(T), k)
    K = len(parent)
    is_branch = rng.random(K) < (trans[:, 1] /
                                 np.maximum(p_stay, 1e-12))[parent]
    cum_es = np.cumsum(es, axis=1)[parent]
    sbase = np.minimum((rng.random(K)[:, None] * cum_es[:, -1:]
                        > cum_es).sum(axis=1), 3) if K else \
        np.empty(0, dtype=np.int64)
    ins_base = np.where(is_branch, tpl[parent], sbase)
    lens = k + leave_match.astype(np.int64)
    off = np.concatenate([[0], np.cumsum(lens)])
    out = np.empty(int(off[-1]), dtype=np.int8)
    rank = np.arange(K) - np.repeat(np.cumsum(k) - k, k)
    out[off[parent] + rank] = ins_base
    mj = np.nonzero(leave_match)[0]
    out[off[mj] + k[mj]] = mbase[mj]
    if not return_classes:
        return out
    cls = np.empty(int(off[-1]), dtype=np.int8)
    cls[off[parent] + rank] = np.where(is_branch, 1, 2).astype(np.int8)
    cls[off[mj] + k[mj]] = 0
    return out, cls


def sample_pw_frames(classes: np.ndarray,
                     rng: np.random.Generator) -> np.ndarray:
    """Pulse-width frames per read base, conditioned on the event class:
    matches ~ 1 + Poisson(18), insertions ~ 1 + Poisson(7)."""
    classes = np.asarray(classes)
    lam = np.where(classes == 0, 18.0, 7.0)
    frames = rng.poisson(lam) + 1
    return np.clip(frames, 1, 255).astype(np.uint8)


@dataclasses.dataclass
class SimZmw:
    hole: int
    insert: np.ndarray              # true template (int8 codes)
    subreads: list
    strands: list
    cx: list
    snr: np.ndarray
    pws: Optional[list] = None      # per subread, pulse-width frames (uint8)
    ipds: Optional[list] = None     # per subread, IPD codes (uint8); drawn
    #                                 by the generator, not the simulator


def simulate_zmw(hole: int, insert_len: int, n_passes: int,
                 params: Optional[SimParams] = None,
                 rng: Optional[np.random.Generator] = None,
                 snr: float = 8.0, with_pw: bool = False) -> SimZmw:
    """One ZMW: an insert read ``n_passes`` times on alternating strands;
    ``with_pw`` draws each base's pulse width after its read."""
    params = params or default_params()
    rng = rng or np.random.default_rng(hole)
    insert = rng.integers(0, 4, size=insert_len).astype(np.int8)
    snr_arr = (np.asarray([snr] * 4, dtype=np.float32)
               + rng.normal(0, 0.5, 4).astype(np.float32))
    snr_bin = int(params.snr_bin(float(snr_arr.mean())))
    subreads, strands = [], []
    pws = [] if with_pw else None
    for p in range(n_passes):
        strand = p % 2
        tpl = revcomp(insert) if strand else insert
        read, cls = simulate_read(tpl, params, snr_bin, rng,
                                  return_classes=True)
        subreads.append(read)
        strands.append(strand)
        if with_pw:
            pws.append(sample_pw_frames(cls, rng))
    return SimZmw(hole=hole, insert=insert, subreads=subreads,
                  strands=strands, cx=[CX_FULL] * n_passes, snr=snr_arr,
                  pws=pws)
