"""Frozen yardstick of the scorer kernel: the production window batch, the
operations and bytes the scorer needs for it, and the H100's peaks.

Copied from ``chip_smoke.py`` (``window_batch``, ``_scorer_flops``,
``_bound``, ``_nbytes``, the peaks and per-cell operation counts), with
one change: the candidate mask. ``chip_smoke.py`` takes it from the
program's draft pileup (native code of the program); here each template
position is a candidate with probability ``CAND_SHARE``, the share that
pileup flagged on this batch (32.2 %, ``PERF.md``), drawn from the seed.
"""

from __future__ import annotations

import numpy as np

from ccsbench.frozen import sim

T_CAP, R_CAP, W, C = 44, 39, 2048, 16
CAND_SHARE = 0.322
# H100 SXM peaks at 700 W: HBM3 bytes/s; float32 FLOP/s outside the
# tensor cores (128 lanes x 2 per FMA per SM)
HBM_BYTES_S, FP32_FLOP_S = 3.35e12, 67e12
# float32 operations per cell of the scorer's recurrences: a column step
# (forward or backward) and a three-operator bridge step
SWEEP_FLOPS, BRIDGE_FLOPS = 21, 59


def window_batch(rng: np.random.Generator):
    """Production-shape windows: simulator reads at snr bin 4 of 26-32 bp
    templates with 0-1 injected errors, 16 reads a window.
    Returns tpl, tlen, snr_bin, reads, rlens, cand (numpy)."""
    params = sim.default_params()
    tpl = np.full((W, T_CAP), -1, np.int8)
    tlen = np.zeros(W, np.int32)
    reads = np.full((W, C, R_CAP), -1, np.int8)
    rlens = np.full((W, C), -1, np.int32)
    for b in range(W):
        tl = int(rng.integers(26, 33))
        t = rng.integers(0, 4, tl).astype(np.int8)
        corrupt = t.copy()
        for _ in range(int(rng.integers(0, 2))):
            p = int(rng.integers(0, tl))
            corrupt[p] = (corrupt[p] + 1) % 4
        tpl[b, :tl] = corrupt
        tlen[b] = tl
        for c in range(C):
            r = sim.simulate_read(t, params, 4, rng)[:R_CAP]
            reads[b, c, :len(r)] = r
            rlens[b, c] = len(r)
    pos = np.arange(T_CAP)[None, :] < tlen[:, None]
    cand = pos & (rng.random((W, T_CAP)) < CAND_SHARE)
    snr_bin = np.full(W, 4, np.int32)
    return tpl, tlen, snr_bin, reads, rlens, cand


def scorer_flops(tlen, rlens, cand) -> float:
    """float32 operations the scorer needs: per live subread of rl bases,
    2*tl+1 column steps and 8 bridges per scored position (+4 prepends),
    each over rl+1 cells."""
    tl = tlen.astype(np.int64)
    cells = np.where(rlens >= 0, np.minimum(rlens, R_CAP) + 1, 0).sum(axis=1)
    pos_ok = np.arange(T_CAP)[None, :] < tl[:, None]
    npos = (pos_ok if cand is None else pos_ok & cand).sum(axis=1)
    return float((cells * (SWEEP_FLOPS * (2 * tl + 1)
                           + BRIDGE_FLOPS * (8 * npos + 4))).sum())


def bound_ms(ops: float, nbytes: int) -> tuple[float, str]:
    """(least time in ms, what bounds it): operations over the float32
    peak, or bytes (each input and output once) over HBM bandwidth."""
    terms = {"operations": ops / FP32_FLOP_S * 1e3,
             "bytes": nbytes / HBM_BYTES_S * 1e3}
    by = max(terms, key=terms.get)
    return terms[by], by
