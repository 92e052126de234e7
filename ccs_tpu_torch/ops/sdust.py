"""Tandem-repeat / low-complexity detection (component C13).

The reference runs a "modified version of the symmetric DUST algorithm
(sdust)" and flags ZMWs whose draft has a tandem repeat longer than
``--min-tandem-repeat-length`` (default 1000); flagged ZMWs get heuristics
disabled (reference docs, faq/low-complexity.md:7-18).

Implementation: DUST-style triplet duplication scoring in sliding windows
(vectorized NumPy), merged into maximal low-complexity intervals. Exact
sdust interval boundaries are not required by the contract — only whether a
long tandem repeat exists and roughly where.
"""

from __future__ import annotations

import numpy as np

DUST_WINDOW = 64
DUST_T = 2.0  # score threshold, as in DUST/sdust


def _triplet_codes(seq: np.ndarray) -> np.ndarray:
    s = np.clip(np.asarray(seq, dtype=np.int64), 0, 3)
    if len(s) < 3:
        return np.empty(0, dtype=np.int64)
    return s[:-2] * 16 + s[1:-1] * 4 + s[2:]


def dust_score_profile(seq: np.ndarray, window: int = DUST_WINDOW) -> np.ndarray:
    """Per-position DUST score: sum over triplets t of c_t*(c_t-1)/2 divided
    by (w-1), computed in a sliding window (one score per window start).

    Dispatches to the native incremental kernel (exact integer pair
    counts); the difference-array formulation below is the oracle/fallback
    (CCS_TPU_NO_NATIVE=1)."""
    from ccs_tpu_torch import native
    lib = native.load()
    if lib is not None and hasattr(lib, "ccs_dust_profile") and len(seq) >= 3:
        import ctypes
        s8 = np.ascontiguousarray(seq, dtype=np.int8)
        n_out_cap = max(len(s8) - 2, 1)
        out = np.empty(n_out_cap, dtype=np.float64)
        n_out = lib.ccs_dust_profile(
            s8.ctypes.data_as(ctypes.c_void_p), len(s8), int(window),
            out.ctypes.data_as(ctypes.c_void_p))
        return out[:max(int(n_out), 0)]
    trip = _triplet_codes(seq)
    n = len(trip)
    if n == 0:
        return np.zeros(0, dtype=np.float64)
    w = min(window - 2, n)  # triplets per window
    # score[s] = # equal-triplet pairs (i, j), s <= i < j <= s+w-1. Each
    # pair at lag d = j-i < w contributes to window starts
    # s in [j-w+1, i] ∩ [0, n-w]; painted via a difference array, one
    # vectorized pass per lag (replaces the per-position Python loop).
    delta = np.zeros(n - w + 2, dtype=np.int64)
    for d in range(1, w):
        i = np.nonzero(trip[d:] == trip[:-d])[0]
        if len(i) == 0:
            continue
        lo = np.maximum(i + d - w + 1, 0)
        hi = np.minimum(i, n - w)
        keep = lo <= hi
        np.add.at(delta, lo[keep], 1)
        np.add.at(delta, hi[keep] + 1, -1)
    scores = np.cumsum(delta[:-1]).astype(np.float64)
    return scores / max(w - 1, 1)


def low_complexity_intervals(seq: np.ndarray, window: int = DUST_WINDOW,
                             threshold: float = DUST_T) -> list[tuple[int, int]]:
    """Maximal merged intervals whose windows exceed the DUST threshold."""
    scores = dust_score_profile(seq, window)
    if len(scores) == 0:
        return []
    w = min(window, len(seq))
    hot = scores > threshold
    starts = np.nonzero(hot & ~np.concatenate([[False], hot[:-1]]))[0]
    ends = np.nonzero(hot & ~np.concatenate([hot[1:], [False]]))[0]
    intervals = [(int(a), int(b) + w) for a, b in zip(starts, ends)]
    # merge overlapping
    merged: list[tuple[int, int]] = []
    for a, b in intervals:
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def max_tandem_repeat_length(seq: np.ndarray) -> int:
    """Length of the longest low-complexity/tandem-repeat interval."""
    iv = low_complexity_intervals(seq)
    return max((b - a for a, b in iv), default=0)


def has_long_tandem_repeat(seq: np.ndarray, min_len: int = 1000) -> bool:
    return max_tandem_repeat_length(seq) >= min_len
