"""Scorer inputs at the edge shapes of its kernel, for its checks."""

from __future__ import annotations

import numpy as np


def edge_batch(rng, n_reads: int, t_cap: int, r_cap: int):
    """Windows at the shapes where a lane-tiled sweep can go wrong: every
    template length of {0, 1, T/2, T} with every read length of {0, 1, 31,
    32, 33, R} (those the cap admits), the reads of a window rotating
    through the lengths, about a quarter of them dead (rlens -1), and one
    window with no live read. Bases and pulse-width bins are random."""
    tls = (0, 1, max(1, t_cap // 2), t_cap)
    rls = sorted({rl for rl in (0, 1, 31, 32, 33, r_cap) if rl <= r_cap})
    n = len(tls) * len(rls) + 1
    tpl = np.full((n, t_cap), -1, np.int8)
    tlen = np.zeros(n, np.int32)
    reads = np.full((n, n_reads, r_cap), -1, np.int8)
    rlens = np.full((n, n_reads), -1, np.int32)
    for b in range(n - 1):
        tl = tls[b % len(tls)]
        tpl[b, :tl] = rng.integers(0, 4, tl)
        tlen[b] = tl
        for c in range(n_reads):
            if c > 0 and (b + 3 * c) % 4 == 3:
                continue                                    # dead read
            rl = rls[(b // len(tls) + c) % len(rls)]
            reads[b, c, :rl] = rng.integers(0, 16, rl)
            rlens[b, c] = rl
    tpl[n - 1, :5] = rng.integers(0, 4, 5)
    tlen[n - 1] = 5
    snr_bin = rng.integers(0, 8, n).astype(np.int32)
    return tpl, tlen, snr_bin, reads, rlens
