"""Batched banded global edit distance of (read, template) pairs.

Counterpart of ``ccs_tpu.ops.align_pallas`` (``edit_distance_banded`` and
its Pallas kernel ``_edit_kernel``). Unit substitution and gap costs,
global alignment, the band kept on the ``j - i`` diagonal (``i`` the read
position, ``j`` the template position): row ``i`` holds ``2*band + 1``
cells ``k = j - i + band``. The distance is read at
``k_end = tlen - rlen + band`` and is ``BIG`` where ``|tlen - rlen| >
band``; a value ``>= BIG / 2`` means the alignment left the band. It equals
the dense Needleman-Wunsch distance whenever the optimal path's ``|j - i|``
stays within ``band``. Bases are codes 0..3; every other code, the pad -1
among them, matches nothing, on either side; cells with ``j`` outside
``[0, tlen]`` are ``BIG``. (The counterpart lets two equal codes above 3
match. The encoding makes none, and the CUDA kernel keeps two bits of a
base, so here such a code is one more pad, in the kernel and in the plain
version alike.)

On a CUDA tensor ``edit_distance_banded`` launches the hand-written Hopper
kernel in ``csrc/edit_banded.cu`` (or raises): one thread per pair, the row
of the band as two bit masks of +1/-1 differences in registers (Myers'
bit-vector step in Hyyro's diagonal-band form), the template as bit planes,
so a row is word-wide logic and one add with carry. On a CPU tensor it runs
the plain PyTorch version ``edit_distance_banded_plain``, the same
recurrence cell by cell.
``edit_distance_banded.launches`` counts kernel launches. Like its
counterpart it has no call site in the pipeline: the subread-to-draft
alignments that drafting needs (with their paths) run in the host C++
aligner (``native/align.cpp``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

BIG = 1e7
_BIG_I = int(BIG)


def edit_distance_banded_plain(tpl, tlen, reads, rlens, band: int = 64):
    """Plain PyTorch version of the kernel, batched over pairs: a loop over
    read rows with state ``E [B, 2*band+1]`` (int32; every in-band value is
    an exact integer), rows past a pair's ``rlens`` frozen."""
    B, TMAX = tpl.shape
    RMAX = reads.shape[1]
    W = band
    KB = 2 * W + 1
    dev = tpl.device
    # the row-i slice starts at padded column i-1 and spans the whole band,
    # so the buffer must also cover reads longer than the template
    tall = max(TMAX, RMAX)
    tpl_pad = F.pad(tpl.to(torch.int32), (W, W + tall - TMAX), value=-1)
    reads = reads.to(torch.int32)
    tl = tlen.to(torch.int32)[:, None]
    rl = rlens.to(torch.int32)[:, None]
    k = torch.arange(KB, dtype=torch.int32, device=dev)[None, :]
    big = torch.full((), _BIG_I, dtype=torch.int32, device=dev)

    j0 = k - W                      # row 0: all-deletions to j = k - W
    E = torch.where((j0 >= 0) & (j0 <= tl), j0, big)
    n_rows = min(int(rlens.max()), RMAX) if B else 0
    for i in range(1, n_rows + 1):
        tseg = tpl_pad[:, i - 1:i - 1 + KB]     # template base at j - 1
        rbase = reads[:, i - 1:i]
        j = i + k - W
        in_tpl = (j >= 0) & (j <= tl)
        match = (tseg == rbase) & (tseg >= 0) & (tseg <= 3)
        diag = E + (~match).to(torch.int32)
        up = F.pad(E[:, 1:], (0, 1), value=_BIG_I) + 1      # E[i-1][k+1]
        u = torch.where(in_tpl, torch.minimum(diag, up), big)
        # deletion chain: min over k' <= k of u[k'] + (k - k')
        chain = torch.cummin(u - k, dim=1).values + k
        E = torch.where(i <= rl, torch.where(in_tpl, chain, big), E)
    k_end = tl - rl + W
    in_band = (k_end >= 0) & (k_end < KB)
    end = torch.gather(E, 1, k_end.clamp(0, KB - 1).long())
    return torch.where(in_band, end, big)[:, 0].to(torch.float32)


def _launch(tpl, tlen, reads, rlens, band: int):
    from ccs_tpu_torch.ops import _build
    dev = tpl.device
    if dev.type != "cuda":
        raise RuntimeError(f"the CUDA edit-distance kernel cannot run on "
                           f"{dev}")
    B, TMAX = tpl.shape
    RMAX = reads.shape[1]
    _build.check_tensor("tpl", tpl, torch.int8, (B, TMAX), dev)
    _build.check_tensor("tlen", tlen, torch.int32, (B,), dev)
    _build.check_tensor("reads", reads, torch.int8, (B, RMAX), dev)
    _build.check_tensor("rlens", rlens, torch.int32, (B,), dev)
    lib = _build.load_library()
    max_band = lib.ccs_edit_max_band()
    if not 0 <= band <= max_band:
        raise ValueError(f"band {band} is outside the kernel's range "
                         f"[0, {max_band}]")
    dist = torch.empty((B,), dtype=torch.float32, device=dev)
    if B == 0:
        return dist
    ptr = ctypes.c_void_p
    with torch.cuda.device(dev):
        rc = lib.ccs_edit_distance_banded(
            ptr(tpl.data_ptr()), ptr(tlen.data_ptr()), ptr(reads.data_ptr()),
            ptr(rlens.data_ptr()), ptr(dist.data_ptr()), B, TMAX, RMAX, band,
            ptr(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"ccs_edit_distance_banded failed: CUDA error {rc} "
                           f"({_build.error_string(rc)})")
    _build.count_launch(edit_distance_banded)
    return dist


def edit_distance_banded(tpl, tlen, reads, rlens, band: int = 64):
    """Banded global edit distance for B (read, template) pairs.

    ``tpl [B, TMAX]`` int8 (bases 0..3, -1 pad), ``tlen [B]`` int32,
    ``reads [B, RMAX]`` int8 (likewise), ``rlens [B]`` int32, all on one device -> ``dist [B]``
    float32 (see the module docstring). Kernel on CUDA tensors, plain
    version on CPU tensors."""
    if tpl.device.type == "cpu":
        return edit_distance_banded_plain(tpl, tlen, reads, rlens, band)
    return _launch(tpl, tlen, reads, rlens, band)


edit_distance_banded.launches = 0


def edit_distance_dense_oracle(a: np.ndarray, b: np.ndarray) -> int:
    """Dense Needleman-Wunsch edit distance (unit costs), the test oracle.
    One numpy pass per row of ``a``: the in-row gap chain
    ``cur[j] = min(cur[j], cur[j-1] + 1)`` is a prefix-min of ``u[j] - j``."""
    a, b = np.asarray(a), np.asarray(b)
    T = len(b)
    col = np.arange(T + 1, dtype=np.int64)
    prev = col.copy()
    for i in range(1, len(a) + 1):
        u = np.empty(T + 1, np.int64)
        u[0] = i
        u[1:] = np.minimum(prev[:-1] + (b != a[i - 1]), prev[1:] + 1)
        prev = np.minimum.accumulate(u - col) + col
    return int(prev[T])
