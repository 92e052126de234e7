"""Single-device polish step (counterpart of the n_dev == 1 path of
``ccs_tpu.parallel.mesh.shard_fused_polish``).

``make_polish_step(...)`` returns fn(tpl, tlen, cs, ce, snr_bin, reads,
rlens, is_first, priority) -> (state, qv, stats) with stats = int64
[n_converged, total_iters, yield_bases]. Host arrays are staged through
pinned memory and copied to the device without blocking (an ``h2d`` span of
the step's recorder); tensors already on the device pass through.
"""

from __future__ import annotations

import numpy as np
import torch

from ccs_tpu_torch import telemetry
from ccs_tpu_torch.pipeline.polish_fused import polish_windows_fused


def to_device(a, device: torch.device) -> torch.Tensor:
    """A host array or tensor on ``device``; host data is copied through a
    pinned buffer with a non-blocking copy when the device is a GPU."""
    t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(
        a, np.ndarray) else a
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def to_devices(arrays, device: torch.device, rec=None) -> tuple:
    """``to_device`` of each array, timed as one ``h2d`` span of ``rec``
    where any of them is not on ``device`` yet."""
    if all(isinstance(a, torch.Tensor) and a.device == device
           for a in arrays):
        return tuple(arrays)
    with telemetry.span(rec, "h2d"):
        return tuple(to_device(a, device) for a in arrays)


def make_polish_step(tables: dict, device, max_iters: int = 40,
                     thresh: float = 0.02, compact: bool = False,
                     sparse: bool = False, rec=None):
    """``rec``: the ``telemetry.Recorder`` the step's spans go to."""
    device = torch.device(device)

    def step(tpl, tlen, cs, ce, snr_bin, reads, rlens, is_first, priority):
        tpl, tlen, cs, ce, snr_bin, reads, rlens, is_first, priority = \
            to_devices((tpl, tlen, cs, ce, snr_bin, reads, rlens, is_first,
                        priority), device, rec)
        state, qv, _p_err = polish_windows_fused(
            tpl, tlen, cs, ce, snr_bin, reads, rlens, tables,
            max_iters=max_iters, is_first=is_first, priority=priority,
            thresh=thresh, compact=compact, sparse=sparse, rec=rec)
        live = (rlens >= 0).any(-1)
        n_conv = ((~state.active) & live).sum()
        total_iters = state.n_iter.sum()
        yield_bases = torch.where(
            live, torch.clamp(state.core_end - state.core_start, min=0),
            0).sum()
        stats = torch.stack([n_conv, total_iters, yield_bases]).to(torch.int64)
        return state, qv, stats

    return step
