"""The sparse scorer kernel against its bound, on the frozen production
window batch: launches queued back to back under ``torch.profiler`` (CUDA
activity only), the kernel's time per launch read from the device trace.

A per-kernel measurement: its input is the frozen batch, not the cell's
traffic, so it reads the same in every cell and is reported in one."""

from __future__ import annotations

import subprocess

import numpy as np

from ccsbench.frozen import scorer_batch as sb

LAUNCHES = 20


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


KERNEL = "score_kernel<true>"


def measure(seed: int, device) -> dict:
    """{"ms", "bound_ms", "bound_by", "card", ...} of ``score_sparse``;
    "ms" is None where the trace holds fewer kernel events than launches."""
    import torch
    from ccs_tpu_torch.models.chemistry import default_params
    from ccs_tpu_torch.ops import hmm_score
    from ccs_tpu_torch.ops.tables import params_to_torch
    arrs = sb.window_batch(np.random.default_rng([seed % (1 << 64), 9]))
    tables = params_to_torch(default_params(), device)
    tpl, tlen, snr_bin, reads, rlens, cand = (
        torch.from_numpy(a).to(device) for a in arrs)
    args = (tpl, tlen, snr_bin, reads, rlens, cand, tables)
    n0 = hmm_score.score_sparse.launches
    for _ in range(3):
        lls, ll0 = hmm_score.score_sparse(*args)
    torch.cuda.synchronize(device)
    from torch.profiler import ProfilerActivity, profile
    from ccsbench.harness import _device_events
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(LAUNCHES):
            hmm_score.score_sparse(*args)
        torch.cuda.synchronize(device)
    events = _device_events(prof)
    # the newest LAUNCHES of the kernel's events: a record of an earlier
    # launch still pending in the tracer would come before them
    ns = [b - a for a, b in sorted((a, b) for _d, name, a, b in events
                                   if KERNEL in name)][-LAUNCHES:]
    ms = sum(ns) / LAUNCHES * 1e-6 if len(ns) == LAUNCHES else None
    hmm_score.score_sparse.launches = n0
    nbytes = sum(t.numel() * t.element_size() for t in
                 (tpl, tlen, snr_bin, reads, rlens, cand, tables["ctx"],
                  tables["pw"], lls, ll0))
    b_ms, by = sb.bound_ms(sb.scorer_flops(arrs[1], arrs[4], arrs[5]),
                           nbytes)
    return {"ms": ms, "bound_ms": b_ms, "bound_by": by,
            "card": _power_limit(), "launches": LAUNCHES,
            "kernel_events": sum(KERNEL in e[1] for e in events),
            "device_events": len(events)}
