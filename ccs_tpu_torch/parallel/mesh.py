"""Device list + sharded polish step (counterpart of
``ccs_tpu.parallel.mesh``).

The reference's only parallelism is data parallelism over ZMWs (a thread
pool in a node, ``--chunk`` across nodes; parallelize.md:7-29). The JAX
package maps it onto a 1-D ``('zmw',)`` device mesh; here the mesh is a
list of torch devices. A window batch splits on its leading axis into
``len(devices)`` contiguous shards (as ``P("zmw")`` does), each shard runs
the single-device step (``parallel/step.py``) on its own device, parameter
tables are one copy per device, and the only reduction is the sum of the
summary counters, made on the host in int64 (the JAX engine's
``use_psum=False`` branch).

The polish loop reads the device once per iteration (``polish_fused``), so
shards overlap only when each has a thread of its own: each runs under
``torch.cuda.device(d)`` on a CUDA stream of its own, pulls its outputs to
the host inside that thread, and the caller concatenates numpy arrays. No
tensor crosses from one shard's stream to another's.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor, wait
from typing import Optional, Sequence

import numpy as np
import torch

from ccs_tpu_torch import telemetry
from ccs_tpu_torch.parallel.step import (make_polish_step, to_device,
                                         to_devices)


def make_zmw_mesh(n_devices: Optional[int] = None,
                  devices=None) -> list[torch.device]:
    """The devices windows shard over: ``devices`` (one or a list) as
    given, else every visible CUDA device (the first ``n_devices`` of
    them); raises when CUDA is absent and no devices were passed."""
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ccs_tpu_torch needs a CUDA device and "
                "torch.cuda.is_available() is False; pass device='cpu' (or "
                "a list of devices) to use the plain CPU path")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("no device to run on")
    return devices


def shard_slices(n_rows: int, n_shards: int) -> list[slice]:
    """Contiguous equal shards of the window axis; like the JAX mesh, the
    row count must divide by the shard count."""
    if n_rows % n_shards:
        raise ValueError(f"{n_rows} windows do not split into {n_shards} "
                         "equal shards")
    s = n_rows // n_shards
    return [slice(k * s, (k + 1) * s) for k in range(n_shards)]


def run_on_shards(devices: Sequence[torch.device], fn, shard_args) -> list:
    """``fn(k, *shard_args[k])`` for every shard k, each on a thread of its
    own under shard k's device and a CUDA stream from its pool that first
    waits for the device's default stream (tables and model weights are
    made there).
    Returns the results in shard order; raises the first shard's error
    after every shard has ended."""

    def one(k, args):
        d = devices[k]
        if d.type != "cuda":
            return fn(k, *args)
        with torch.cuda.device(d):
            stream = torch.cuda.Stream(d)
            stream.wait_stream(torch.cuda.default_stream(d))
            with torch.cuda.stream(stream):
                return fn(k, *args)

    with ThreadPoolExecutor(len(devices),
                            thread_name_prefix="ccs-shard") as pool:
        futs = [pool.submit(one, k, args)
                for k, args in enumerate(shard_args)]
        wait(futs)
    return [f.result() for f in futs]


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    return type(tree)(*map(_to_host, tree)) if hasattr(tree, "_fields") \
        else tuple(map(_to_host, tree))


def _concat(parts, sum_at: int):
    """Shard outputs (host trees of equal structure) joined on the window
    axis, except leaf ``sum_at`` of the top level (the counters), summed."""
    first = parts[0]
    if isinstance(first, np.ndarray):
        return torch.from_numpy(np.concatenate(parts))
    out = []
    for i, field in enumerate(zip(*parts)):
        if i == sum_at:
            out.append(torch.from_numpy(np.sum(field, axis=0,
                                               dtype=np.int64)))
        else:
            out.append(_concat(field, -1))
    return type(first)(*out) if hasattr(first, "_fields") else tuple(out)


def shard_fused_polish(devices, tables_per_device: Sequence[dict],
                       max_iters: int = 40, thresh: float = 0.02,
                       compact: bool = False, sparse: bool = False,
                       refine: Optional[Sequence] = None, rec=None):
    """Sharded fused polish step over ``devices`` — the product path.

    Returns fn(tpl, tlen, cs, ce, snr_bin, reads, rlens, is_first,
    priority) -> (state, qv, stats), stats = int64 [n_converged,
    total_iters, yield_bases] summed over the shards. Arguments are host
    arrays (split here) or per-shard lists from
    ``device_put_sharded_batch``. With one device and no ``refine`` it is
    ``make_polish_step``; with more, every output is a host tensor.

    ``refine`` (one callable per device, ``models.dc_polisher.refine_chunk``
    with its model and tables bound) runs on each shard right after its
    polish, on the same device tensors; fn then returns (state, qv, stats,
    (qv_rq, processed, corrected)) with the refined templates in state.

    ``rec``: the ``telemetry.Recorder`` that the steps' spans go to; with
    more than one device the shard threads record ``h2d``, ``sync`` and
    ``pull`` (the copy of their outputs to the host) in thread-seconds.
    """
    devices = [torch.device(d) for d in devices]
    steps = [make_polish_step(t, d, max_iters=max_iters, thresh=thresh,
                              compact=compact, sparse=sparse, rec=rec)
             for t, d in zip(tables_per_device, devices)]
    if refine is None and len(devices) == 1:
        return steps[0]

    def run(k, *args):
        args = to_devices(args, devices[k], rec)
        state, qv, stats = steps[k](*args)
        if refine is None:
            return state, qv, stats
        snr_bin, reads, rlens = args[4:7]
        ntpl, nlen, ncs, nce, qv, qv_rq, proc = refine[k](
            state, qv, reads, rlens, snr_bin)
        corrected = (ntpl != state.tpl).any(-1) | (nlen != state.tlen)
        state = state._replace(tpl=ntpl, tlen=nlen, core_start=ncs,
                               core_end=nce)
        return state, qv, stats, (qv_rq, proc, corrected)

    if len(devices) == 1:
        return lambda *args: run(0, *args)

    def pulled(k, *args):
        out = run(k, *args)
        with telemetry.span(rec, "pull"):
            return _to_host(out)

    def fn(*args):
        pieces = []
        for a in args:
            if isinstance(a, (list, tuple)):
                pieces.append(a)
            else:
                pieces.append([a[s] for s in shard_slices(len(a),
                                                          len(devices))])
        parts = run_on_shards(devices, pulled, list(zip(*pieces)))
        return _concat(parts, sum_at=2)

    return fn


def device_put_sharded_batch(devices, arrays: tuple) -> tuple:
    """Place host window arrays on the devices, split over axis 0: for each
    array, the list of its shards, shard k on ``devices[k]``."""
    devices = [torch.device(d) for d in devices]
    out = []
    for a in arrays:
        a = np.asarray(a)
        out.append([to_device(a[s], d) for s, d in
                    zip(shard_slices(len(a), len(devices)), devices)])
    return tuple(out)
