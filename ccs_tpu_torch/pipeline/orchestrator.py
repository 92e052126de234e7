"""Host/device pipelining for the PyTorch engine.

A copy of ``ccs_tpu.pipeline.orchestrator`` (see it for the design): a
reader thread, a spawn-context prepare process pool, the engine's device
phase on the calling thread and a writer thread, in input order end to end.
The copy exists because the original imports the JAX engine at load. Here
the prepare workers run ``ccs_tpu_torch.pipeline.prepare.prepare_task``,
whose module imports neither torch nor JAX, so the workers never load the
device runtime.

Each stage is timed on the engine's ``telemetry`` recorder: ``read`` (the
reader filling a batch), ``pipeline`` (the calling thread's loop) with its
``prepare_wait`` (waiting for a batch's prepare), the engine's device
phase and ``handoff_wait`` (waiting for room in the writer's queue), and
``write`` (the writer's ``emit``).
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import TYPE_CHECKING, Callable, Iterable

from ccs_tpu_torch.pipeline.zmw import ConsensusResult, ZmwInput
from ccs_tpu_torch.pipeline.prepare import prepare_task

if TYPE_CHECKING:
    from ccs_tpu_torch.pipeline.engine import CcsEngine

_DONE = object()

# cached spawn-based prepare pool (created once per process; spawn, not
# fork, because the main process holds a multithreaded device runtime)
_PROC_POOL = None
_PROC_POOL_SIZE = 0


def _get_proc_pool(n: int):
    global _PROC_POOL, _PROC_POOL_SIZE
    if _PROC_POOL is not None and _PROC_POOL_SIZE == n:
        return _PROC_POOL
    if _PROC_POOL is not None:
        _PROC_POOL.shutdown(wait=False)
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    _PROC_POOL = ProcessPoolExecutor(n, mp_context=mp.get_context("spawn"))
    _PROC_POOL_SIZE = n
    return _PROC_POOL


def shutdown_pool() -> None:
    """Stop the cached prepare workers (they otherwise live until exit)."""
    global _PROC_POOL, _PROC_POOL_SIZE
    if _PROC_POOL is not None:
        _PROC_POOL.shutdown(wait=True)
    _PROC_POOL = None
    _PROC_POOL_SIZE = 0


def run_pipeline(engine: "CcsEngine",
                 zmw_iter: Iterable[ZmwInput],
                 emit: Callable[[list[ConsensusResult], int], None],
                 batch_size: int = 1024,
                 num_threads: int = 0,
                 input_buffer: int = 4) -> None:
    """Stream ZMWs through the engine with reader/prepare/writer overlap.

    ``emit(results, n_zmws_in)`` is called on the writer thread, in input
    order, once per batch. Exceptions from any stage propagate to the
    caller after the pipeline drains.
    """
    rec = engine.telemetry
    n_threads = num_threads if num_threads > 0 else (os.cpu_count() or 1)
    depth = max(1, input_buffer)
    in_q: queue.Queue = queue.Queue(maxsize=depth)
    prep_q: queue.Queue = queue.Queue(maxsize=depth)
    out_q: queue.Queue = queue.Queue(maxsize=depth)
    errors: list[BaseException] = []

    def _signal_done(q: queue.Queue):
        """Deliver the sentinel no matter what: block politely while the
        pipeline is healthy; once an error is recorded the consumer may be
        dead, so force room (dropping queued work is fine — the run is
        failing anyway). A failed stage must never leave its consumer
        blocked forever."""
        while True:
            try:
                q.put(_DONE, timeout=0.2)
                return
            except queue.Full:
                if errors:
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        pass

    def guard(fn, downstream: queue.Queue = None):
        def wrapped(*a):
            try:
                fn(*a)
            except BaseException as exc:  # noqa: BLE001
                errors.append(exc)
            finally:
                if downstream is not None:
                    _signal_done(downstream)
        return wrapped

    def reader():
        zmws = iter(zmw_iter)
        while not errors:
            with rec.span("read"):
                batch = list(itertools.islice(zmws, batch_size))
            if not batch:
                return
            in_q.put(batch)

    use_procs = bool(getattr(engine.cfg, "tpu_prepare_processes", False)) \
        and n_threads > 1

    def preparer():
        # split each batch into contiguous sub-chunks across the pool
        # (order-preserving), forward the future list in order. Process
        # workers (default) sidestep the GIL serialization of prepare's
        # Python share (~40% of thread-pool wall at -j2, measured); the
        # thread pool remains as the fallback (tpu_prepare_processes=0).
        if use_procs:
            pool = _get_proc_pool(n_threads)

            def submit(chunk):
                global _PROC_POOL
                try:
                    return pool.submit(prepare_task, chunk, engine.cfg,
                                       engine.params, engine.control)
                except Exception:  # noqa: BLE001 — broken pool: one rebuild
                    _PROC_POOL = None
                    fresh = _get_proc_pool(n_threads)
                    return fresh.submit(prepare_task, chunk, engine.cfg,
                                        engine.params, engine.control)

            def run():
                while True:
                    batch = in_q.get()
                    if batch is _DONE:
                        break
                    if errors:
                        return
                    step = max(1, -(-len(batch) // n_threads))
                    futs = [submit(batch[i:i + step])
                            for i in range(0, len(batch), step)]
                    prep_q.put((futs, len(batch)))
            run()
        else:
            with ThreadPoolExecutor(max_workers=n_threads) as tpool:
                while True:
                    batch = in_q.get()
                    if batch is _DONE:
                        break
                    if errors:
                        return
                    step = max(1, -(-len(batch) // n_threads))
                    futs = [tpool.submit(engine.prepare_batch,
                                         batch[i:i + step])
                            for i in range(0, len(batch), step)]
                    prep_q.put((futs, len(batch)))

    def writer():
        while True:
            got = out_q.get()
            if got is _DONE:
                return
            results, n_in = got
            with rec.span("write"):
                emit(results, n_in)

    stages = [(reader, in_q), (preparer, prep_q), (writer, None)]
    threads = [threading.Thread(target=guard(fn, q), daemon=True,
                                name=f"ccs-{fn.__name__}")
               for fn, q in stages]
    for t in threads:
        t.start()

    def next_batch():
        """The next prepared batch (items, ZMWs in), or None at the end."""
        got = prep_q.get()
        if got is _DONE or errors:
            return None
        futs, n_in = got
        items = []
        for f in futs:
            r = f.result()
            if isinstance(r, tuple):   # process worker: (items, dt)
                part, dt = r
                rec.add_time("prepare", dt)
                items.extend(part)
            else:
                items.extend(r)
        return items, n_in

    try:
        with rec.span("pipeline"):
            while True:
                with rec.span("prepare_wait"):
                    got = next_batch()
                if got is None:
                    break
                items, n_in = got
                results = engine.finalize_batch(items)
                with rec.span("handoff_wait"):
                    while not errors:  # don't block forever on a dead writer
                        try:
                            out_q.put((results, n_in), timeout=1.0)
                            break
                        except queue.Full:
                            continue
    finally:
        _signal_done(out_q)
        # unblock producers stuck on full queues, then join
        for q in (in_q, prep_q):
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        for t in threads:
            t.join(timeout=60.0)
    if errors:
        raise errors[0]
