"""Batch engine: concatenate windows from many ZMWs into one device polish.

Counterpart of ``ccs_tpu.pipeline.engine.CcsEngine`` on one torch device.
The host prepares ZMWs (filters/draft/windows, ``pipeline.prepare``);
windows across the batch are flattened into fixed-shape chunks from the
closed (cfg.tpu_window_buckets x cfg.tpu_coverage_buckets) grid, polished on
the device, and scattered back per ZMW for stitching.

The device step is synchronous here (the polish loop's host condition
waits for the device every iteration), so chunks are submitted and
collected one after another on the calling thread: ``t_busy`` and
``t_device`` both measure the wall time spent in the device step.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ccs_tpu_torch.config import CcsConfig
from ccs_tpu_torch.models.chemistry import ArrowParams, default_params
from ccs_tpu_torch.pipeline.zmw import (ConsensusResult, ZmwInput,
                                        ZmwWorkItem, finalize_zmw)
from ccs_tpu_torch.statuses import ZmwStatus
from ccs_tpu_torch.ops.tables import params_to_torch
from ccs_tpu_torch.parallel.step import make_polish_step
from ccs_tpu_torch.pipeline.prepare import _load_control, prepare_many

logger = logging.getLogger("ccs_tpu")


class CcsEngine:
    """CCS engine over one set of Arrow parameters on one torch device."""

    def __init__(self, cfg: Optional[CcsConfig],
                 params: Optional[ArrowParams], device):
        self.cfg = (cfg or CcsConfig()).resolve_mode_all()
        if self.cfg.tpu_dc_polish:
            raise NotImplementedError(
                "--tpu-dc-polish is not ported to ccs_tpu_torch yet")
        if (self.cfg.tpu_mesh_shape is not None
                and int(np.prod(self.cfg.tpu_mesh_shape)) > 1):
            raise NotImplementedError(
                "a --tpu-mesh-shape of more than one device is not ported "
                "to ccs_tpu_torch yet")
        self.device = torch.device(device)
        self.params = params or default_params()
        self.tables = params_to_torch(self.params, self.device)

        def _mk(sparse):
            return make_polish_step(
                self.tables, self.device,
                max_iters=self.cfg.max_polish_iterations,
                thresh=self.cfg.tpu_polish_thresh,
                compact=self.cfg.tpu_tail_bucket > 0, sparse=sparse)
        # candidate-sparse step for default chunks; the dense step serves
        # --disable-heuristics / tandem-repeat ZMWs
        self._polish_step = _mk(sparse=True)
        self._polish_step_dense = _mk(sparse=False)
        self.control = _load_control(self.cfg)
        self.polish_stats = np.zeros(3, np.int64)
        self._t_lock = threading.Lock()
        self.t_prepare = 0.0   # thread-seconds in prepare
        self.t_device = 0.0    # seconds in the device step
        self.t_finalize = 0.0  # seconds in host stitch/finalize
        self.t_busy = 0.0      # seconds with a chunk on the device
        self.w_buckets = tuple(sorted(self.cfg.tpu_window_buckets))
        cap = self.cfg.tpu_window_coverage_cap
        self.c_buckets = tuple(
            c for c in sorted(self.cfg.tpu_coverage_buckets) if c <= cap)
        if not self.c_buckets or self.c_buckets[-1] < cap:
            self.c_buckets = self.c_buckets + (cap,)

    def process_batch(self, zmws: Sequence[ZmwInput]) -> list[ConsensusResult]:
        """Process a batch of ZMWs end to end. Order-preserving."""
        return self.finalize_batch(self.prepare_batch(zmws))

    def prepare_batch(self, zmws: Sequence[ZmwInput]) -> list[ZmwWorkItem]:
        """Host phase: filters/draft/align/window for a batch."""
        t0 = time.monotonic()
        try:
            return prepare_many(zmws, self.cfg, self.params, self.control)
        finally:
            with self._t_lock:
                self.t_prepare += time.monotonic() - t0

    def finalize_batch(self, items: list[ZmwWorkItem]) -> list[ConsensusResult]:
        """Device phase + stitch: polish all live items, return results."""
        live = [it for it in items if not it.terminal]
        if live:
            self._polish_live(live)
        results = [it.result for it in items]
        for res in results:
            if res.is_control:
                # spike-in controls never count as HiFi yield
                from ccs_tpu_torch.pipeline.adapters import FF_CONTROL
                res.ff |= FF_CONTROL
                res.status = (ZmwStatus.CONTROL_SUCCESS
                              if res.status == ZmwStatus.SUCCESS
                              else ZmwStatus.CONTROL_FAILURE)
        return results

    # -- device phase --
    def _c_bucket(self, c: int) -> int:
        for cb in self.c_buckets:
            if c <= cb:
                return cb
        logger.warning(
            "window coverage %d exceeds tpu_window_coverage_cap %d; "
            "extra passes are dropped for polishing (raise the cap or "
            "--top-passes to keep them)", c, self.c_buckets[-1])
        return self.c_buckets[-1]

    def _polish_live(self, live: list[ZmwWorkItem]) -> None:
        """Flatten windows into fixed-shape bucketed chunks, polish them,
        scatter results back per ZMW, finalize."""
        cfg = self.cfg
        t_cap = cfg.tpu_window_tpl_cap

        # rows (item, window index, n_cand) grouped by (coverage bucket,
        # exhaustive?): exhaustive chunks run the dense scorer, default
        # chunks the candidate-sparse one
        by_cb: dict[tuple[int, bool], list[tuple[ZmwWorkItem, int, int]]] = {}
        stage: dict[int, dict] = {}
        for it in live:
            b = it.batch
            exhaustive = (cfg.disable_heuristics
                          or it.result.has_tandem_repeat)
            cb = self._c_bucket(int(b.reads.shape[1]))
            rows = by_cb.setdefault((cb, exhaustive), [])
            ncand = (b.priority > 0).sum(axis=1)
            for w in range(len(b.windows)):
                rows.append((it, w, int(ncand[w])))
            n = len(b.windows)
            stage[id(it)] = {
                "tpl": np.full((n, t_cap), -1, np.int8),
                "tlen": np.ones(n, np.int32),
                "cs": np.zeros(n, np.int32),
                "ce": np.zeros(n, np.int32),
                "qv": np.zeros((n, t_cap), np.float32),
                "conv": np.ones(n, bool),
            }

        for (cb, exhaustive), rows in sorted(by_cb.items(),
                                             key=lambda kv: kv[0]):
            pos = 0
            while pos < len(rows):
                take = min(len(rows) - pos, self.w_buckets[-1])
                chunk = rows[pos:pos + take]
                pos += take
                self._collect_chunk(self._submit_chunk(chunk, cb, exhaustive),
                                    stage)

        t0 = time.monotonic()
        for it in live:
            st = stage[id(it)]
            try:
                it.result = finalize_zmw(
                    it, st["tpl"], st["tlen"], st["cs"], st["ce"],
                    st["qv"], st["conv"], self.cfg)
            except Exception:  # noqa: BLE001
                logger.exception("finalize failed for ZMW %s", it.zmw.hole)
                it.result.status = ZmwStatus.EXCEPTION_THROWN
        self.t_finalize += time.monotonic() - t0

    def _submit_chunk(self, chunk, c_pad: int, exhaustive: bool = False):
        """Build the padded bucket arrays and run the polish step; returns
        a handle for _collect_chunk."""
        cfg = self.cfg
        t_cap = cfg.tpu_window_tpl_cap
        r_cap = cfg.tpu_window_read_cap
        W = next(wb for wb in self.w_buckets if wb >= len(chunk))

        tpl = np.full((W, t_cap), -1, np.int8)
        tlen = np.ones(W, np.int32)
        cs = np.zeros(W, np.int32)
        ce = np.zeros(W, np.int32)
        snr_bin = np.zeros(W, np.int32)
        reads = np.full((W, c_pad, r_cap), -1, np.int8)
        rlens = np.full((W, c_pad), -1, np.int32)
        is_first = np.zeros(W, dtype=bool)
        priority = np.zeros((W, t_cap), np.float32)

        # sort rows by (coverage, candidate count, template length), as the
        # JAX engine does; deterministic (stable sort), and _collect_chunk
        # scatters back by the same list
        chunk.sort(key=lambda row: (min(row[0].batch.reads.shape[1], c_pad),
                                    row[2],
                                    int(row[0].batch.tlen[row[1]])))
        by_item: dict[int, list[int]] = {}
        for i, (it, w, _nc) in enumerate(chunk):
            by_item.setdefault(id(it), []).append(i)
            is_first[i] = (w == 0)
        for rows_l in by_item.values():
            rows = np.asarray(rows_l, np.intp)
            it = chunk[rows_l[0]][0]
            b = it.batch
            ws = np.asarray([chunk[i][1] for i in rows_l], np.intp)
            cc = min(b.reads.shape[1], c_pad)
            tpl[rows] = b.tpl[ws]
            tlen[rows] = b.tlen[ws]
            cs[rows] = b.core_start[ws]
            ce[rows] = b.core_end[ws]
            snr_bin[rows] = it.snr_bin
            reads[rows, :cc] = b.reads[ws, :cc]
            rlens[rows, :cc] = b.rlens[ws, :cc]
            if exhaustive:
                priority[rows] = 1.0
            else:
                priority[rows] = b.priority[ws]

        step = self._polish_step_dense if exhaustive else self._polish_step
        t0 = time.monotonic()
        state, qv, stats = step(
            tpl, tlen, cs, ce, snr_bin, reads, rlens, is_first, priority)
        return chunk, state, qv, stats, t0

    def _collect_chunk(self, handle, stage: dict) -> None:
        chunk, state, qv, stats, t0 = handle
        # one device -> host copy of everything the host needs
        s, out_tpl, out_tlen, out_cs, out_ce, out_qv, nonconv = (
            t.cpu().numpy() for t in (stats, state.tpl, state.tlen,
                                      state.core_start, state.core_end, qv,
                                      state.active))
        dt = time.monotonic() - t0
        with self._t_lock:
            self.t_device += dt
            self.t_busy += dt
            self.polish_stats += s  # [n_converged, total_iters, yield_bases]

        by_item: dict[int, list[int]] = {}
        for i, (it, _w, _nc) in enumerate(chunk):
            by_item.setdefault(id(it), []).append(i)
        for key, rows_l in by_item.items():
            st = stage[key]
            rows = np.asarray(rows_l, np.intp)
            ws = np.asarray([chunk[i][1] for i in rows_l], np.intp)
            st["tpl"][ws] = out_tpl[rows]
            st["tlen"][ws] = out_tlen[rows]
            st["cs"][ws] = out_cs[rows]
            st["ce"][ws] = out_ce[rows]
            st["qv"][ws] = out_qv[rows]
            st["conv"][ws] = ~nonconv[rows]
