"""Batch engine: concatenate windows from many ZMWs into one device polish.

Counterpart of ``ccs_tpu.pipeline.engine.CcsEngine`` over a list of torch
devices (every visible CUDA device unless told otherwise). The host
prepares ZMWs (filters/draft/windows, ``pipeline.prepare``); windows across
the batch are flattened into fixed-shape chunks from the closed
(cfg.tpu_window_buckets x cfg.tpu_coverage_buckets) grid, each chunk is
sharded over the devices (``parallel.mesh.shard_fused_polish``), and the
results scatter back per ZMW for stitching.

With ``--tpu-dc-polish`` each shard's polish is followed by the learned
refinement (``models.dc_polisher.refine_chunk``) on the same device
tensors; its QVs for the rq stream come back with the chunk.

The device step is synchronous here (the polish loop's host condition
waits for the device every iteration), so chunks are packed, polished and
scattered back one after another on the calling thread, and only the
shards of a chunk run at once. The engine's ``telemetry`` recorder times
each stage (``pack``, ``device_step`` with its ``h2d``, ``sync`` and
``pull`` children, ``finalize``, and ``prepare`` in thread-seconds) and
counts the polish (``windows_polished``, ``polish_iterations``,
``windows_converged``); ``t_prepare``, ``t_device``, ``t_finalize``,
``polish_stats`` and ``dc_stats`` read it.
"""

from __future__ import annotations

import functools
import logging
from typing import Optional, Sequence

import numpy as np

from ccs_tpu_torch import telemetry
from ccs_tpu_torch.config import CcsConfig
from ccs_tpu_torch.models.chemistry import ArrowParams, default_params
from ccs_tpu_torch.pipeline.zmw import (ConsensusResult, ZmwInput,
                                        ZmwWorkItem, finalize_zmw)
from ccs_tpu_torch.statuses import ZmwStatus
from ccs_tpu_torch.ops.tables import params_to_torch
from ccs_tpu_torch.parallel.mesh import make_zmw_mesh, shard_fused_polish
from ccs_tpu_torch.pipeline.prepare import _load_control, prepare_many

logger = logging.getLogger("ccs_tpu")


class CcsEngine:
    """CCS engine over one set of Arrow parameters.

    ``device``: a torch device or a list of them, windows shard over the
    list; None means every visible CUDA device (raises without CUDA).
    ``cfg.tpu_mesh_shape`` takes the first prod(shape) of them."""

    def __init__(self, cfg: Optional[CcsConfig],
                 params: Optional[ArrowParams], device=None):
        self.cfg = (cfg or CcsConfig()).resolve_mode_all()
        devices = make_zmw_mesh(devices=device)
        if self.cfg.tpu_mesh_shape is not None:
            devices = devices[:int(np.prod(self.cfg.tpu_mesh_shape))]
        self.devices = devices
        self.n_dev = len(devices)
        self.device = devices[0]
        self.params = params or default_params()
        # the run's spans and counters; the span timeline only where a
        # profile is asked for
        self.telemetry = telemetry.Recorder(
            timeline=bool(self.cfg.tpu_profile_dir))
        # one table set per distinct device
        tables = {d: params_to_torch(self.params, d)
                  for d in dict.fromkeys(devices)}
        self.tables_per_device = [tables[d] for d in devices]
        self.tables = self.tables_per_device[0]
        self._dc_refine = None
        refine = None
        if self.cfg.tpu_dc_polish:
            self._dc_refine, refine = self._load_dc_refine()

        def _mk(sparse):
            return shard_fused_polish(
                devices, self.tables_per_device,
                max_iters=self.cfg.max_polish_iterations,
                thresh=self.cfg.tpu_polish_thresh,
                compact=self.cfg.tpu_tail_bucket > 0, sparse=sparse,
                refine=refine, rec=self.telemetry)
        # candidate-sparse step for default chunks; the dense step serves
        # --disable-heuristics / tandem-repeat ZMWs
        self._polish_step = _mk(sparse=True)
        self._polish_step_dense = _mk(sparse=False)
        self.control = _load_control(self.cfg)
        # window counts rounded up to a multiple of the device count
        self.w_buckets = tuple(sorted(-(-w // self.n_dev) * self.n_dev
                                      for w in self.cfg.tpu_window_buckets))
        cap = self.cfg.tpu_window_coverage_cap
        self.c_buckets = tuple(
            c for c in sorted(self.cfg.tpu_coverage_buckets) if c <= cap)
        if not self.c_buckets or self.c_buckets[-1] < cap:
            self.c_buckets = self.c_buckets + (cap,)

    @property
    def t_prepare(self) -> float:
        """Thread-seconds in prepare."""
        return self.telemetry.seconds("prepare")

    @property
    def t_device(self) -> float:
        """Seconds in the device step: from the step's call to the end of
        its pulls."""
        return self.telemetry.seconds("device_step")

    @property
    def t_finalize(self) -> float:
        """Seconds in host stitch/finalize."""
        return self.telemetry.seconds("finalize")

    @property
    def polish_stats(self) -> np.ndarray:
        """int64 [windows converged, polish iterations, yield bases]."""
        return self._counters("windows_converged", "polish_iterations",
                              "polish_yield_bases")

    @property
    def dc_stats(self) -> np.ndarray:
        """int64 [windows refined, processed, corrected, ZMWs with a
        processed window] of the --tpu-dc-polish stage."""
        return self._counters("dc_windows", "dc_processed", "dc_corrected",
                              "dc_zmws")

    def _counters(self, *names) -> np.ndarray:
        return np.array([self.telemetry.counter(n) for n in names], np.int64)

    def _load_dc_refine(self):
        """The learned refinement step from dc_model.npz in
        $SMRT_CHEMISTRY_BUNDLE_DIR, else the built-in model: (refine_chunk
        with the stage's thresholds bound, and that with each device's
        model and tables bound as well)."""
        import os
        from ccs_tpu_torch.models.dc_polisher import (DcModel, builtin_model,
                                                      refine_chunk)
        bundle = os.environ.get("SMRT_CHEMISTRY_BUNDLE_DIR")
        dc_path = bundle and os.path.join(bundle, "dc_model.npz")
        model = (DcModel.load(dc_path)
                 if dc_path and os.path.exists(dc_path)
                 else builtin_model())
        if model is None:
            # a user asking for the refinement stage must not silently get
            # unrefined output
            raise RuntimeError(
                "--tpu-dc-polish requested but no model is available: "
                "no built-in models/data/dc_v0.npz and no dc_model.npz "
                "in SMRT_CHEMISTRY_BUNDLE_DIR")
        logger.info("DC window refinement enabled (ctx=%d, conf=%.1f)",
                    model.ctx, model.conf)
        refine = functools.partial(
            refine_chunk, qv_thresh=self.cfg.tpu_dc_qv_thresh,
            conf_thresh=model.conf, allow_sub=bool(model.sub_ok),
            rec=self.telemetry)
        nets = {d: model.module(d) for d in dict.fromkeys(self.devices)}
        return refine, [functools.partial(refine, nets[d], model.ctx, t)
                        for d, t in zip(self.devices, self.tables_per_device)]

    def process_batch(self, zmws: Sequence[ZmwInput]) -> list[ConsensusResult]:
        """Process a batch of ZMWs end to end. Order-preserving."""
        return self.finalize_batch(self.prepare_batch(zmws))

    def prepare_batch(self, zmws: Sequence[ZmwInput]) -> list[ZmwWorkItem]:
        """Host phase: filters/draft/align/window for a batch."""
        with self.telemetry.span("prepare"):
            return prepare_many(zmws, self.cfg, self.params, self.control)

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
        rec = self.telemetry

        # rows (item, window index, n_cand) grouped by (coverage bucket,
        # exhaustive?): exhaustive chunks run the dense scorer, default
        # chunks the candidate-sparse one
        by_cb: dict[tuple[int, bool], list[tuple[ZmwWorkItem, int, int]]] = {}
        stage: dict[int, dict] = {}
        with rec.span("pack"):
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
                if self._dc_refine is not None:
                    stage[id(it)].update(
                        qv_rq=np.zeros((n, t_cap), np.float32),
                        dc_proc=np.zeros(n, bool))

        for (cb, exhaustive), rows in sorted(by_cb.items(),
                                             key=lambda kv: kv[0]):
            pos = 0
            while pos < len(rows):
                take = min(len(rows) - pos, self.w_buckets[-1])
                chunk = rows[pos:pos + take]
                pos += take
                with rec.span("pack"):
                    args = self._pack_chunk(chunk, cb, exhaustive)
                with rec.span("device_step"):
                    pulls = self._step_chunk(args, exhaustive)
                self._scatter_chunk(chunk, pulls, stage)

        with rec.span("finalize"):
            for it in live:
                st = stage[id(it)]
                try:
                    it.result = finalize_zmw(
                        it, st["tpl"], st["tlen"], st["cs"], st["ce"],
                        st["qv"], st["conv"], self.cfg,
                        qv_rq=st.get("qv_rq"))
                except Exception:  # noqa: BLE001
                    logger.exception("finalize failed for ZMW %s",
                                     it.zmw.hole)
                    it.result.status = ZmwStatus.EXCEPTION_THROWN
        if self._dc_refine is not None:
            # a ZMW is one item, or two under --by-strand / --hd-finder
            holes = {it.zmw.hole for it in live
                     if stage[id(it)]["dc_proc"].any()}
            rec.count("dc_zmws", len(holes))

    def _pack_chunk(self, chunk, c_pad: int, exhaustive: bool = False):
        """The padded bucket arrays of a chunk, the polish step's
        arguments; sorts ``chunk`` into their row order."""
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
        # JAX engine does; deterministic (stable sort), and _scatter_chunk
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
        return tpl, tlen, cs, ce, snr_bin, reads, rlens, is_first, priority

    def _step_chunk(self, args, exhaustive: bool) -> list[np.ndarray]:
        """Run the polish step on a packed chunk and pull its outputs:
        [stats, tpl, tlen, cs, ce, qv, active] (+ [qv_rq, processed,
        corrected] with --tpu-dc-polish)."""
        step = self._polish_step_dense if exhaustive else self._polish_step
        # with --tpu-dc-polish the step also runs the Revio-shaped learned
        # refinement of low-QV windows (revio.md:29-53) and returns
        # (qv_rq: the model's QVs for the rq stream, processed, corrected);
        # qv is then the Arrow re-score of the refined sequence
        state, qv, stats, *dc = step(*args)
        with self.telemetry.span("pull"):
            # one device -> host copy of everything the host needs
            return [t.cpu().numpy() for t in
                    (stats, state.tpl, state.tlen, state.core_start,
                     state.core_end, qv, state.active) + (dc[0] if dc else ())]

    def _scatter_chunk(self, chunk, pulls, stage: dict) -> None:
        """Count a polished chunk and write its rows back into ``stage``,
        per ZMW."""
        s, out_tpl, out_tlen, out_cs, out_ce, out_qv, nonconv = pulls[:7]
        dc = pulls[7:]
        rec = self.telemetry
        rec.count("windows_polished", len(chunk))
        # s: [n_converged, total_iters, yield_bases]
        rec.count("windows_converged", s[0])
        rec.count("polish_iterations", s[1])
        rec.count("polish_yield_bases", s[2])
        if dc:
            out_qv_rq, proc, corrected = dc
            rec.count("dc_windows", len(chunk))
            rec.count("dc_processed", proc.sum())
            rec.count("dc_corrected", corrected.sum())

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
            if dc:
                st["qv_rq"][ws] = out_qv_rq[rows]
                st["dc_proc"][ws] = proc[rows]
