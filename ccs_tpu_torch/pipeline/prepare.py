"""Host prepare for a batch of ZMWs: filters, draft, windowing.

A copy of ``prepare_many`` and ``_load_control`` from
``ccs_tpu.pipeline.engine`` (that module imports JAX at load, so it cannot
be imported here). This module imports neither torch nor JAX: the
orchestrator's spawned prepare workers import it, and must stay off the
device runtime.
"""

from __future__ import annotations

import logging
import time
from typing import Sequence

from ccs_tpu.config import CcsConfig
from ccs_tpu.pipeline.zmw import (ConsensusResult, ZmwInput, ZmwWorkItem,
                                  prepare_zmw)
from ccs_tpu.statuses import ZmwStatus

logger = logging.getLogger("ccs_tpu")


def _load_control(cfg: CcsConfig):
    """Spike-in control reference: --tpu-control-fasta, or controls.fasta in
    the injected chemistry bundle (chemistry.md:32-41 mechanism)."""
    import os
    path = cfg.tpu_control_fasta
    if not path:
        bundle = os.environ.get("SMRT_CHEMISTRY_BUNDLE_DIR")
        if bundle and os.path.exists(os.path.join(bundle, "controls.fasta")):
            path = os.path.join(bundle, "controls.fasta")
    if not path:
        return None
    from ccs_tpu.io.fastq import read_fasta
    seqs = read_fasta(path)
    if not seqs:
        return None
    logger.info("Loaded spike-in control reference from %s", path)
    return next(iter(seqs.values()))


def prepare_many(zmws: Sequence[ZmwInput], cfg: CcsConfig, params,
                 control) -> list[ZmwWorkItem]:
    """Host prepare for a batch — a PURE function of (zmws, cfg, params,
    control) so the orchestrator can run it in worker PROCESSES."""
    work: list[tuple[ZmwInput, str]] = []
    for z in zmws:
        if cfg.by_strand:
            from ccs_tpu.pipeline.zmw import split_by_strand
            f, r = split_by_strand(z)
            work.append((f, "fwd"))
            work.append((r, "rev"))
        else:
            work.append((z, ""))

    items: list[ZmwWorkItem] = []
    for z, strand in work:
        try:
            item = prepare_zmw(z, cfg, params.snr_edges,
                               control=control, params=params)
        except Exception:  # noqa: BLE001 — failures are data (SURVEY §5)
            logger.exception("prepare failed for ZMW %s", z.hole)
            res = ConsensusResult(hole=z.hole, movie=z.movie,
                                  status=ZmwStatus.EXCEPTION_THROWN)
            item = ZmwWorkItem(z, res, None)
        if (cfg.hd_finder and not strand
                and item.result.status == ZmwStatus.HETERODUPLEXES):
            # --hd-finder: split the heteroduplex ZMW on the fly into
            # single-strand runs (mode-heteroduplex-filtering.md:25-39)
            from ccs_tpu.pipeline.zmw import split_by_strand
            import dataclasses as _dc
            ss_cfg = _dc.replace(cfg, by_strand=True, hd_finder=False)
            for zz, ss in zip(split_by_strand(z), ("fwd", "rev")):
                try:
                    ss_item = prepare_zmw(zz, ss_cfg, params.snr_edges,
                                          control=control, params=params)
                except Exception:  # noqa: BLE001
                    logger.exception("ss prepare failed for ZMW %s", z.hole)
                    ss_res = ConsensusResult(
                        hole=z.hole, movie=z.movie,
                        status=ZmwStatus.EXCEPTION_THROWN)
                    ss_item = ZmwWorkItem(zz, ss_res, None)
                ss_item.result.strand = ss
                items.append(ss_item)
            continue
        item.result.strand = strand
        items.append(item)
    return items


def prepare_task(zmws, cfg, params, control):
    """Process-pool task: (items, seconds spent)."""
    t0 = time.monotonic()
    items = prepare_many(zmws, cfg, params, control)
    return items, time.monotonic() - t0
