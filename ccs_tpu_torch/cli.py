"""ccs_tpu_torch command-line interface.

The same flags, outputs and reports as ``ccs_tpu.cli``, with the polish on
a torch device: ``python -m ccs_tpu_torch <in.subreads.bam>
<out.{bam,fastq.gz,consensusreadset.xml}>``. ``build_parser``,
``config_from_args``, ``iter_zmws``, ``result_to_record``, ``fail_record``
and ``run`` are copies of the JAX package's, which cannot be imported
without JAX. ``--tpu-profile-dir`` writes one Chrome trace of the run: the
card's activity (``torch.profiler``, CUDA only) and the program's spans
(``telemetry``) on one clock, and logs where the host was while the card
sat idle. A run shards its windows over every visible CUDA device;
``--tpu-num-hosts N --tpu-host-id i`` runs one host's share of a
multi-host run (``parallel.multihost``).
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import os
import sys
import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ccs_tpu_torch.config import CcsConfig
from ccs_tpu_torch.io.bam import (BamReader, BamRecord, BamWriter,
                                  make_ccs_header)
from ccs_tpu_torch.io.datasetxml import write_consensusreadset
from ccs_tpu_torch.io.fastq import FastqWriter
from ccs_tpu_torch.io.pbi import build_index_from_records, read_pbi, write_pbi
from ccs_tpu_torch.models.chemistry import load_model
from ccs_tpu_torch.pipeline.qvbin import bin_qvs
from ccs_tpu_torch.pipeline.zmw import ConsensusResult, Subread, ZmwInput
from ccs_tpu_torch.report.metrics import ProgressReporter, write_zmw_metrics
from ccs_tpu_torch.report.stats import (RunStats, format_ccs_report,
                                        format_ccs_report_strand,
                                        format_summary_log, hifi_summary_dict,
                                        report_json_dict)
from ccs_tpu_torch.statuses import ZmwStatus
from ccs_tpu_torch import __version__, telemetry
from ccs_tpu_torch.pipeline.engine import CcsEngine

logger = logging.getLogger("ccs_tpu")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ccs_tpu_torch",
        description="circular consensus sequencing (HiFi) engine on "
                    "PyTorch + CUDA")
    p.add_argument("input", help="subreads.bam (or - with --streamed)")
    p.add_argument("output", help="out.bam | out.fastq.gz | out.consensusreadset.xml")
    p.add_argument("--min-snr", type=float, default=2.5)
    p.add_argument("--min-passes", type=int, default=3)
    p.add_argument("--min-length", type=int, default=10)
    p.add_argument("--max-length", type=int, default=50000)
    p.add_argument("--min-rq", type=float, default=0.99)
    p.add_argument("--top-passes", type=int, default=60)
    p.add_argument("--max-insertion-size", type=int, default=30)
    p.add_argument("--min-tandem-repeat-length", type=int, default=1000)
    p.add_argument("--disable-heuristics", action="store_true")
    p.add_argument("--all", dest="mode_all", action="store_true")
    p.add_argument("--subread-fallback", action="store_true")
    p.add_argument("--by-strand", action="store_true")
    p.add_argument("--hd-finder", action="store_true")
    p.add_argument("--hifi-kinetics", action="store_true")
    p.add_argument("--all-kinetics", action="store_true")
    p.add_argument("--chunk", type=str, default=None, metavar="i/N")
    p.add_argument("-j", "--num-threads", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--input-buffer", type=int, default=4)
    p.add_argument("--streamed", action="store_true")
    p.add_argument("--fastq", type=str, default=None)
    p.add_argument("--bam", type=str, default=None)
    p.add_argument("--report-file", type=str, default=None)
    p.add_argument("--report-json", type=str, default=None)
    p.add_argument("--metrics-json", type=str, default=None)
    p.add_argument("--hifi-summary-json", type=str, default=None)
    p.add_argument("--suppress-reports", action="store_true")
    p.add_argument("--subsample-clr-perc", type=float, default=0.0)
    p.add_argument("--subsample-clr-file", type=str, default=None)
    p.add_argument("--log-level", type=str, default="WARN")
    p.add_argument("--log-file", type=str, default=None)
    p.add_argument("--stderr-json-log", action="store_true")
    p.add_argument("--refresh-rate", type=float, default=5.0)
    p.add_argument("--tpu-resume-dir", type=str, default=None,
                   help="checkpoint directory: batches write durably here "
                        "with a watermark; rerunning with the same dir "
                        "resumes after the last flushed batch")
    p.add_argument("--tpu-control-fasta", type=str, default=None,
                   help="spike-in control reference (fail-reads 0x2); "
                        "defaults to controls.fasta in "
                        "$SMRT_CHEMISTRY_BUNDLE_DIR if present")
    p.add_argument("--tpu-num-hosts", type=int, default=1,
                   help="multi-host scale-out: N hosts each polish chunk "
                        "i+1/N over a shared filesystem; host 0 merges")
    p.add_argument("--tpu-host-id", type=int, default=0,
                   help="this host's rank in 0..N-1 (with --tpu-num-hosts)")
    p.add_argument("--tpu-coordinator", type=str, default=None,
                   help="host:port of a torch.distributed (gloo) rendezvous "
                        "for the cross-host counter all-reduce; optional")
    p.add_argument("--tpu-stats-delta", type=str, default=None,
                   help=argparse.SUPPRESS)  # internal: multihost child dump
    p.add_argument("--tpu-profile-dir", type=str, default=None,
                   help="write a Chrome trace of the run (the card's "
                        "activity and the program's spans on one clock) "
                        "into this directory")
    p.add_argument("--tpu-dc-polish", action="store_true",
                   help="Revio-style learned refinement of low-QV windows "
                        "(revio.md:29-53); model from dc_model.npz in "
                        "$SMRT_CHEMISTRY_BUNDLE_DIR, else the built-in one")
    p.add_argument("--tpu-dc-qv-thresh", type=float, default=25.0,
                   help="mean-QV threshold under which a window counts as "
                        "low-quality for --tpu-dc-polish (default 25)")
    p.add_argument("--version", action="version", version=__version__)
    return p


def config_from_args(args: argparse.Namespace) -> CcsConfig:
    chunk = None
    if args.chunk:
        i, n = args.chunk.split("/")
        chunk = (int(i), int(n))
        if not (1 <= chunk[0] <= chunk[1]):
            raise SystemExit(f"invalid --chunk {args.chunk}")
    cfg = CcsConfig(
        min_snr=args.min_snr, min_passes=args.min_passes,
        min_length=args.min_length, max_length=args.max_length,
        min_rq=args.min_rq, top_passes=args.top_passes,
        max_insertion_size=args.max_insertion_size,
        min_tandem_repeat_length=args.min_tandem_repeat_length,
        disable_heuristics=args.disable_heuristics,
        mode_all=args.mode_all, subread_fallback=args.subread_fallback,
        by_strand=args.by_strand, hd_finder=args.hd_finder,
        hifi_kinetics=args.hifi_kinetics, all_kinetics=args.all_kinetics,
        chunk=chunk, num_threads=args.num_threads,
        batch_size=args.batch_size, input_buffer=args.input_buffer,
        streamed=args.streamed, output=args.output, fastq=args.fastq,
        bam=args.bam, report_file=args.report_file,
        report_json=args.report_json, metrics_json=args.metrics_json,
        hifi_summary_json=args.hifi_summary_json,
        suppress_reports=args.suppress_reports,
        subsample_clr_perc=args.subsample_clr_perc,
        subsample_clr_file=args.subsample_clr_file,
        log_level=args.log_level, log_file=args.log_file,
        stderr_json_log=args.stderr_json_log,
        tpu_profile_dir=args.tpu_profile_dir,
        tpu_dc_polish=args.tpu_dc_polish,
        tpu_dc_qv_thresh=args.tpu_dc_qv_thresh,
        refresh_rate=args.refresh_rate,
        tpu_control_fasta=args.tpu_control_fasta,
        tpu_resume_dir=args.tpu_resume_dir,
    )
    return cfg


def subread_from_record(rec: BamRecord) -> Subread:
    return Subread(
        seq=rec.seq,
        cx=int(rec.tag("cx", 0)),
        qs=int(rec.tag("qs", 0)),
        qe=int(rec.tag("qe", len(rec.seq))),
        ipd=rec.tag("ip"), pw=rec.tag("pw"),
    )


def iter_zmws(reader: BamReader, movie: str,
              hole_range: Optional[tuple[set, None]] = None,
              holes: Optional[set] = None) -> Iterator[ZmwInput]:
    """Group consecutive records by hole number into ZmwInputs."""
    cur_hole: Optional[int] = None
    cur_subs: list[Subread] = []
    cur_snr = np.zeros(4, dtype=np.float32)
    for rec in reader:
        hole = int(rec.tag("zm", -1))
        if holes is not None and hole not in holes:
            continue
        if hole != cur_hole:
            if cur_hole is not None and cur_subs:
                yield ZmwInput(cur_hole, movie, cur_subs, cur_snr)
            cur_hole, cur_subs = hole, []
            sn = rec.tag("sn")
            cur_snr = np.asarray(sn, np.float32) if sn is not None \
                else np.zeros(4, np.float32)
        cur_subs.append(subread_from_record(rec))
    if cur_hole is not None and cur_subs:
        yield ZmwInput(cur_hole, movie, cur_subs, cur_snr)


def result_to_record(res: ConsensusResult, rg_ids: dict[str, str]) -> BamRecord:
    """HiFi BAM record with the documented tag set (bam-output.md:7-30).

    ``rg_ids`` maps strand ("", "fwd", "rev") to read-group ID — three read
    groups in --hd-finder mode (mode-heteroduplex-filtering.md:41-51)."""
    rg_id = rg_ids.get(res.strand, rg_ids.get("", "ccstpu01"))
    name = f"{res.movie}/{res.hole}/ccs"
    if res.strand:
        name += f"/{res.strand}"
    binned = bin_qvs(res.qv)
    rec = BamRecord(name=name, seq=res.seq, qual=binned)
    rec.set_tag("np", "i", int(res.num_passes))
    rec.set_tag("ec", "f", float(round(res.effective_coverage, 3)))
    rec.set_tag("rq", "f", float(res.rq))
    rec.set_tag("zm", "i", int(res.hole))
    if res.snr is not None:
        rec.set_tag("sn", "B", np.asarray(res.snr, np.float32), "f")
    if res.adapter_info is not None:
        rec.set_tag("ac", "B", res.adapter_info.ac, "i")
        rec.set_tag("ma", "i", int(res.adapter_info.ma))
    if res.kinetics is not None:
        k = res.kinetics
        if res.strand:
            # single-strand read: native pw/ip tags (kinetics.md:27-31)
            rec.set_tag("ip", "B", k.fi, "C")
            rec.set_tag("pw", "B", k.fp, "C")
        else:
            rec.set_tag("fi", "B", k.fi, "C")
            rec.set_tag("fp", "B", k.fp, "C")
            rec.set_tag("fn", "i", int(k.fn))
            rec.set_tag("ri", "B", k.ri, "C")
            rec.set_tag("rp", "B", k.rp, "C")
            rec.set_tag("rn", "i", int(k.rn))
    elif res.sub_kinetics is not None:
        ip, pw = res.sub_kinetics
        rec.set_tag("ip", "B", ip, "C")
        rec.set_tag("pw", "B", pw, "C")
    rec.set_tag("RG", "Z", rg_id.encode())
    return rec


def fail_record(res: ConsensusResult,
                rg_ids: dict[str, str]) -> Optional[BamRecord]:
    """One ff-tagged representative per failed ZMW for fail_reads.bam
    (fail-reads.md:7-21): the consensus if one exists (e.g. below --min-rq,
    adapter classes, controls), else the median full-length subread (0x8).
    Returns None when the ZMW has no representative at all."""
    rep = res.seq if res.seq is not None else res.fail_rep
    if rep is None or len(rep) == 0:
        return None
    rg_id = rg_ids.get(res.strand, rg_ids.get("", "ccstpu01"))
    name = f"{res.movie}/{res.hole}/ccs"
    if res.strand:
        name += f"/{res.strand}"
    if res.qv is not None and len(res.qv) == len(rep):
        qual = bin_qvs(res.qv)
    else:
        qual = np.full(len(rep), 10.0, np.float32)  # '+' = QV10
    rec = BamRecord(name=name, seq=rep, qual=qual)
    rec.set_tag("ff", "i", int(res.ff))
    rec.set_tag("np", "i", int(res.num_passes))
    rec.set_tag("rq", "f", float(res.rq))
    rec.set_tag("zm", "i", int(res.hole))
    if res.snr is not None:
        rec.set_tag("sn", "B", np.asarray(res.snr, np.float32), "f")
    rec.set_tag("RG", "Z", rg_id.encode())
    return rec


def resolve_device(device=None) -> list[torch.device]:
    """The devices of a run: ``device`` (one or a list) as given, else
    every visible CUDA device; raises when CUDA is absent."""
    from ccs_tpu_torch.parallel.mesh import make_zmw_mesh
    return make_zmw_mesh(devices=device)


def _start_profiler():
    """A started torch.profiler over CUDA activity, or None when it cannot
    start: profiling is best-effort."""
    from torch.profiler import ProfilerActivity, profile
    try:
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    except Exception as exc:  # noqa: BLE001 — profiling is best-effort
        logger.warning("torch.profiler unavailable: %s", exc)
        return None
    return prof


def _device_events(prof) -> list[tuple]:
    """(device, stream, category, name, start ns, end ns) of every device
    event of a stopped profiler, on ``time.time_ns``'s clock; the category
    as ``export_chrome_trace`` names it (its events do not carry it in
    every torch version)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            name = e.name()
            cat = ("gpu_memcpy" if name.startswith("Memcpy") else
                   "gpu_memset" if name.startswith("Memset") else "kernel")
            a = int(e.start_ns())
            out.append((int(e.device_index()), int(e.device_resource_id()),
                        cat, name, a, a + int(e.duration_ns())))
    return out


def _write_profile(prof, rec: telemetry.Recorder, out_dir: str,
                   thread: str) -> None:
    """Stop ``prof`` (None: no device trace), write the run's Chrome trace
    into ``out_dir``, and log how each device's idle time divides among
    the spans of ``thread``, the thread that issued the device work."""
    t0 = time.perf_counter()
    events = []
    if prof is not None:
        prof.stop()
        events = _device_events(prof)
    t1 = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, time.strftime("ccs_tpu_torch_%Y%m%d_%H%M%S")
                        + f"_{os.getpid()}.trace.json")
    with open(path, "w") as fh:
        json.dump(telemetry.chrome_trace(rec, events), fh)
    spans = rec.timeline()
    logger.info("trace written to %s: %d device events (%.1f s to stop the "
                "profiler and read them), %d spans (%d dropped), %.1f s to "
                "write", path, len(events), t1 - t0, len(spans), rec.dropped,
                time.perf_counter() - t1)
    spans = [s._replace(start_ns=rec.to_wall_ns(s.start_ns),
                        end_ns=rec.to_wall_ns(s.end_ns))
             for s in spans if s.thread == thread]
    intervals: dict[int, list] = {}
    for dev, _stream, _cat, _name, a, b in events:
        intervals.setdefault(dev, []).append((a, b))
    idle = telemetry.idle_by_span(intervals, spans)
    logger.info("device idle by host span: %s", "; ".join(
        f"device {dev}: " + ", ".join(
            f"{name} {sec:.3f} s" for name, sec in
            sorted(by_name.items(), key=lambda kv: -kv[1]))
        for dev, by_name in sorted(idle.items()))
        or "no device activity recorded")


def run(argv: Optional[list[str]] = None, device=None) -> int:
    """One CLI run. ``device``: a torch device or a list of them; None
    means every visible CUDA device (raises without CUDA)."""
    args = build_parser().parse_args(argv)
    if args.tpu_num_hosts > 1 and args.tpu_stats_delta is None:
        from ccs_tpu_torch.parallel.multihost import run_multihost
        return run_multihost(args, list(argv or sys.argv[1:]),
                             functools.partial(run, device=device))
    devices = resolve_device(device)
    cfg = config_from_args(args)
    level = getattr(logging, cfg.log_level.upper(), logging.WARNING)
    log_kwargs = {"filename": cfg.log_file} if cfg.log_file \
        else {"stream": sys.stderr}
    logging.basicConfig(
        level=level, format="%(asctime)s %(levelname)s %(message)s",
        **log_kwargs)
    logging.getLogger().setLevel(level)  # basicConfig no-ops if configured
    if cfg.stderr_json_log:
        # structured log protocol (sqiie.md:46): one JSON object per line
        class _JsonFormatter(logging.Formatter):
            def format(self, record):
                return json.dumps({
                    "timestamp": self.formatTime(record),
                    "level": record.levelname,
                    "message": record.getMessage(),
                    "component": record.name,
                })
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_JsonFormatter())
        root = logging.getLogger()
        for h in list(root.handlers):
            if isinstance(h, logging.StreamHandler) and not cfg.log_file:
                root.removeHandler(h)
        root.addHandler(handler)

    out = cfg.output
    prefix = out
    for suffix in (".bam", ".fastq.gz", ".fq.gz", ".consensusreadset.xml"):
        if out.endswith(suffix):
            prefix = out[:-len(suffix)]
            break
    want_xml = out.endswith(".consensusreadset.xml")
    want_fastq_main = out.endswith((".fastq.gz", ".fq.gz"))
    bam_path = cfg.bam or (out if out.endswith(".bam")
                           else (prefix + ".bam" if want_xml else None))

    # --- input ---
    src = sys.stdin.buffer if (cfg.streamed or args.input == "-") else args.input
    if isinstance(src, str) and not os.path.exists(src):
        print(f"ccs_tpu ERROR: input file not found: {src}", file=sys.stderr)
        return 1
    reader = BamReader(src)
    movie = reader.header.movie_name() or "unknown_movie"
    chemistry = reader.header.chemistry()
    if chemistry is None:
        logger.error("input BAM has no chemistry information in @RG DS")
        return 1
    params = load_model(chemistry)
    logger.info("Using chemistry model %s", params.name)

    # --chunk via .pbi (parallelize.md:8-20)
    holes: Optional[set] = None
    total_zmws = None
    pbi_path = args.input + ".pbi" if isinstance(src, str) else None
    if pbi_path and os.path.exists(pbi_path):
        idx = read_pbi(pbi_path)
        uniq = idx.unique_zmws()
        total_zmws = len(uniq)
        if cfg.chunk:
            i, n = cfg.chunk
            lo, hi = idx.zmw_chunk_ranges(n)[i - 1]
            holes = set(int(h) for h in uniq[lo:hi])
            total_zmws = len(holes)
    elif cfg.chunk:
        logger.error("--chunk requires a .pbi index next to the input BAM")
        return 1

    engine = CcsEngine(cfg, params, devices)
    cfg = engine.cfg  # resolved (--all implications)
    logger.info("Polishing on %d device(s): %s", engine.n_dev,
                ", ".join(map(str, engine.devices)))
    stats = RunStats()
    # progress protocol is an INFO-level feature (reports-aux-files.md:175-177)
    progress = ProgressReporter(
        cfg.refresh_rate if level <= logging.INFO else 1e12,
        total_zmws, max(cfg.num_threads, 1))

    chem_ds = ";".join(f"{k}={v}" for k, v in chemistry.items())
    rg_ids: dict[str, str] = {}
    read_groups = []
    if not cfg.by_strand:
        rg_ids[""] = "ccstpu01"
        read_groups.append({"ID": "ccstpu01", "PL": "PACBIO", "PU": movie,
                            "DS": f"READTYPE=CCS;{chem_ds}"})
    if cfg.by_strand or cfg.hd_finder:
        # single-strand read groups (mode-heteroduplex-filtering.md:41-51)
        rg_ids["fwd"] = "ccstpu02"
        rg_ids["rev"] = "ccstpu03"
        read_groups.append({"ID": "ccstpu02", "PL": "PACBIO", "PU": movie,
                            "DS": f"READTYPE=CCS;STRAND=FORWARD;{chem_ds}"})
        read_groups.append({"ID": "ccstpu03", "PL": "PACBIO", "PU": movie,
                            "DS": f"READTYPE=CCS;STRAND=REVERSE;{chem_ds}"})
    header = make_ccs_header(movie, read_groups,
                             program_args=" ".join(argv or sys.argv[1:]),
                             version=__version__)

    bam_writer = BamWriter(bam_path, header) if bam_path else None
    # Revio layout: one fail_reads.bam per hifi BAM with ff-tagged
    # representatives (fail-reads.md:7-21, revio.md:61-76)
    fail_writer = BamWriter(f"{prefix}.fail_reads.bam", header) \
        if bam_path else None
    written_records: list[BamRecord] = []
    fastq_path = cfg.fastq or (out if want_fastq_main else None)
    fastq_writer = FastqWriter(fastq_path) if fastq_path else None

    # checkpoint/resume: durable per-batch temp writes + watermark (SURVEY §5)
    ckpt = None
    if cfg.tpu_resume_dir:
        from ccs_tpu_torch.pipeline.checkpoint import Checkpointer
        ckpt = Checkpointer(cfg.tpu_resume_dir, header)
        if ckpt.next_batch:
            stats.merge(ckpt.completed_stats())
            logger.info("Resuming: %d batches flushed, watermark hole %s",
                        ckpt.next_batch, ckpt.resume_hole)

    # C17 CLR subsampling: deterministic per-hole hash keeps the sampled set
    # stable across --chunk splits and reruns (changelog.md:28,37)
    clr_holes: list[int] = []

    def _clr_sampled(hole: int) -> bool:
        if cfg.subsample_clr_perc <= 0:
            return False
        h = (int(hole) * 2654435761) & 0xFFFFFFFF
        return h / 2**32 < cfg.subsample_clr_perc / 100.0

    def emit(results, n_in):
        # writer-thread stage (P4): BAM/FASTQ encode + stats, input order
        n_ccs = 0
        delta = RunStats(collect_metrics=stats.collect_metrics) if ckpt \
            else stats
        delta.add_zmws(n_in)
        batch_recs: list[BamRecord] = []
        batch_fails: list[BamRecord] = []
        last_hole = -1
        for res in results:
            delta.add(res)
            last_hole = max(last_hole, int(res.hole))
            if res.status == ZmwStatus.SUCCESS and not res.strand \
                    and _clr_sampled(res.hole):
                clr_holes.append(int(res.hole))
            if res.status in (ZmwStatus.SUCCESS, ZmwStatus.LOW_PASS_SHORTCUT) \
                    and res.seq is not None:
                n_ccs += 1
                rec = result_to_record(res, rg_ids)
                if ckpt:
                    batch_recs.append(rec)
                else:
                    if bam_writer:
                        bam_writer.write_record(rec)
                        written_records.append(rec)
                    if fastq_writer:
                        fastq_writer.write(rec.name, res.seq, bin_qvs(res.qv))
            else:
                frec = fail_record(res, rg_ids)
                if frec is not None:
                    if ckpt:
                        batch_fails.append(frec)
                    elif fail_writer is not None:
                        fail_writer.write_record(frec)
        if ckpt:
            ckpt.write_batch(batch_recs, batch_fails, delta, last_hole)
            stats.merge(delta)
        progress.update(n_in, n_ccs)

    zmw_stream = iter_zmws(reader, movie, holes=holes)
    if ckpt is not None and ckpt.resume_hole is not None:
        zmw_stream = (z for z in zmw_stream if not ckpt.should_skip(z.hole))
    from ccs_tpu_torch.pipeline.orchestrator import run_pipeline
    prof = (_start_profiler()
            if cfg.tpu_profile_dir and engine.device.type == "cuda" else None)
    try:
        run_pipeline(engine, zmw_stream, emit,
                     batch_size=cfg.batch_size, num_threads=cfg.num_threads,
                     input_buffer=cfg.input_buffer)
    finally:
        if cfg.tpu_profile_dir:
            _write_profile(prof, engine.telemetry, cfg.tpu_profile_dir,
                           threading.current_thread().name)
    reader.close()
    logger.info(telemetry.wall_split_format(),
                *engine.telemetry.wall_split())
    if cfg.tpu_dc_polish:
        logger.info("DC refinement: %d of %d windows processed, %d "
                    "corrected, in %d ZMWs", engine.dc_stats[1],
                    engine.dc_stats[0], engine.dc_stats[2],
                    engine.dc_stats[3])

    # --- outputs ---
    if ckpt is not None:
        # merge the durable batch files into the final outputs (the
        # reference's TMPDIR temp-write + merge, changelog.md:47)
        for rec in ckpt.iter_batch_records():
            if bam_writer:
                bam_writer.write_record(rec)
                written_records.append(rec)
            if fastq_writer:
                fastq_writer.write(rec.name, rec.seq, rec.qual)
        if fail_writer:
            for rec in ckpt.iter_batch_records(fail=True):
                fail_writer.write_record(rec)
    if bam_writer:
        voffs = list(bam_writer.voffsets)
        bam_writer.close()
        write_pbi(bam_path + ".pbi",
                  build_index_from_records(written_records, voffs))
    if fail_writer:
        fail_writer.close()
    if fastq_writer:
        fastq_writer.close()
    if want_xml:
        write_consensusreadset(out, bam_path, len(written_records),
                               sum(len(r.seq) for r in written_records))

    if cfg.subsample_clr_perc > 0 and isinstance(src, str):
        from ccs_tpu_torch.io.datasetxml import write_subreadset
        clr_xml = cfg.subsample_clr_file or f"{prefix}.subsampled.subreadset.xml"
        write_subreadset(clr_xml, os.path.abspath(src), sorted(set(clr_holes)))
        if pbi_path and os.path.exists(pbi_path):
            from ccs_tpu_torch.io.pbi import filter_pbi
            sub_idx = filter_pbi(read_pbi(pbi_path), set(clr_holes))
            write_pbi(clr_xml + ".pbi", sub_idx)
        logger.info("CLR subsample: %d productive ZMWs -> %s",
                    len(set(clr_holes)), clr_xml)

    if not cfg.suppress_reports or cfg.report_file:
        path = cfg.report_file or f"{prefix}.ccs_report.txt"
        with open(path, "w") as fh:
            if cfg.hd_finder:
                # two-column DS/SS reads variant
                # (mode-heteroduplex-filtering.md:85-117)
                fh.write(format_ccs_report_strand(stats, two_column=True))
            elif cfg.by_strand:
                # single-strand reads variant (mode-by-strand.md:58-89)
                fh.write(format_ccs_report_strand(stats, two_column=False))
            else:
                fh.write(format_ccs_report(stats))
    if cfg.report_json:
        with open(cfg.report_json, "w") as fh:
            json.dump(report_json_dict(stats), fh, indent=2)
    if not cfg.suppress_reports or cfg.metrics_json:
        path = cfg.metrics_json or f"{prefix}.zmw_metrics.json.gz"
        write_zmw_metrics(path, stats)
    if cfg.hifi_summary_json:
        with open(cfg.hifi_summary_json, "w") as fh:
            json.dump(hifi_summary_dict(stats), fh, indent=2)
    if args.tpu_stats_delta:
        from ccs_tpu_torch.pipeline.checkpoint import stats_delta_dict
        with open(args.tpu_stats_delta, "w") as fh:
            json.dump(stats_delta_dict(stats), fh)
    if ckpt is not None:
        ckpt.cleanup()  # run completed; temp batches are merged
    if level <= logging.INFO:
        print(format_summary_log(
            stats, strand_aware=cfg.by_strand or cfg.hd_finder),
            file=sys.stderr)
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
