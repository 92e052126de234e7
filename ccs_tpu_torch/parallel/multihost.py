"""Multi-host execution (counterpart of ``ccs_tpu.parallel.multihost``).

The reference scales out with N independent processes over ``--chunk i/N``
and offline merging (parallelize.md:7-29), with no runtime communication
backend at all. This keeps that shape: every host runs the same program on
its own .pbi-derived chunk with its own local devices, writes its records
to a per-host temp BAM, and host 0 merges (records + summary-stat deltas)
into the final outputs. With a coordinator, ``torch.distributed`` joins the
hosts in a gloo process group, which carries a cross-host sum of the yield
counters as a sanity mirror of the file merge; without one (or when the
rendezvous fails), coordination is purely filesystem-based: the
reference's own contract, and what keeps chunks independently restartable.

Usage (one process per host, shared filesystem):

    python -m ccs_tpu_torch in.bam out.bam --tpu-num-hosts 4 \\
        --tpu-host-id 2 [--tpu-coordinator host:port]

Host i processes chunk i+1/N; host 0 waits for every host's sentinel and
merges. The merged output equals a single-host run record for record
because ZMWs stream in hole order within each chunk and chunks partition
the hole space in order.
"""

from __future__ import annotations

import array
import dataclasses
import json
import logging
import os
import time
from typing import Optional

import numpy as np

logger = logging.getLogger("ccs_tpu")

_SENTINEL = "{prefix}.host{i}of{n}.done"
_HOST_BAM = "{prefix}.host{i}of{n}.bam"
_HOST_STATS = "{prefix}.host{i}of{n}.stats.json"


@dataclasses.dataclass
class HostSpec:
    n: int
    i: int
    coordinator: Optional[str] = None


def init_distributed(spec: HostSpec) -> bool:
    """Best-effort gloo process group over ``spec.coordinator``.

    Filesystem coordination below never depends on this; it only enables
    the cross-host counter all-reduce."""
    if not spec.coordinator:
        return False
    try:
        import torch.distributed as dist
        dist.init_process_group("gloo",
                                init_method=f"tcp://{spec.coordinator}",
                                world_size=spec.n, rank=spec.i)
        logger.info("torch.distributed: gloo process group, rank %d of %d "
                    "via %s", spec.i, spec.n, spec.coordinator)
        return True
    except Exception as exc:  # noqa: BLE001 — degrade to file coordination
        logger.warning("torch.distributed init failed (%s); running with "
                       "filesystem coordination only", exc)
        return False


def allreduce_counters(counters: np.ndarray, distributed: bool) -> np.ndarray:
    """Sum int64 counters across hosts with an all-reduce on CPU tensors in
    the gloo group. Identity when not distributed — the file-based merge
    covers the stats then. The counters stay int64 end to end, so counts
    past 2^24 (total bases of a full SMRT cell) never pass through a
    float."""
    if not distributed:
        return counters
    import torch
    import torch.distributed as dist
    t = torch.from_numpy(np.array(counters, np.int64))
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.numpy()


def host_paths(prefix: str, spec: HostSpec, i: Optional[int] = None):
    i = spec.i if i is None else i
    fmt = dict(prefix=prefix, i=i, n=spec.n)
    return (_HOST_BAM.format(**fmt), _HOST_STATS.format(**fmt),
            _SENTINEL.format(**fmt))


def run_multihost(args, argv: list[str], run_fn) -> int:
    """Drive one host's share and (on host 0) the merge.

    ``run_fn(child_argv)`` is ccs_tpu_torch.cli.run (with the caller's
    devices bound), re-entered with the chunk, per-host output, and a
    stats-delta dump so the merge can rebuild every report exactly.
    """
    spec = HostSpec(n=args.tpu_num_hosts, i=args.tpu_host_id,
                    coordinator=args.tpu_coordinator)
    if not (0 <= spec.i < spec.n):
        raise SystemExit(f"--tpu-host-id {spec.i} outside 0..{spec.n - 1}")
    if args.chunk:
        raise SystemExit("--chunk and --tpu-num-hosts are exclusive "
                         "(hosts derive their own chunks)")
    distributed = init_distributed(spec)

    out = args.output
    prefix = out
    for suffix in (".bam", ".fastq.gz", ".fq.gz", ".consensusreadset.xml"):
        if out.endswith(suffix):
            prefix = out[:-len(suffix)]
            break
    bam_i, stats_i, sent_i = host_paths(prefix, spec)

    child = [args.input, bam_i,
             "--chunk", f"{spec.i + 1}/{spec.n}",
             "--suppress-reports",
             "--tpu-stats-delta", stats_i]
    passthrough = iter(argv)
    skip_next = False
    for tok in passthrough:
        if skip_next:
            skip_next = False
            continue
        if tok in (args.input, args.output):
            continue
        if tok in ("--tpu-num-hosts", "--tpu-host-id", "--tpu-coordinator"):
            skip_next = True
            continue
        child.append(tok)
    rc = run_fn(child)
    if rc != 0:
        return rc
    with open(sent_i, "w") as fh:
        fh.write("done\n")

    # cross-host yield counters over the process group (sanity mirror of
    # the file-based stats merge)
    if distributed:
        with open(stats_i) as fh:
            d = json.load(fh)
        local = np.asarray([d["n_zmws"], d["total_bases"]], np.int64)
        tot = allreduce_counters(local, distributed)
        logger.info("cluster totals via all_reduce: %d ZMWs, %d bases",
                    int(tot[0]), int(tot[1]))

    if spec.i != 0:
        return 0
    return _merge(args, prefix, spec)


def _merge(args, prefix: str, spec: HostSpec,
           timeout_s: float = 86_400.0) -> int:
    """Host 0: wait for every host, then merge records + stats into the
    final outputs (the pbmerge/samtools-merge role, parallelize.md:21-29)."""
    from ccs_tpu_torch.io.bam import BamReader, BamWriter
    from ccs_tpu_torch.io.datasetxml import write_consensusreadset
    from ccs_tpu_torch.io.fastq import FastqWriter
    from ccs_tpu_torch.io.pbi import PbiIndex, write_pbi
    from ccs_tpu_torch.pipeline.checkpoint import stats_from_delta
    from ccs_tpu_torch.report.metrics import write_zmw_metrics
    from ccs_tpu_torch.report.stats import (RunStats, format_ccs_report,
                                            hifi_summary_dict,
                                            report_json_dict)

    deadline = time.monotonic() + timeout_s
    waiting = list(range(spec.n))
    while waiting:
        waiting = [i for i in waiting
                   if not os.path.exists(host_paths(prefix, spec, i)[2])]
        if not waiting:
            break
        if time.monotonic() > deadline:
            raise SystemExit(f"multihost merge timed out waiting for hosts "
                             f"{waiting}")
        time.sleep(0.25)

    out = args.output
    want_xml = out.endswith(".consensusreadset.xml")
    want_fastq = out.endswith((".fastq.gz", ".fq.gz"))
    bam_path = out if out.endswith(".bam") else prefix + ".bam"

    # Streaming merge: records pass straight from each host BAM into the
    # final writer, so host-0 memory stays flat at reference scale (2.8 M
    # reads, performance.md:48-54); the .pbi columns accumulate as typed
    # arrays as the records stream by.
    stats = RunStats()
    header = None
    writer = None
    fq = FastqWriter(out if want_fastq else args.fastq) \
        if (want_fastq or args.fastq) else None
    col_qs = array.array("i")
    col_qe = array.array("i")
    col_zm = array.array("i")
    col_rq = array.array("f")
    col_cx = array.array("B")
    n_records = 0
    total_len = 0
    for i in range(spec.n):
        bam_i, stats_i, _ = host_paths(prefix, spec, i)
        with open(stats_i) as fh:
            stats.merge(stats_from_delta(json.load(fh)))
        with BamReader(bam_i) as r:
            if header is None:
                header = r.header
                writer = BamWriter(bam_path, header)
            for rec in r:
                writer.write_record(rec)
                col_qs.append(rec.tag("qs", 0))
                col_qe.append(rec.tag("qe", len(rec.seq)))
                col_zm.append(rec.tag("zm", 0))
                col_rq.append(rec.tag("rq", -1.0))
                col_cx.append(rec.tag("cx", 0) & 0xFF)
                n_records += 1
                total_len += len(rec.seq)
                if fq is not None:
                    fq.write(rec.name, rec.seq, rec.qual)
    voffs = list(writer.voffsets)
    writer.close()
    if fq is not None:
        fq.close()
    write_pbi(bam_path + ".pbi", PbiIndex(
        rg_id=np.zeros(n_records, np.int32),
        q_start=np.frombuffer(col_qs, np.int32),
        q_end=np.frombuffer(col_qe, np.int32),
        hole_number=np.frombuffer(col_zm, np.int32),
        read_qual=np.frombuffer(col_rq, np.float32),
        ctxt_flag=np.frombuffer(col_cx, np.uint8),
        file_offset=np.asarray(voffs, np.uint64)))
    # per-host fail_reads.bam files merge the same way (streamed)
    fail_parts = [f"{prefix}.host{i}of{spec.n}.fail_reads.bam"
                  for i in range(spec.n)]
    if any(os.path.exists(p) for p in fail_parts):
        fw = BamWriter(f"{prefix}.fail_reads.bam", header)
        for p in fail_parts:
            if os.path.exists(p):
                with BamReader(p) as r:
                    for rec in r:
                        fw.write_record(rec)
        fw.close()
    if want_xml:
        write_consensusreadset(out, bam_path, n_records, total_len)

    if not args.suppress_reports or args.report_file:
        path = args.report_file or f"{prefix}.ccs_report.txt"
        with open(path, "w") as fh:
            fh.write(format_ccs_report(stats))
    if args.report_json:
        with open(args.report_json, "w") as fh:
            json.dump(report_json_dict(stats), fh, indent=2)
    if not args.suppress_reports or args.metrics_json:
        path = args.metrics_json or f"{prefix}.zmw_metrics.json.gz"
        write_zmw_metrics(path, stats)
    if args.hifi_summary_json:
        with open(args.hifi_summary_json, "w") as fh:
            json.dump(hifi_summary_dict(stats), fh, indent=2)

    for i in range(spec.n):
        bam_i, stats_i, sent_i = host_paths(prefix, spec, i)
        for p in (bam_i, bam_i + ".pbi", stats_i, sent_i,
                  f"{prefix}.host{i}of{spec.n}.fail_reads.bam"):
            if os.path.exists(p):
                os.unlink(p)
    logger.info("multihost merge: %d hosts -> %s (%d reads)", spec.n,
                bam_path, n_records)
    return 0
