"""Checkpoint / resume (SURVEY.md §5): batch-granular watermarks.

The reference's restart unit is the chunk (--chunk i/N + offline merge,
reference docs, faq/parallelize.md:15-29) and it writes output through
TMPDIR temp files merged at the end (changelog.md:47). This module gives the
TPU build a finer restart unit: every flushed batch writes

    <dir>/batch_<i>.bam          the batch's output records
    <dir>/batch_<i>.stats.json   the batch's RunStats delta + metrics rows
    <dir>/watermark.json         atomic: highest fully-flushed hole number

A crashed run restarted with ``--tpu-resume-dir <dir>`` skips every ZMW at
or below the watermark, appends new batches, and the final merge combines
all batch files into the output BAM — byte-identical to an uninterrupted
run (ZMWs stream in hole order).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

from ccs_tpu_torch.report.stats import RunStats, ZmwMetricsRow
from ccs_tpu_torch.statuses import ZmwStatus


def stats_delta_dict(st: RunStats) -> dict:
    """Serializable delta of one batch's stats."""
    return {
        "n_input": st.n_input,
        "n_zmws": st.n_zmws,
        "status_counts": {s.name: c for s, c in st.status_counts.items()},
        "status_counts_ss": {s.name: c
                             for s, c in st.status_counts_ss.items()},
        "n_input_ss": st.n_input_ss,
        "n_tandem_ss": st.n_tandem_ss,
        "n_tandem": st.n_tandem,
        "n_missing_adapters": st.n_missing_adapters,
        "read_lengths": list(map(int, st.read_lengths)),
        "read_rqs": list(map(float, st.read_rqs)),
        "strands": list(st.strands),
        "qv_ge30_bases": st.qv_ge30_bases,
        "total_bases": st.total_bases,
        "metrics_rows": [dataclasses.asdict(r) for r in st.metrics_rows],
    }


def stats_from_delta(d: dict) -> RunStats:
    st = RunStats()
    st.n_input = d["n_input"]
    st.n_zmws = d.get("n_zmws", 0)
    st.status_counts = {ZmwStatus[k]: v
                        for k, v in d["status_counts"].items()}
    st.status_counts_ss = {ZmwStatus[k]: v
                           for k, v in d["status_counts_ss"].items()}
    st.n_input_ss = d["n_input_ss"]
    st.n_tandem_ss = d["n_tandem_ss"]
    st.n_tandem = d["n_tandem"]
    st.n_missing_adapters = d["n_missing_adapters"]
    st.read_lengths = d["read_lengths"]
    st.read_rqs = d["read_rqs"]
    st.strands = d["strands"]
    st.qv_ge30_bases = d["qv_ge30_bases"]
    st.total_bases = d["total_bases"]
    st.metrics_rows = [ZmwMetricsRow(**r) for r in d["metrics_rows"]]
    return st


class Checkpointer:
    """Per-batch temp writes + watermark for one (chunked) run."""

    def __init__(self, directory: str, header):
        self.dir = directory
        self.header = header
        os.makedirs(directory, exist_ok=True)
        self.watermark_path = os.path.join(directory, "watermark.json")
        self.next_batch = 0
        self.resume_hole: Optional[int] = None
        if os.path.exists(self.watermark_path):
            with open(self.watermark_path) as fh:
                wm = json.load(fh)
            self.next_batch = wm["n_batches"]
            self.resume_hole = wm["last_hole"]

    def completed_stats(self) -> RunStats:
        """Merged stats of all already-flushed batches (resume path)."""
        merged = RunStats()
        for i in range(self.next_batch):
            with open(os.path.join(self.dir, f"batch_{i}.stats.json")) as fh:
                merged.merge(stats_from_delta(json.load(fh)))
        return merged

    def should_skip(self, hole: int) -> bool:
        return self.resume_hole is not None and hole <= self.resume_hole

    def write_batch(self, records, fail_records, stats_delta: RunStats,
                    last_hole: int) -> None:
        """Flush one batch durably, then advance the watermark atomically."""
        from ccs_tpu_torch.io.bam import BamWriter
        i = self.next_batch
        w = BamWriter(os.path.join(self.dir, f"batch_{i}.bam"), self.header)
        for rec in records:
            w.write_record(rec)
        w.close()
        fw = BamWriter(os.path.join(self.dir, f"batch_{i}.fail.bam"),
                       self.header)
        for rec in fail_records:
            fw.write_record(rec)
        fw.close()
        with open(os.path.join(self.dir, f"batch_{i}.stats.json"), "w") as fh:
            json.dump(stats_delta_dict(stats_delta), fh)
        tmp = self.watermark_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"n_batches": i + 1, "last_hole": int(last_hole)}, fh)
        os.replace(tmp, self.watermark_path)  # atomic on POSIX
        self.next_batch = i + 1

    def iter_batch_records(self, fail: bool = False):
        """All records across flushed batches, in batch order (final merge)."""
        from ccs_tpu_torch.io.bam import BamReader
        suffix = ".fail.bam" if fail else ".bam"
        for i in range(self.next_batch):
            path = os.path.join(self.dir, f"batch_{i}{suffix}")
            if os.path.exists(path):
                yield from BamReader(path)

    def cleanup(self) -> None:
        for name in os.listdir(self.dir):
            if name.startswith("batch_") or name == "watermark.json":
                os.unlink(os.path.join(self.dir, name))
