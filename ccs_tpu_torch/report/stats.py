"""Run statistics accumulator feeding all report files (L4).

Accumulates per-ZMW outcomes into the counters needed for ccs_report.txt,
zmw_metrics.json.gz, hifi_summary.json and the INFO summary block
(reference docs, faq/reports-aux-files.md; mode-by-strand.md:25-56).
Mergeable across chunks/hosts (the collective-reduce path, SURVEY.md §2.2 P2).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ccs_tpu_torch.pipeline.zmw import ConsensusResult
from ccs_tpu_torch.statuses import REPORT_LABELS, ZmwStatus


@dataclasses.dataclass
class ZmwMetricsRow:
    zmw: str
    status: str
    effective_coverage: float
    has_tandem_repeat: bool
    insert_size: int
    num_full_passes: int
    polymerase_length: int
    predicted_accuracy: float
    wall_start: int
    wall_end: int

    def to_json_dict(self) -> dict:
        return {
            "effective_coverage": round(self.effective_coverage, 3),
            "has_tandem_repeat": self.has_tandem_repeat,
            "insert_size": self.insert_size,
            "num_full_passes": self.num_full_passes,
            "polymerase_length": self.polymerase_length,
            "predicted_accuracy": round(self.predicted_accuracy, 4),
            "status": self.status,
            "wall_end": self.wall_end,
            "wall_start": self.wall_start,
            "zmw": self.zmw,
        }


def _qv_from_rq(rq: float) -> float:
    if rq < 0:
        return -1.0
    err = max(1.0 - rq, 1e-10)
    return -10.0 * np.log10(err)


@dataclasses.dataclass
class RunStats:
    n_input: int = 0
    n_zmws: int = 0  # true input ZMW count (n_input counts results; in
                     # strand modes one ZMW yields up to two results)
    status_counts: dict = dataclasses.field(
        default_factory=lambda: {s: 0 for s in ZmwStatus})
    # per-strand-class splits for the strand-aware report variants
    # (mode-heteroduplex-filtering.md:85-117, mode-by-strand.md:58-89)
    status_counts_ss: dict = dataclasses.field(
        default_factory=lambda: {s: 0 for s in ZmwStatus})
    n_input_ss: int = 0
    n_tandem_ss: int = 0
    n_tandem: int = 0
    n_missing_adapters: int = 0
    # per successful read: (length, rq)
    read_lengths: list = dataclasses.field(default_factory=list)
    read_rqs: list = dataclasses.field(default_factory=list)
    strands: list = dataclasses.field(default_factory=list)  # ""/fwd/rev
    qv_ge30_bases: int = 0
    total_bases: int = 0
    start_time: float = dataclasses.field(default_factory=time.time)
    metrics_rows: list = dataclasses.field(default_factory=list)
    collect_metrics: bool = True
    # RAM bound for per-ZMW metric rows (VERDICT r4 weak 5): beyond this,
    # rows spill to gzip jsonl part files and write_zmw_metrics streams
    # them back out; host memory stays flat at reference scale (2.8 M
    # reads, performance.md:48-54)
    metrics_spill_paths: list = dataclasses.field(default_factory=list)
    metrics_spill_threshold: int = 50_000

    def _maybe_spill(self) -> None:
        if len(self.metrics_rows) < self.metrics_spill_threshold:
            return
        import gzip
        import json as _json
        import tempfile
        fd, path = tempfile.mkstemp(suffix=".zmw_rows.jsonl.gz")
        import os as _os
        _os.close(fd)
        with gzip.open(path, "wt") as fh:
            for row in self.metrics_rows:
                fh.write(_json.dumps(row.to_json_dict()) + "\n")
        self.metrics_spill_paths.append(path)
        self.metrics_rows = []

    def add_zmws(self, n: int) -> None:
        self.n_zmws += n

    def add(self, res: ConsensusResult) -> None:
        self.n_input += 1
        self.status_counts[res.status] += 1
        if res.strand:
            self.n_input_ss += 1
            self.status_counts_ss[res.status] += 1
            if res.has_tandem_repeat:
                self.n_tandem_ss += 1
        if res.has_tandem_repeat:
            self.n_tandem += 1
        if res.status in (ZmwStatus.SUCCESS, ZmwStatus.LOW_PASS_SHORTCUT) \
                and res.seq is not None:
            if res.adapter_info is not None and res.adapter_info.ma:
                self.n_missing_adapters += 1
            self.read_lengths.append(len(res.seq))
            self.read_rqs.append(res.rq)
            self.strands.append(res.strand)
            self.total_bases += len(res.seq)
            if res.qv is not None:
                self.qv_ge30_bases += int((res.qv >= 30).sum())
        if self.collect_metrics:
            self.metrics_rows.append(ZmwMetricsRow(
                zmw=f"{res.movie}/{res.hole}",
                status=res.status.name,
                effective_coverage=res.effective_coverage,
                has_tandem_repeat=res.has_tandem_repeat,
                insert_size=res.insert_size,
                num_full_passes=res.num_passes,
                polymerase_length=res.polymerase_length,
                predicted_accuracy=res.rq if res.rq >= 0 else -1.0,
                wall_start=res.wall_start,
                wall_end=res.wall_end,
            ))
            self._maybe_spill()

    # --- derived ---
    @property
    def n_passed(self) -> int:
        return self.status_counts[ZmwStatus.SUCCESS]

    @property
    def n_shortcut(self) -> int:
        return self.status_counts[ZmwStatus.LOW_PASS_SHORTCUT]

    @property
    def n_failed(self) -> int:
        return self.n_input - self.n_passed - self.n_shortcut

    def hifi_mask(self) -> np.ndarray:
        rqs = np.asarray(self.read_rqs, dtype=np.float64)
        return rqs >= 0.99

    def merge(self, other: "RunStats") -> None:
        """Merge a chunk's stats (multi-host reduce; parallelize.md:15-29)."""
        self.n_input += other.n_input
        self.n_zmws += other.n_zmws
        for s in ZmwStatus:
            self.status_counts[s] += other.status_counts[s]
            self.status_counts_ss[s] += other.status_counts_ss[s]
        self.n_input_ss += other.n_input_ss
        self.n_tandem_ss += other.n_tandem_ss
        self.n_tandem += other.n_tandem
        self.n_missing_adapters += other.n_missing_adapters
        self.read_lengths.extend(other.read_lengths)
        self.read_rqs.extend(other.read_rqs)
        self.strands.extend(other.strands)
        self.qv_ge30_bases += other.qv_ge30_bases
        self.total_bases += other.total_bases
        self.metrics_rows.extend(other.metrics_rows)
        self.metrics_spill_paths.extend(other.metrics_spill_paths)
        self._maybe_spill()
        self.start_time = min(self.start_time, other.start_time)


def _n50(lengths: np.ndarray) -> int:
    if len(lengths) == 0:
        return 0
    s = np.sort(lengths)[::-1]
    csum = np.cumsum(s)
    idx = np.searchsorted(csum, csum[-1] / 2.0)
    return int(s[min(idx, len(s) - 1)])


def _fmt_count(label: str, count: int, denom: int, label_width: int = 30,
               pct_fmt: str = "{:.2f}%") -> str:
    pct = (100.0 * count / denom) if denom else 0.0
    return f"{label:<{label_width}}: {count} ({pct_fmt.format(pct)})"


def format_ccs_report(st: RunStats) -> str:
    """The default ccs_report.txt (reports-aux-files.md:16-72)."""
    lines = []
    W = 30
    lines.append(f"{'ZMWs input':<{W}}: {st.n_input}")
    lines.append("")
    lines.append(_fmt_count("ZMWs pass filters", st.n_passed, st.n_input, W))
    lines.append(_fmt_count("ZMWs fail filters", st.n_failed, st.n_input, W))
    lines.append(_fmt_count("ZMWs shortcut filters", st.n_shortcut, st.n_input, W))
    lines.append("")
    lines.append(_fmt_count("ZMWs with tandem repeats", st.n_tandem, st.n_input, W))
    lines.append("")
    lines.append("Exclusive failed counts")
    for status, label in REPORT_LABELS.items():
        lines.append(_fmt_count(label, st.status_counts[status], st.n_failed, W))
    lines.append("")
    lines.append("Additional passing metrics")
    lines.append(_fmt_count("ZMWs missing adapters", st.n_missing_adapters,
                            st.n_passed, W, "{:.3f}%"))
    lines.append("")
    lines.append(f"{'- - - - - - - - - - - - - - -':<{W}}: - - - - -")
    lines.append("")

    lengths = np.asarray(st.read_lengths, dtype=np.int64)
    rqs = np.asarray(st.read_rqs, dtype=np.float64)
    qvs = np.asarray([_qv_from_rq(r) for r in st.read_rqs])

    def block(title: str, mask: np.ndarray, with_n50: bool) -> None:
        ls, qs = lengths[mask], qvs[mask]
        lines.append(f"{title + ' Reads':<{W}}: {mask.sum()}")
        lines.append(f"{title + ' Yield (bp)':<{W}}: {int(ls.sum()):,}")
        lines.append(f"{title + ' Read Length (mean, bp)':<{W}}: "
                     f"{int(round(ls.mean())) if len(ls) else 0:,}")
        lines.append(f"{title + ' Read Length (median, bp)':<{W}}: "
                     f"{int(np.median(ls)) if len(ls) else 0:,}")
        if with_n50:
            lines.append(f"{title + ' Read Length N50 (bp)':<{W}}: {_n50(ls):,}")
        lines.append(f"{title + ' Read Quality (median)':<{W}}: "
                     f"{int(round(np.median(qs))) if len(qs) else 0}")

    hifi = rqs >= 0.99
    q30 = qvs >= 30
    block("HiFi", hifi, with_n50=True)
    lines.append("")
    block("<Q20", ~hifi, with_n50=False)
    lines.append("")
    block(">=Q30", q30, with_n50=False)
    lines.append("")
    pct = 100.0 * st.qv_ge30_bases / st.total_bases if st.total_bases else 0.0
    lines.append(f"{'Base quality >=Q30 (bp)':<{W}}: {st.qv_ge30_bases:,} ({pct:.1f}%)")
    return "\n".join(lines) + "\n"


def format_ccs_report_strand(st: RunStats, two_column: bool = True) -> str:
    """Strand-aware ccs_report.txt variants.

    --hd-finder: two columns (Double-Strand Reads / Single-Strand Reads),
    counts are READS not ZMWs, `Inputs` percentages are w.r.t. input ZMWs,
    everything else w.r.t. the column (mode-heteroduplex-filtering.md:85-117).
    --by-strand (``two_column=False``): the single-strand column only
    (mode-by-strand.md:58-89).
    """
    W = 25
    ds = {s: st.status_counts[s] - st.status_counts_ss[s] for s in ZmwStatus}
    ss = dict(st.status_counts_ss)
    n_ds = st.n_input - st.n_input_ss
    n_ss = st.n_input_ss

    def cell(count: int, denom: int) -> str:
        pct = 100.0 * count / denom if denom else 0.0
        fmt = "{:.2f}%" if pct >= 10 else "{:.3f}%"
        return f"{count:>10} ({fmt.format(pct)})"

    def row(label: str, ds_c: int, ds_d: int, ss_c: int, ss_d: int) -> str:
        line = f"{label:<{W}}:"
        if two_column:
            line += f" {cell(ds_c, ds_d)}  {cell(ss_c, ss_d)}"
        else:
            line += f" {cell(ss_c, ss_d)}"
        return line

    lines = []
    if two_column:
        lines.append(f"{'':<{W}}  Double-Strand Reads  Single-Strand Reads")
    else:
        lines.append(f"{'':<{W}}  Single-Strand Reads")
    n_zmws = max(st.n_zmws, 1)
    lines.append(row("Inputs", n_ds, n_zmws, n_ss, n_zmws))
    lines.append("")
    pass_ds = ds[ZmwStatus.SUCCESS]
    pass_ss = ss[ZmwStatus.SUCCESS]
    lines.append(row("Passed", pass_ds, n_ds, pass_ss, n_ss))
    lines.append(row("Failed", n_ds - pass_ds - ds[ZmwStatus.LOW_PASS_SHORTCUT],
                     n_ds, n_ss - pass_ss - ss[ZmwStatus.LOW_PASS_SHORTCUT],
                     n_ss))
    lines.append("")
    tand_ds = st.n_tandem - st.n_tandem_ss
    lines.append(row("Tandem repeats", tand_ds, n_ds, st.n_tandem_ss, n_ss))
    lines.append("")
    lines.append("Exclusive failed counts")
    lines.append(row("Shortcut filters", ds[ZmwStatus.LOW_PASS_SHORTCUT],
                     n_ds, ss[ZmwStatus.LOW_PASS_SHORTCUT], n_ss))
    for status, label in REPORT_LABELS.items():
        lines.append(row(label, ds[status], n_ds, ss[status], n_ss))
    return "\n".join(lines) + "\n"


def report_json_dict(st: RunStats) -> dict:
    """JSON twin of the report (--report-json, changelog.md:72)."""
    lengths = np.asarray(st.read_lengths, dtype=np.int64)
    rqs = np.asarray(st.read_rqs, dtype=np.float64)
    hifi = rqs >= 0.99
    return {
        "zmws_input": st.n_input,
        "zmws_pass": st.n_passed,
        "zmws_fail": st.n_failed,
        "zmws_shortcut": st.n_shortcut,
        "zmws_with_tandem_repeats": st.n_tandem,
        "exclusive_failed_counts": {
            label: st.status_counts[status]
            for status, label in REPORT_LABELS.items()
        },
        "hifi_reads": int(hifi.sum()),
        "hifi_yield_bp": int(lengths[hifi].sum()) if len(lengths) else 0,
        "hifi_read_length_mean": float(lengths[hifi].mean()) if hifi.any() else 0.0,
        "hifi_read_length_n50": _n50(lengths[hifi]),
    }


def hifi_summary_dict(st: RunStats) -> dict:
    """hifi_summary.json (--hifi-summary-json, sqiie.md:45)."""
    lengths = np.asarray(st.read_lengths, dtype=np.int64)
    rqs = np.asarray(st.read_rqs, dtype=np.float64)
    qvs = np.asarray([_qv_from_rq(r) for r in st.read_rqs])
    hifi = rqs >= 0.99
    elapsed_hr = max((time.time() - st.start_time) / 3600.0, 1e-9)
    return {
        "zmws_input": st.n_input,
        "zmws_written": len(lengths),
        "unique_molecular_yield_bp": int(lengths.sum()),
        "unique_molecular_yield_bp_per_hr": float(lengths.sum() / elapsed_hr),
        "hifi_reads": int(hifi.sum()),
        "hifi_yield_bp": int(lengths[hifi].sum()) if len(lengths) else 0,
        "hifi_average_length_bp": float(lengths[hifi].mean()) if hifi.any() else 0.0,
        "hifi_average_qv": float(qvs[hifi].mean()) if hifi.any() else 0.0,
    }


def format_summary_log(st: RunStats, strand_aware: bool = False) -> str:
    """End-of-run INFO summary block (mode-by-strand.md:30-56). In the
    strand modes (--by-strand / --hd-finder) the block carries DS/SS
    sub-rows for UMY, HiFi yield and HiFi reads
    (mode-heteroduplex-filtering.md:57-83)."""
    lengths = np.asarray(st.read_lengths, dtype=np.int64)
    rqs = np.asarray(st.read_rqs, dtype=np.float64)
    qvs = np.asarray([_qv_from_rq(r) for r in st.read_rqs])
    strands = np.asarray(st.strands) if st.strands else np.asarray([], dtype=str)
    ss = strands != "" if len(strands) else np.zeros(0, dtype=bool)
    hifi = rqs >= 0.99
    elapsed_hr = max((time.time() - st.start_time) / 3600.0, 1e-9)

    def human(bp: float) -> str:
        for unit, div in (("GBases", 1e9), ("MBases", 1e6), ("KBases", 1e3)):
            if bp >= div:
                return f"{bp / div:.1f} {unit}"
        return f"{int(bp)} Bases"

    umy = float(lengths.sum())
    hifi_yield = float(lengths[hifi].sum()) if len(lengths) else 0.0
    abbrev = [
        "-" * 49,
        "Summary stats abbreviations:",
        "ZMW         - A productive Zero-Mode Waveguide",
        "DS          - Double Strand",
        "SS          - Single Strand",
    ]
    if strand_aware:
        abbrev += [
            "DS-ZMW      - All subreads were used from a single ZMW",
            "SS-ZMW      - ZMW is split into fwd and rev strands,",
            "              each strand is polished individually",
            "DS-Read     - CCS read of a DS-ZMW",
            "SS-Read     - CCS read of one strand of a SS-ZMW",
        ]
    abbrev += [
        "HiFi        - CCS reads with predicted accuracy >=Q20",
        "UMY         - Unique Molecular Yield of all reads passing filters",
    ]
    if strand_aware:
        abbrev.append(
            "HiFi Yield  - UMY of >=Q20 DS- and SS-ZMWs, longest read per ZMW")
    abbrev.append("-" * 49)

    out = abbrev + [
        f"ZMWs Input    : {st.n_zmws or st.n_input}",
        f"ZMWs Written  : {len(lengths)}",
        f" - DS / SS    : {int((~ss).sum())} / {int(ss.sum())}",
        f"UMY           : {human(umy)} ({human(umy / elapsed_hr)}/hr)",
    ]
    if strand_aware:
        out.append(f" - DS / SS    : {human(float(lengths[~ss].sum()))} / "
                   f"{human(float(lengths[ss].sum()))}")
    out.append(f"HiFi Yield    : {human(hifi_yield)} "
               f"({human(hifi_yield / elapsed_hr)}/hr)")
    if strand_aware:
        out.append(f" - DS / SS    : {human(float(lengths[hifi & ~ss].sum()))} / "
                   f"{human(float(lengths[hifi & ss].sum()))}")
    out.append(f"HiFi Reads    : {int(hifi.sum())}")
    if strand_aware:
        out.append(f" - DS / SS    : {int((hifi & ~ss).sum())} / "
                   f"{int((hifi & ss).sum())}")
    out += [
        f"HiFi Avg Size : {human(float(lengths[hifi].mean()) if hifi.any() else 0.0)}",
        f"HiFi Avg QV   : {float(qvs[hifi].mean()) if hifi.any() else 0.0:.1f}",
    ]
    return "\n".join(out)
