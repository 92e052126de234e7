"""One run of a benchmark cell: set-up, the measured window, the check.

The run drives ``ccs_tpu_torch.cli.run`` in this process, the command line
users run, on a subreads BAM that repeats a seeded pool of simulated ZMWs:

1. set-up: load the program and its kernels; simulate the pool; write a
   short warm-up BAM and run the CLI over it (this spawns the prepare pool,
   warms the cell's bucket shapes and gives the rate that sizes the
   measured file); write the measured BAM;
2. the measured ``cli.run`` with ``--log-level INFO --refresh-rate 0``, so
   the CLI prints its progress line (the cumulative ZMW count) each time
   the writer finishes a batch. The window opens at the progress line of
   batch ``fill_batches`` and closes at the first progress line at least
   ``seconds`` later; ZMWs between the two lines over the time between
   them is the rate, and the host CPU of this process and its prepare
   workers is read from ``/proc`` at both lines. An input that runs out
   before the window closes fails the run; at the closing line the file is
   cut a batch past the CLI's reader, so the run drains only what it has
   taken;
3. the run drains, its outputs are held against the simulated truth
   (``reference.judge``), and each metric's reader
   (``ccsbench/metrics/<name>.py``) turns the run's observations into its
   value.

With ``trace`` the device is traced (``torch.profiler``, CUDA activity
only) for ``trace_seconds`` from the window's start; in a cell that lists
``hmm_score_sparse_roofline``, the scorer kernel is traced before that, in
set-up, on the frozen production window batch (``ccsbench/roofline.py``).
"""

from __future__ import annotations

import bisect
import gc
import importlib.util
import io
import json
import logging
import math
import os
import re
import sys
import threading
import time
from typing import Callable, Optional

from ccsbench import bamio, generator, reference

# the measured file holds this many times the ZMWs that the warm-up's
# rate says the window consumes, plus the fill and two batches (the warm-up
# reads 1.3-2.5x the steady rate, so that rate already over-sizes it);
# what the window leaves unread is cut off when it closes (InputCut)
INPUT_MARGIN = 1.2
_PROGRESS = re.compile(r"^(\d+)/\d+/[\d.]+ \d+/\d+/[\d.]+")


class RunFailed(RuntimeError):
    """The run cannot give a result (no window, input exhausted, ...)."""


def load_bench(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell_of(bench: dict, workload: str) -> tuple[dict, dict, dict]:
    """(workload entry, configuration entry, configuration file)."""
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise RunFailed(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    root = bench["_root"]
    with open(os.path.join(root, conf["file"])) as fh:
        return wl, conf, json.load(fh)


def limits_for(root: str, workload: str) -> dict:
    """The cell's limits, ``ccsbench/limits/<workload>.json``: each is set
    from the cell's own sound and control readings (``PERF.md``)."""
    path = os.path.join(root, "ccsbench", "limits", workload + ".json")
    if not os.path.exists(path):
        raise RunFailed(f"no limits for {workload}: {path}")
    with open(path) as fh:
        return json.load(fh)


def unanswered(report: dict, n_in: int) -> int:
    """Of the ``n_in`` ZMWs fed, those the run gave no answer for: the
    ones its report leaves uncounted, and the ones it counts under
    'Unknown error' (an exception in the program). A ZMW that fails a
    filter (too few passes, rq under ``--min-rq``) is answered: the
    filters are guarantees the configuration states, and how many ZMWs
    come out HiFi is held by the check's ``hifi_shortfall``."""
    counted = sum(report.get(k, 0) for k in (
        "ZMWs pass filters", "ZMWs fail filters", "ZMWs shortcut filters"))
    lost = max(0, n_in - counted) + report.get("Unknown error", 0)
    return min(n_in, lost)


# ---- host clocks and CPU ----

def _clk_tck() -> int:
    return os.sysconf("SC_CLK_TCK")


def _stat_fields(pid) -> Optional[list[str]]:
    try:
        with open(f"/proc/{pid}/stat") as fh:
            s = fh.read()
    except OSError:
        return None
    return s[s.rindex(")") + 2:].split()


def process_start_epoch() -> float:
    """When this process started, in seconds since the epoch."""
    start_ticks = int(_stat_fields("self")[19])
    with open("/proc/stat") as fh:
        btime = next(int(ln.split()[1]) for ln in fh
                     if ln.startswith("btime"))
    return btime + start_ticks / _clk_tck()


def tree_cpu_s(root_pid: int) -> float:
    """User + system CPU seconds of ``root_pid`` and its live descendants
    (the prepare workers and whatever else it spawned)."""
    procs = {}
    for d in os.listdir("/proc"):
        if d.isdigit():
            f = _stat_fields(d)
            if f is not None:
                procs[int(d)] = (int(f[1]), int(f[11]) + int(f[12]))
    kids: dict[int, list[int]] = {}
    for pid, (ppid, _t) in procs.items():
        kids.setdefault(ppid, []).append(pid)
    total, todo = 0, [root_pid]
    while todo:
        pid = todo.pop()
        if pid in procs:
            total += procs[pid][1]
        todo.extend(kids.get(pid, ()))
    return total / _clk_tck()


# ---- the CLI's progress lines ----

class _Mark:
    """A progress line: host clocks, cumulative ZMWs, CPU if read."""

    def __init__(self, zmws: int, cpu: Optional[float] = None):
        self.t = time.perf_counter()
        self.epoch = time.time()
        self.zmws = zmws
        self.cpu = cpu


class InputCut:
    """Cuts the measured BAM short once the window has closed, so that the
    run drains what its reader has taken and no more: the file is
    truncated at the end of the ZMW ``margin`` ZMWs past the reader's
    position (each ZMW ends a BGZF block, and the CLI's reader takes a
    short block header for the end of the file)."""

    def __init__(self, path: str, ends: list[int], margin: int):
        self.path = os.path.realpath(path)
        self.ends = ends
        self.margin = margin
        self.kept = len(ends)
        self.pos = None

    def _reader_pos(self) -> Optional[int]:
        """The OS offset of the file object that holds the BAM open (found
        among the live objects by its name), or None when none does."""
        for obj in gc.get_objects():
            if (type(obj) is io.BufferedReader and not obj.closed
                    and isinstance(obj.name, str)
                    and os.path.realpath(obj.name) == self.path):
                try:
                    return os.lseek(obj.fileno(), 0, os.SEEK_CUR)
                except OSError:
                    return None
        return None

    def __call__(self, _mark=None) -> None:
        pos = self._reader_pos()
        if pos is None:             # the reader is done with the file
            return
        k = bisect.bisect_left(self.ends, pos) + self.margin
        if k < len(self.ends) - 1:
            os.truncate(self.path, self.ends[k])
            self.kept = k + 1
        self.pos = pos


class Window:
    """Watches one cli.run's progress lines (on the CLI's writer thread)
    and opens and closes the window on them."""

    def __init__(self, fill_batches: int, seconds: float,
                 on_open: Callable = None, tick: Callable = None,
                 on_close: Callable = None):
        self.fill = fill_batches
        self.seconds = seconds
        self.on_open = on_open
        self.tick = tick
        self.on_close = on_close
        self.marks: list[_Mark] = []
        self.start: Optional[_Mark] = None
        self.end: Optional[_Mark] = None

    def progress(self, zmws: int) -> None:
        mark = _Mark(zmws)
        self.marks.append(mark)
        if self.start is None and len(self.marks) >= self.fill:
            mark.cpu = tree_cpu_s(os.getpid())
            self.start = mark
            if self.on_open is not None:
                self.on_open(mark)
        elif (self.start is not None and self.end is None
              and mark.t - self.start.t >= self.seconds):
            mark.cpu = tree_cpu_s(os.getpid())
            self.end = mark
            if self.on_close is not None:
                self.on_close(mark)
        if self.tick is not None and self.start is not None:
            self.tick(mark)

    def steady_rate(self) -> float:
        """ZMW/s over the progress lines after the first."""
        m = self.marks[1:]
        if len(m) < 2 or m[-1].t <= m[0].t:
            raise RunFailed("the warm-up gave fewer than three progress "
                            "lines; raise warmup_batches")
        return (m[-1].zmws - m[0].zmws) / (m[-1].t - m[0].t)


class _Stderr(io.TextIOBase):
    """sys.stderr for the CLI: each complete line goes to the watcher if it
    is a progress line, else on to the real stderr. Lines are assembled per
    thread, as ``print`` writes the newline apart."""

    def __init__(self, real):
        self.real = real
        self.window: Optional[Window] = None
        self._parts: dict[int, str] = {}
        self._lock = threading.Lock()

    def writable(self) -> bool:
        return True

    def write(self, s: str) -> int:
        tid = threading.get_ident()
        with self._lock:
            buf = self._parts.pop(tid, "") + s
            *lines, rest = buf.split("\n")
            if rest:
                self._parts[tid] = rest
        for line in lines:
            m = _PROGRESS.match(line)
            if m is not None:
                if self.window is not None:
                    self.window.progress(int(m.group(1)))
            else:
                self.real.write(line + "\n")
        return len(s)

    def flush(self) -> None:
        self.real.flush()


class _WallSplit(logging.Handler):
    """Keeps the arguments of the CLI's 'wall split' log record."""

    def __init__(self):
        super().__init__(level=logging.INFO)
        self.args = None

    def emit(self, record):
        if isinstance(record.msg, str) and record.msg.startswith("wall split"):
            self.args = tuple(float(a) for a in record.args)


# ---- the device trace ----

class DeviceTrace:
    """torch.profiler over CUDA activity only, started and stopped on the
    CLI's writer thread at progress lines."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None
        self.done = threading.Event()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.prof is None or self.done.is_set():
            return
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.done.set()

    def summary(self) -> Optional[dict]:
        """Per device: busy seconds (union of device activity), the span,
        time by op name, idle gaps by the op that ended them."""
        if not self.done.is_set():
            return None
        events = _device_events(self.prof)
        per_dev: dict[int, list] = {}
        for dev, name, a, b in events:
            per_dev.setdefault(dev, []).append((a, b, name))
        busy, ops, gaps = {}, {}, {}
        for dev, ivs in per_dev.items():
            ivs.sort()
            total, cur_a, cur_b = 0, None, None
            for a, b, name in ivs:
                name = _short(name)
                ops[name] = ops.get(name, 0.0) + (b - a) * 1e-9
                if cur_b is None or a > cur_b:
                    if cur_b is not None:
                        total += cur_b - cur_a
                        key = "idle before " + name
                        gaps[key] = gaps.get(key, 0.0) + (a - cur_b) * 1e-9
                    cur_a, cur_b = a, b
                else:
                    cur_b = max(cur_b, b)
            if cur_b is not None:
                total += cur_b - cur_a
            busy[dev] = total * 1e-9
        return {"window_s": self.t1 - self.t0, "busy_s": busy,
                "n_events": len(events),
                "device_ops": sorted(ops.items(), key=lambda kv: -kv[1])[:10],
                "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:10]}


def _short(name: str) -> str:
    """A kernel's name without its trailing argument list, at most 120
    letters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.strip()[:120]


def _device_events(prof) -> list[tuple]:
    """(device index, name, start ns, end ns) of every device event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            a = int(e.start_ns())
            out.append((int(e.device_index()), e.name(), a,
                        a + int(e.duration_ns())))
    return out


# ---- a run ----

def _cli_args(conf: dict, traffic: dict, inp: str, out: str) -> list[str]:
    return [inp, out, *conf["cli_args"],
            "--batch-size", str(int(traffic["batch_zmws"])),
            "--log-level", "INFO", "--refresh-rate", "0"]


def _load_reader(root: str, name: str):
    path = os.path.join(root, "ccsbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "ccsbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, workload: str, trace: bool, obs: dict) -> dict:
    """The cell's metrics of this kind (end-to-end, or per-layer with
    ``trace``), each from its reader; a reader's None leaves it out."""
    out = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        value = _load_reader(bench["_root"], m["name"])(obs)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, workdir: str, devices=None,
             plant: Optional[Callable] = None, log=print) -> dict:
    """One run; returns {"obs", "numbers", "limits", "facts", "correct",
    "attempted", "failed", "device", "breakdown"}. ``devices``: torch
    devices to run on (None: the cell's chips, cuda:0..n-1). ``plant``
    (tests and controls only) is called with the imported program before
    the warm-up, to install a change under the timed path."""
    root = bench["_root"]
    wl, _conf_entry, conf = cell_of(bench, workload)
    traffic = generator.load(root, wl["traffic"])
    limits = limits_for(root, workload)
    os.makedirs(workdir, exist_ok=True)

    import torch
    from ccs_tpu_torch import cli
    from ccs_tpu_torch.ops import hmm_score
    from ccs_tpu_torch.pipeline import orchestrator
    from ccs_tpu_torch import native
    on_cuda = devices is None
    if on_cuda:
        devices = [torch.device("cuda", i) for i in range(int(wl["chips"]))]
        from ccs_tpu_torch.ops import _build
        _build.load_library()           # builds once per checkout
    # the host aligner, built once per checkout here: the prepare workers
    # would each build it at once on a fresh checkout, and the losers fall
    # back to NumPy for the whole run
    if native.load() is None:
        raise RunFailed("the port's native host aligner did not load")
    devices = [torch.device(d) for d in devices]
    if plant is not None:
        plant(devices)
    roof = None
    if trace and on_cuda and any(
            m["name"] == "hmm_score_sparse_roofline"
            and workload in m.get("workloads", [workload])
            for m in bench["per_layer"]):
        # first, so that its trace is the process's first and no record
        # of the window's kernels still in flight reaches it
        from ccsbench import roofline
        roof = roofline.measure(seed, devices[0])

    t0 = time.perf_counter()
    pool = generator.make_pool(traffic, seed)
    parts = generator.pool_parts(pool)
    sim_s = time.perf_counter() - t0
    batch = int(traffic["batch_zmws"])

    real_stderr = sys.stderr
    tee = _Stderr(real_stderr)
    split = _WallSplit()
    logging.getLogger("ccs_tpu").addHandler(split)
    sys.stderr = tee
    try:
        # warm-up: spawns the pool, warms shapes, sizes the file
        warm_in = os.path.join(workdir, "warm.subreads.bam")
        generator.write_bam(warm_in, parts,
                            int(traffic["warmup_batches"]) * batch)
        tee.window = Window(10 ** 9, math.inf)
        rc = cli.run(_cli_args(conf, traffic, warm_in,
                               os.path.join(workdir, "warm.bam")),
                     device=devices)
        if rc != 0:
            raise RunFailed(f"warm-up cli.run returned {rc}")
        rate = tee.window.steady_rate()
        fill = int(traffic["fill_batches"])
        n_in = fill * batch + math.ceil(rate * seconds * INPUT_MARGIN) \
            + 2 * batch
        n_in = -(-n_in // batch) * batch
        inp = os.path.join(workdir, "in.subreads.bam")
        holes, ends = generator.write_bam(inp, parts, n_in)
        cut = InputCut(inp, ends, batch)
        log(f"set-up: pool of {len(pool)} ZMWs simulated in {sim_s:.3f} s; "
            f"warm-up rate {rate:.3f} ZMW/s; measured file {n_in} ZMWs")

        dtrace = DeviceTrace() if trace else None
        trace_s = float(traffic.get("trace_seconds", 3))

        def tick(mark):
            if dtrace.t0 is not None and mark.t - dtrace.t0 >= trace_s:
                dtrace.stop()

        window = Window(fill, seconds,
                        on_open=(lambda m: dtrace.start()) if trace else None,
                        tick=tick if trace else None, on_close=cut)
        tee.window = window
        l0 = (hmm_score.score_sparse.launches, hmm_score.score_dense.launches)
        for d in devices:
            if d.type == "cuda":
                torch.cuda.reset_peak_memory_stats(d)
        out_bam = os.path.join(workdir, "out.bam")
        split.args = None
        rc = cli.run(_cli_args(conf, traffic, inp, out_bam), device=devices)
        if rc != 0:
            raise RunFailed(f"measured cli.run returned {rc}")
        launches = (hmm_score.score_sparse.launches - l0[0],
                    hmm_score.score_dense.launches - l0[1])
    finally:
        sys.stderr = real_stderr
        logging.getLogger("ccs_tpu").removeHandler(split)
    log(f"input cut after ZMW {cut.kept} of {n_in} (reader at byte "
        f"{cut.pos})")
    n_in = cut.kept
    holes = dict(list(holes.items())[:n_in])
    if window.start is None or window.end is None:
        raise RunFailed(
            f"the input ran out before the window closed ({n_in} ZMWs, "
            f"{len(window.marks)} progress lines); the warm-up's rate "
            f"{rate:.3f} ZMW/s undersized it")
    if dtrace is not None:
        dtrace.stop()
    mem = max((torch.cuda.max_memory_allocated(d) for d in devices
               if d.type == "cuda"), default=0)
    obs = {
        "setup_s": window.start.epoch - process_start_epoch(),
        "sim_s": sim_s,
        "window": {"t0": window.start.t, "t1": window.end.t,
                   "z0": window.start.zmws, "z1": window.end.zmws,
                   "cpu0": window.start.cpu, "cpu1": window.end.cpu},
        "run_zmws": n_in,
        "wall_split": split.args,
        "launches": {"sparse": launches[0], "dense": launches[1]},
    }
    breakdown = None
    if trace:
        obs["profile"] = dtrace.summary()
        if obs["profile"] is not None:
            breakdown = {"device_ops": obs["profile"]["device_ops"],
                         "idle_gaps": obs["profile"]["idle_gaps"]}
        if roof is not None:
            obs["roofline"] = roof
    orchestrator.shutdown_pool()
    if on_cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    records = bamio.read_records(out_bam)
    report = bamio.read_report(os.path.join(workdir, "out.ccs_report.txt"))
    numbers, facts = reference.judge(
        records, report, n_in, holes, pool, conf["guarantees"])
    facts["check_s"] = time.perf_counter() - t0
    correct = all(numbers[k] <= limits[k] for k in numbers)
    obs["n_devices"] = len(devices)
    if on_cuda:
        kind = torch.cuda.get_device_name(devices[0])
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    return {"obs": obs, "numbers": numbers, "limits": limits,
            "facts": facts, "correct": correct,
            "attempted": n_in, "failed": unanswered(report, n_in),
            "device": {"platform": platform, "kind": kind,
                       "count": len(devices), "memory_peak_bytes": int(mem)},
            "breakdown": breakdown}
