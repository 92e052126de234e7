"""The port's spans and counters (``ccs_tpu_torch.telemetry``): nesting,
self time and totals from one thread and from several, the timeline's
bound, the clock shared with ``torch.profiler``, ``idle_by_span``, and the
CLI's "wall split" line and profile built on them."""

from __future__ import annotations

import glob
import json
import logging
import os
import sys
import threading
import time

import pytest
import torch

from ccs_tpu_torch import cli, telemetry
from ccs_tpu_torch.parallel.mesh import run_on_shards
from ccs_tpu_torch.pipeline.orchestrator import shutdown_pool
from ccs_tpu_torch.sim.simulator import simulate_zmw, write_subreads_bam
from ccs_tpu_torch.telemetry import NO_SPAN, Recorder, Span


@pytest.fixture(scope="module", autouse=True)
def _stop_prepare_pool():
    yield
    shutdown_pool()


def _self_seconds(spans: list[Span]) -> dict[str, float]:
    """Per name, the spans' time less the time of their direct children."""
    child_ns: dict[int, int] = {}
    for s in spans:
        child_ns[s.parent] = child_ns.get(s.parent, 0) + s.end_ns - s.start_ns
    out: dict[str, float] = {}
    for s in spans:
        own = s.end_ns - s.start_ns - child_ns.get(s.id, 0)
        out[s.name] = out.get(s.name, 0.0) + own * 1e-9
    return out


def test_span_nesting_self_time_and_totals():
    rec = Recorder(timeline=True)
    with rec.span("device_step"):
        time.sleep(0.01)
        with rec.span("sync"):
            time.sleep(0.01)
        with rec.span("pull"):
            time.sleep(0.005)
    with rec.span("sync"):
        pass
    spans = {(s.name, s.parent): s for s in rec.timeline()}
    step = spans[("device_step", 0)]
    assert spans[("sync", step.id)].thread == step.thread
    assert spans[("pull", step.id)].start_ns >= spans[("sync", step.id)].end_ns
    assert ("sync", 0) in spans                     # a top-level one
    # totals sum each name's spans exactly; self time leaves the children
    assert rec.counter("sync") == 2 and rec.counter("device_step") == 1
    assert rec.seconds("device_step") == pytest.approx(
        (step.end_ns - step.start_ns) * 1e-9)
    own = _self_seconds(rec.timeline())["device_step"]
    assert own == pytest.approx(rec.seconds("device_step")
                                - rec.seconds("pull")
                                - (spans[("sync", step.id)].end_ns
                                   - spans[("sync", step.id)].start_ns)
                                * 1e-9)
    assert 0.009 < own < rec.seconds("device_step") - 0.014


def test_totals_from_several_threads_at_once():
    """Shard threads (``run_on_shards`` over CPU devices, more threads than
    cores, a short switch interval) record at once: no span or count is
    lost, each span's parent is on its own thread, and the totals are the
    thread-seconds of the timeline."""
    n_threads, n_spans = 2 * (os.cpu_count() or 1) + 2, 200
    rec = Recorder(timeline=True)
    # every shard waits for all the others, so each runs on a thread of
    # its own (the pool would otherwise reuse a thread that finished)
    start = threading.Barrier(n_threads, timeout=60)

    def work(k):
        start.wait()
        for _ in range(n_spans):
            with rec.span("h2d"):
                with rec.span("sync"):
                    pass
            rec.count("windows_polished", k)
        return threading.current_thread().name

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        names = run_on_shards([torch.device("cpu")] * n_threads, work,
                              [()] * n_threads)
    finally:
        sys.setswitchinterval(old)
    assert len(set(names)) == n_threads
    spans = rec.timeline()
    assert len(spans) == 2 * n_threads * n_spans and rec.dropped == 0
    assert rec.counter("h2d") == rec.counter("sync") == n_threads * n_spans
    assert rec.counter("windows_polished") == \
        n_spans * sum(range(n_threads))
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == "sync":
            assert by_id[s.parent].name == "h2d"
            assert by_id[s.parent].thread == s.thread
        else:
            assert s.parent == 0
    for name in ("h2d", "sync"):
        assert rec.seconds(name) == pytest.approx(sum(
            s.end_ns - s.start_ns for s in spans if s.name == name) * 1e-9)


@pytest.mark.parametrize("n_spans", [3, 5, 12])
def test_ring_bound_and_drop_count(n_spans):
    rec = Recorder(timeline=True, ring=5)
    for _ in range(n_spans):
        with rec.span("sync"):
            pass
    kept = rec.timeline()
    assert len(kept) == min(n_spans, 5)
    assert rec.dropped == max(0, n_spans - 5)
    assert [s.id for s in kept] == list(range(n_spans - len(kept) + 1,
                                              n_spans + 1))
    assert rec.counter("sync") == n_spans      # totals keep every span


def test_no_timeline_without_asking():
    rec = Recorder()
    with rec.span("pipeline"):
        pass
    assert rec.timeline() == [] and rec.counter("pipeline") == 1
    with telemetry.span(None, "sync"):     # no recorder: nothing recorded
        pass


def test_anchor_puts_spans_on_the_profiler_clock():
    """A span around a ``record_function`` block encloses the profiler's
    event of that block once converted through the recorder's anchor."""
    from torch.profiler import ProfilerActivity, profile, record_function
    rec = Recorder(timeline=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("device_step"):
            time.sleep(0.005)
            with record_function("ccs_block"):
                time.sleep(0.02)
            time.sleep(0.005)
    ev = next(e for e in prof.profiler.kineto_results.events()
              if e.name() == "ccs_block")
    (s,) = rec.timeline()
    a, b = rec.to_wall_ns(s.start_ns), rec.to_wall_ns(s.end_ns)
    assert a < int(ev.start_ns())
    assert int(ev.start_ns()) + int(ev.duration_ns()) < b


MS = 1_000_000


def test_idle_by_span_on_synthetic_intervals():
    spans = [Span(1, 0, "pipeline", "main", 0, 100 * MS),
             Span(2, 1, "device_step", "main", 15 * MS, 45 * MS),
             Span(3, 2, "sync", "main", 25 * MS, 28 * MS),
             Span(4, 2, "pull", "main", 41 * MS, 44 * MS),
             Span(5, 1, "finalize", "main", 50 * MS, 55 * MS)]
    device = {0: [(0, 10 * MS), (5 * MS, 20 * MS), (30 * MS, 40 * MS),
                  (60 * MS, 70 * MS)],
              1: [(0, 5 * MS), (200 * MS, 210 * MS)]}
    got = telemetry.idle_by_span(device, spans)
    want0 = {"device_step": 0.009, "sync": 0.003, "pull": 0.003,
             "pipeline": 0.010, "finalize": 0.005}
    assert set(got[0]) == set(want0)
    for k, v in want0.items():
        assert got[0][k] == pytest.approx(v)
    # device 1's one gap (5-200 ms) covers the whole nest and 100 ms more
    assert got[1] == pytest.approx({
        "pipeline": 0.060, "device_step": 0.024, "sync": 0.003,
        "pull": 0.003, "finalize": 0.005, NO_SPAN: 0.100})
    # idle seconds add up to the gaps between the busy union
    assert sum(got[0].values()) == pytest.approx(0.030)
    assert telemetry.idle_by_span({2: [(0, MS)]}, spans) == {2: {}}


@pytest.fixture(scope="module")
def small_bam(tmp_path_factory):
    d = tmp_path_factory.mktemp("telemetry")
    zmws = [simulate_zmw(hole=h, insert_len=150, n_passes=6, snr=8.5)
            for h in range(3)]
    path = str(d / "in.subreads.bam")
    write_subreads_bam(path, zmws)
    return path


class _WallSplit(logging.Handler):
    def __init__(self):
        super().__init__(level=logging.INFO)
        self.records = []

    def emit(self, record):
        if record.msg.startswith("wall split"):
            self.records.append(record)


def _cli_runs(path, out_dir, monkeypatch, n_runs, extra=()):
    """``n_runs`` CLI runs: their engines and "wall split" records."""
    engines = []

    class Engine(cli.CcsEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    monkeypatch.setattr(cli, "CcsEngine", Engine)
    cap = _WallSplit()
    log = logging.getLogger("ccs_tpu")
    log.addHandler(cap)
    try:
        for i in range(n_runs):
            assert cli.run([path, os.path.join(out_dir, f"o{i}.bam"), "-j",
                            "2", "--batch-size", "2", "--log-level", "INFO",
                            *extra], device="cpu") == 0
    finally:
        log.removeHandler(cap)
    return engines, cap.records


def test_cli_wall_split_line(small_bam, tmp_path, monkeypatch):
    """The line's first four fields are the engine's old clocks, device
    wait is sync + pull, the appended fields are the recorder's totals by
    name, and a second run starts from zero."""
    engines, records = _cli_runs(small_bam, str(tmp_path), monkeypatch, 2)
    assert len(engines) == 2 and len(records) == 2
    names = [n for n, _u in telemetry.WALL_SPLIT_FIELDS]
    for eng, record in zip(engines, records):
        args = record.args
        assert len(args) == len(names)
        assert record.getMessage().startswith(
            "wall split: prepare %.3f thread-s, device_step" % args[0])
        rec = eng.telemetry
        assert args[:4] == (eng.t_prepare, eng.t_device,
                            rec.seconds("sync") + rec.seconds("pull"),
                            eng.t_finalize)
        for (name, unit), value in list(zip(telemetry.WALL_SPLIT_FIELDS,
                                            args))[4:]:
            want = rec.seconds(name) if unit == "s" else rec.counter(name)
            assert value == want, name
            assert f"{name} " in record.getMessage()
        split = dict(zip(zip(names, [u for _n, u in
                                     telemetry.WALL_SPLIT_FIELDS]), args))
        assert split[("windows_polished", "windows")] > 0
        assert split[("sync", "calls")] > 0
        assert eng.polish_stats[1] == split[("polish_iterations",
                                             "iterations")]
        assert eng.polish_stats[0] == split[("windows_converged",
                                             "windows")]
        parts = sum(split[(n, "s")] for n in (
            "prepare_wait", "pack", "device_step", "finalize",
            "handoff_wait"))
        assert 0 < parts <= split[("pipeline", "s")]
    # reset per run: the same input counts the same, not twice as much
    assert records[0].args[13:] == records[1].args[13:]
    assert engines[0].telemetry is not engines[1].telemetry


def test_cli_profile_holds_the_pipeline_spans(small_bam, tmp_path,
                                              monkeypatch):
    """Under --tpu-profile-dir the trace holds every stage's spans: the
    device thread's nest inside ``pipeline``, the device step's children
    inside ``device_step``, and the reader's and writer's on their own
    threads. The run logs its idle line."""
    trace_dir = str(tmp_path / "trace")
    lines = []

    class Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    h = Lines(level=logging.INFO)
    logging.getLogger("ccs_tpu").addHandler(h)
    try:
        engines, _r = _cli_runs(small_bam, str(tmp_path), monkeypatch, 1,
                                ("--tpu-profile-dir", trace_dir))
    finally:
        logging.getLogger("ccs_tpu").removeHandler(h)
    (path,) = glob.glob(os.path.join(trace_dir, "*.trace.json"))
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("cat") == "span"]
    by_id = {e["args"]["id"]: e for e in events}

    def ancestors(e):
        while e["args"]["parent"]:
            e = by_id[e["args"]["parent"]]
            yield e["name"]

    names = {e["name"] for e in events}
    assert {"pipeline", "prepare_wait", "pack", "device_step", "h2d",
            "sync", "pull", "finalize", "handoff_wait", "read",
            "write"} <= names
    main = {e["tid"] for e in events if e["name"] == "pipeline"}
    for e in events:
        if e["name"] in ("h2d", "sync", "pull"):
            assert "device_step" in ancestors(e)
        if e["tid"] in main and e["name"] != "pipeline":
            assert "pipeline" in ancestors(e)
        if e["name"] == "read":
            assert e["tid"] == "ccs-reader"
        if e["name"] == "write":
            assert e["tid"] == "ccs-writer"
    assert engines[0].telemetry.counter("sync") == sum(
        e["name"] == "sync" for e in events)
    assert any(m.startswith("device idle by host span") for m in lines)
