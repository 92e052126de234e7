"""The readers of the program's spans, at a tiny size on the CPU: they
read the CLI's 'wall split' line by the field's place in
``ccs_tpu_torch.telemetry.WALL_SPLIT_FIELDS``, and leave their metric out
for a program whose line lacks the spans."""

from __future__ import annotations

import pytest

from ccsbench import harness
from ccsbench.tests import tiny

SPAN_METRICS = ("prepare_wait_s_per_kzmw", "chunk_stage_s_per_kzmw",
                "polish_issue_s_per_kzmw", "device_wait_s_per_kzmw",
                "host_syncs_per_kzmw", "polish_iters_per_window",
                "handoff_wait_s_per_kzmw", "writer_s_per_kzmw",
                "reader_s_per_kzmw")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("ccsbench")))


@pytest.fixture(scope="module")
def sound(bench, tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("sound"))
    return harness.run_cell(bench, "tiny", 2 ** 33 + 5, 3.0, False, wd,
                            devices=["cpu"], log=lambda m: None)


def test_span_metrics_without_a_card(bench, sound):
    """Every span reader reads on the tiny traffic, and every one is
    positive there, handoff_wait only by the span's own cost (the writer
    keeps up, so the hand-off never waits)."""
    m = harness.metrics_of(bench, "tiny", True, sound["obs"])
    assert set(SPAN_METRICS) <= set(m)
    assert all(m[k]["value"] > 0 for k in SPAN_METRICS)
    assert m["handoff_wait_s_per_kzmw"]["value"] < \
        m["device_step_s_per_kzmw"]["value"]
    # staging (packing and h2d), issue and device wait cover the device
    # step and the packing before it
    parts = (m["chunk_stage_s_per_kzmw"]["value"]
             + m["polish_issue_s_per_kzmw"]["value"]
             + m["device_wait_s_per_kzmw"]["value"])
    assert parts > m["device_step_s_per_kzmw"]["value"]
    assert m["polish_iters_per_window"]["value"] >= 1


def test_span_metrics_leave_out_a_program_without_spans(bench, sound):
    """A program whose 'wall split' line has only its first four fields
    (one without the spans) gives the span readers nothing to read."""
    obs = dict(sound["obs"], wall_split=sound["obs"]["wall_split"][:4])
    m = harness.metrics_of(bench, "tiny", True, obs)
    assert "device_step_s_per_kzmw" in m
    assert not set(SPAN_METRICS) & set(m)
