"""BENCHMARK.json against the contract's limits on names, units, keys and
files: every name and unit from the allowed characters, every file the
harness finds by a name present."""

from __future__ import annotations

import json
import os
import re

import pytest

from ccsbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(tiny.REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert 1 <= len(bench["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in bench["paths"])
    assert len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert os.path.getsize(os.path.join(tiny.REPO, "BENCHMARK.json")) \
        <= 64 * 1024


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("ccsbench/")
        assert os.path.exists(os.path.join(tiny.REPO, c["file"]))
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(tiny.REPO, c["file"])) as fh:
            conf = json.load(fh)
        assert all(k in conf for k in c["reduced"])
        assert {"cli_args", "guarantees"} <= set(conf)
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_workloads(bench):
    assert 1 <= len(bench["workloads"]) <= 24
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"])
        assert NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(
            tiny.REPO, "ccsbench", "traffic", w["traffic"] + ".json"))
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_metrics(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(names)) == len(names)
    assert 1 <= len(bench["end_to_end"]) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(
            tiny.REPO, "ccsbench", "metrics", m["name"] + ".py"))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = [m for m in bench["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        layer = [m for m in bench["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert layer


def test_limits_files(bench):
    """Every cell has its own limits, set from its own readings: one for
    each number the check reads under its configuration's guarantees."""
    conf_file = {c["name"]: c["file"] for c in bench["configs"]}
    for w in bench["workloads"]:
        path = os.path.join(tiny.REPO, "ccsbench", "limits",
                            w["name"] + ".json")
        with open(path) as fh:
            limits = json.load(fh)
        with open(os.path.join(tiny.REPO, conf_file[w["config"]])) as fh:
            guarantees = json.load(fh)["guarantees"]
        want = {"breaches", "hifi_shortfall", "hifi_err_per_kb",
                "hifi_worst_err_per_kb", "hifi_err_over_claim",
                "qv_worst_bin_err_over_claim"}
        if guarantees.get("kinetics"):
            want.add("kinetics_mismatch_share")
        if guarantees.get("mode_all"):
            want.add("lowq_err_over_claim")
        assert set(limits) == want
        assert limits["breaches"] == 0
