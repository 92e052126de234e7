"""A tiny cell for the benchmark's CPU tests: a copy of the benchmark's
files in a temporary root, with a 300 bp traffic mix, two prepare workers
and limits set for that size (sound runs read at most 4 errors per kb,
the worst record 7, 1.3 errors per claimed error, a worst QV group of 1.0
and no shortfall; the control reads 34, 50, 11 and 18.5, the stop_early
fault a shortfall of 0.83)."""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TRAFFIC = {"insert_len": 300, "passes": [8], "snr": 9.0,
           "pool_zmws": 6, "batch_zmws": 4, "fill_batches": 2,
           "warmup_batches": 4, "trace_seconds": 1}
LIMITS = {"breaches": 0, "hifi_shortfall": 0.2, "hifi_err_per_kb": 12.0,
          "hifi_worst_err_per_kb": 12.0, "hifi_err_over_claim": 3.0,
          "qv_worst_bin_err_over_claim": 4.0}


def make_root(tmp: str, traffic: dict = None) -> dict:
    """A root under ``tmp`` holding BENCHMARK.json and ccsbench/ with the
    tiny cell ``tiny`` added; returns the loaded BENCHMARK.json."""
    root = os.path.join(tmp, "root")
    shutil.copytree(os.path.join(REPO, "ccsbench"),
                    os.path.join(root, "ccsbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    conf_path = os.path.join(root, "ccsbench", "configs", "ccs_default.json")
    with open(conf_path) as fh:
        conf = json.load(fh)
    args = conf["cli_args"]
    args[args.index("-j") + 1] = "2"
    with open(os.path.join(root, "ccsbench", "configs", "tiny.json"),
              "w") as fh:
        json.dump(conf, fh)
    with open(os.path.join(root, "ccsbench", "traffic", "tiny.json"),
              "w") as fh:
        json.dump(traffic or TRAFFIC, fh)
    with open(os.path.join(root, "ccsbench", "limits", "tiny.json"),
              "w") as fh:
        json.dump(LIMITS, fh)
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "ccsbench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny", "config": "tiny",
                               "traffic": "tiny", "chips": 1, "why": "test"})
    for m in bench["per_layer"]:
        m.get("workloads", []).append("tiny")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    bench["_root"] = root
    return bench
