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


# the --all --hifi-kinetics deployment at 300 bp: one-pass ZMWs take the
# low-pass shortcut, two- and three-pass ones polish, some under rq 0.99.
# Sound runs read a mismatch share of 0 and 0.62-0.83 errors per claimed
# error under rq 0.99, a shortfall of 0.75 (the one- and two-pass members);
# the one-pass and swapped kinetics read 0.41 and 0.85, the control 1.26-1.46
KIN_TRAFFIC = dict(TRAFFIC, passes=[1, 2, 3, 8], kinetics=True, pool_zmws=8)
KIN_ARGS = ["--all", "--hifi-kinetics", "--top-passes", "60", "-j", "2"]
KIN_GUARANTEES = {"min_passes": 0, "min_rq": 0.0, "top_passes": 60,
                  "mode_all": True, "kinetics": "hifi"}
KIN_LIMITS = dict(LIMITS, hifi_shortfall=0.8, kinetics_mismatch_share=0.1,
                  lowq_err_over_claim=1.1)


def make_root(tmp: str, traffic: dict = None) -> dict:
    """A root under ``tmp`` holding BENCHMARK.json and ccsbench/ with the
    tiny cells ``tiny`` (``ccs_default``) and ``tiny_kin`` (``--all
    --hifi-kinetics``) added; returns the loaded BENCHMARK.json."""
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
    kin_conf = dict(conf, cli_args=KIN_ARGS, guarantees=KIN_GUARANTEES)
    for name, c, t, lim in (("tiny", conf, traffic or TRAFFIC, LIMITS),
                            ("tiny_kin", kin_conf, KIN_TRAFFIC, KIN_LIMITS)):
        for kind, data in (("configs", c), ("traffic", t), ("limits", lim)):
            with open(os.path.join(root, "ccsbench", kind, name + ".json"),
                      "w") as fh:
                json.dump(data, fh)
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"ccsbench/configs/{name}.json",
                                 "reduced": [], "why": "test"})
        bench["workloads"].append({"name": name, "config": name,
                                   "traffic": name, "chips": 1,
                                   "why": "test"})
        for m in bench["per_layer"]:
            m.get("workloads", []).append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    bench["_root"] = root
    return bench
