"""The benchmark of ccs_tpu_torch: one run of one cell.

    python3 ccsbench/run.py --workload default.15kb_p8 --seed 7 \
        --seconds 30 --trace 0

Runs from the root of a checkout that holds BENCHMARK.json and the
program; needs as many CUDA cards as the cell asks for. Prints its set-up
and the correctness numbers, each beside its limit, on standard error,
and one JSON object as the last line of standard output. Exits non-zero,
with no result, where it has no card, where the window cannot be measured,
or where JAX or the JAX package has been loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "ccs_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: ccs_tpu_torch is not ccs_tpu."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def _fail(msg: str) -> int:
    print(f"ccsbench: {msg}", file=sys.stderr, flush=True)
    return 1


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; the run's scratch under
    the TMPDIR it was given."""
    cache = os.path.join(ROOT, ".ccsbench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    _environment()
    from ccsbench import harness
    try:
        bench = harness.load_bench(ROOT)
    except OSError as exc:
        return _fail(f"no BENCHMARK.json: {exc}")
    bench["_root"] = ROOT
    try:
        wl, _c, _f = harness.cell_of(bench, args.workload)
    except (harness.RunFailed, OSError, StopIteration) as exc:
        return _fail(str(exc))
    try:
        import ccs_tpu_torch  # noqa: F401 — the program under test
    except ImportError as exc:
        return _fail(f"the program is not in this checkout: {exc}")
    import torch
    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is False: no card")
    if torch.cuda.device_count() < int(wl["chips"]):
        return _fail(f"{torch.cuda.device_count()} cards visible, the cell "
                     f"needs {wl['chips']}")
    import tempfile
    workdir = tempfile.mkdtemp(prefix="ccsbench_")
    try:
        res = harness.run_cell(
            bench, args.workload, args.seed, args.seconds, bool(args.trace),
            workdir, log=lambda m: print(f"ccsbench: {m}", file=sys.stderr,
                                         flush=True))
    except harness.RunFailed as exc:
        return _fail(str(exc))
    finally:
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        return _fail("JAX or the JAX package was loaded: " + ", ".join(bad))
    obs = res["obs"]
    metrics = harness.metrics_of(bench, args.workload, bool(args.trace), obs)
    device = dict(res["device"])
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": device}
    if args.trace:
        prof = obs.get("profile")
        if prof is None:
            return _fail("the device trace recorded nothing")
        device["busy_s"] = sum(prof["busy_s"].values()) / device["count"]
        device["window_s"] = prof["window_s"]
        out["breakdown"] = {k: [[n, s] for n, s in res["breakdown"][k]]
                            for k in ("device_ops", "idle_gaps")}
        r = obs.get("roofline")
        if r:
            print(f"ccsbench: hmm_score_sparse: {r['kernel_events']} kernel "
                  f"events of {r['device_events']} for {r['launches']} "
                  f"launches; {r['ms']} ms a launch, bound "
                  f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({r['card']})",
                  file=sys.stderr)
    f = res["facts"]
    print(f"ccsbench: set-up {obs['setup_s']:.3f} s, of it the input "
          f"simulation {obs['sim_s']:.3f} s; window {obs['window']['z1'] - obs['window']['z0']} "
          f"ZMWs in {obs['window']['t1'] - obs['window']['t0']:.3f} s; "
          f"wall split {obs['wall_split']}; launches {obs['launches']}; "
          f"check {f['check_s']:.1f} s over {f['records']} records "
          f"({f['hifi_records']} HiFi, {f['distinct_sequences']} distinct; "
          f"{f['edits']} edits, {f['claimed_errors']:.2f} claimed)",
          file=sys.stderr)
    if "kinetics_mismatch_share" in res["numbers"]:
        print(f"ccsbench: kinetics: {f['kinetics_records']} distinct records "
              f"with averaged kinetics, {f['kinetics_breaches']} breaches of "
              f"their structure, {f['sub_hifi_records_with_kinetics']} of "
              f"them records under rq 0.99 that carry them",
              file=sys.stderr)
    for ex in f["breach_examples"]:
        print(f"ccsbench: breach: {ex}", file=sys.stderr)
    checks = {k: {"value": v, "limit": res["limits"][k]}
              for k, v in res["numbers"].items()}
    for k, c in checks.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    out["checks"] = checks
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
