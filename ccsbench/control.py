"""The control and the planted faults: runs of a cell with the timed path
changed underneath, which the check has to find not correct.

    python3 ccsbench/control.py --workload default.15kb_p8 --seconds 10 \
        --seeds 11,12,13 --plants none,unchanged

runs every (plant, seed) in one process and prints one JSON line per run:
the numbers compared, their limits and ``correct``. The benchmark's own
runs never run this. Plants:

- ``none``: the program as it is (sound runs, for the lower readings);
- ``unchanged``: the control, which breaks the stated guarantee that rq is
  the read's predicted accuracy: the polish step returns its templates
  unchanged, so each window's draft is written under the QVs the polish
  computed. It is also the first of the planted faults;
- ``bf16``: the scorer's log-likelihoods rounded to bfloat16, the step
  below the float32 the port scores in (measured: it moves no number);
- ``half_batch``: half of each batch's results are left out of the output,
  the report counting the batch whole;
- ``altered``: one base in 20 of every eighth ZMW's consensus is changed
  where it is made;
- ``stop_early``: the polish loop stops after ``STOP_EARLY_ITERS``
  iterations, so windows that need more are left unconverged;
- ``kinetics_one_pass``: each record's kinetics are those of one pass per
  strand instead of the average of its passes;
- ``kinetics_strands_swapped``: ``fi``/``fp``/``fn`` are written as
  ``ri``/``rp``/``rn`` and the other way round.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bf16():
    import torch
    import ccs_tpu_torch.pipeline.polish_fused as pf
    saved = pf.score_sparse, pf.score_dense

    def rounded(fn):
        def wrapper(*a, **k):
            lls, ll0 = fn(*a, **k)
            return (lls.to(torch.bfloat16).to(lls.dtype),
                    ll0.to(torch.bfloat16).to(ll0.dtype))
        return wrapper

    pf.score_sparse, pf.score_dense = map(rounded, saved)

    def undo():
        pf.score_sparse, pf.score_dense = saved
    return undo


def _unchanged():
    import torch
    import ccs_tpu_torch.pipeline.engine as eng
    saved = eng.shard_fused_polish

    def make(*a, **k):
        step = saved(*a, **k)

        def same(tpl, tlen, cs, ce, *rest):
            state, qv, stats, *dc = step(tpl, tlen, cs, ce, *rest)
            dev = state.tpl.device

            def like(x, t):
                return torch.as_tensor(x).to(device=dev, dtype=t.dtype)
            state = state._replace(
                tpl=like(tpl, state.tpl), tlen=like(tlen, state.tlen),
                core_start=like(cs, state.core_start),
                core_end=like(ce, state.core_end))
            return (state, qv, stats, *dc)
        return same

    eng.shard_fused_polish = make

    def undo():
        eng.shard_fused_polish = saved
    return undo


def _half_batch():
    import ccs_tpu_torch.pipeline.orchestrator as orch
    saved = orch.run_pipeline

    def run_pipeline(engine, zmw_iter, emit, **kw):
        return saved(engine, zmw_iter,
                     lambda results, n_in: emit(results[::2], n_in), **kw)

    orch.run_pipeline = run_pipeline

    def undo():
        orch.run_pipeline = saved
    return undo


STOP_EARLY_ITERS = 2


def _stop_early():
    import ccs_tpu_torch.pipeline.engine as eng
    saved = eng.shard_fused_polish

    def make(*a, **k):
        k["max_iters"] = STOP_EARLY_ITERS
        return saved(*a, **k)

    eng.shard_fused_polish = make

    def undo():
        eng.shard_fused_polish = saved
    return undo


def _altered():
    import ccs_tpu_torch.pipeline.engine as eng
    saved = eng.finalize_zmw

    def finalize_zmw(item, *a, **k):
        res = saved(item, *a, **k)
        if res.seq is not None and int(res.hole) % 8 == 0:
            seq = res.seq.copy()
            seq[::20] = (seq[::20] + 1) % 4
            res.seq = seq
        return res

    eng.finalize_zmw = finalize_zmw

    def undo():
        eng.finalize_zmw = saved
    return undo


def _kinetics(change):
    """Puts ``change(average_kinetics, consensus, entries)`` in place of
    the program's kinetics averaging, which finalize looks up at each
    call."""
    import ccs_tpu_torch.pipeline.kinetics as kin
    saved = kin.average_kinetics
    kin.average_kinetics = lambda consensus, entries: change(
        saved, consensus, entries)

    def undo():
        kin.average_kinetics = saved
    return undo


def _kinetics_one_pass():
    def first_per_strand(average, consensus, entries):
        first: dict = {}
        for e in entries:
            first.setdefault(e.strand, e)
        return average(consensus, list(first.values()))
    return _kinetics(first_per_strand)


def _kinetics_strands_swapped():
    def swapped(average, consensus, entries):
        k = average(consensus, entries)
        return type(k)(fi=k.ri, fp=k.rp, fn=k.rn, ri=k.fi, rp=k.fp, rn=k.fn)
    return _kinetics(swapped)


PLANTS = {"none": None, "bf16": _bf16, "unchanged": _unchanged,
          "half_batch": _half_batch, "altered": _altered,
          "stop_early": _stop_early, "kinetics_one_pass": _kinetics_one_pass,
          "kinetics_strands_swapped": _kinetics_strands_swapped}


def run_planted(bench: dict, workload: str, seed: int, seconds: float,
                plant: str, workdir: str, devices=None) -> dict:
    """One harness run with ``plant`` installed under the timed path."""
    from ccsbench import harness
    undo = []

    def install(_devices):
        if PLANTS[plant] is not None:
            undo.append(PLANTS[plant]())
    try:
        return harness.run_cell(bench, workload, seed, seconds, False,
                                workdir, devices=devices, plant=install,
                                log=lambda m: print(m, file=sys.stderr))
    finally:
        for u in undo:
            u()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="control and planted faults")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--plants", default="none,unchanged",
                   help="comma-separated")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from ccsbench import harness
    bench = harness.load_bench(ROOT)
    bench["_root"] = ROOT
    import torch
    if not torch.cuda.is_available():
        print("control: no card", file=sys.stderr)
        return 1
    for plant in args.plants.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            with tempfile.TemporaryDirectory(prefix="ccsbench_") as wd:
                try:
                    res = run_planted(bench, args.workload, seed,
                                      args.seconds, plant, wd)
                except harness.RunFailed as exc:
                    print(json.dumps({"plant": plant, "seed": seed,
                                      "failed": str(exc)}), flush=True)
                    continue
            print(json.dumps({"plant": plant, "seed": seed,
                              "correct": res["correct"],
                              "numbers": res["numbers"],
                              "facts": res["facts"],
                              "rate": harness.metrics_of(
                                  bench, args.workload, False,
                                  res["obs"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
