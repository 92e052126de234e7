"""Time the PyTorch port's engine over one card, two shards of one card, two
cards and four cards, on chip_smoke.py's ZMWs (400 x 2 kb, 10 passes, SNR
9).

    python3 tools/torch_mesh_scaling.py [--repeats 2]

Every configuration drives ``ccs_tpu_torch``'s engine through the
orchestrator (the warm prepare pool) on the same ZMWs and must equal the
one-card run: statuses and sequences identical, QVs within 1e-3, polish
counters equal. Prints the card's name and power limit, one JSON line per
run (wall seconds, device step ``t_device``, ZMW/s) and one summary line
with each configuration's median against one card's. Needs a CUDA card;
a configuration that needs more cards than are visible is skipped.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = (("1 card", (0,)), ("2 shards of 1 card", (0, 0)),
           ("2 cards", (0, 1)), ("4 cards", (0, 1, 2, 3)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from ccs_tpu_torch.config import CcsConfig
    from ccs_tpu_torch.models.chemistry import load_model
    from ccs_tpu_torch.ops import _build
    from ccs_tpu_torch.pipeline.orchestrator import shutdown_pool
    from ccs_tpu_torch.sim.simulator import make_subreads_header, simulate_zmw
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    _build.build()
    params = load_model(make_subreads_header().chemistry())
    zmws = [cs._zin(simulate_zmw(hole=h, insert_len=cs.E2E_INSERT,
                                 n_passes=cs.E2E_PASSES, snr=cs.E2E_SNR))
            for h in range(cs.E2E_ZMWS)]
    n_cards = torch.cuda.device_count()
    configs = [(name, ids) for name, ids in CONFIGS if max(ids) < n_cards]
    cfg = CcsConfig()
    rows = []
    try:
        # the reference run; it also spawns the prepare pool
        ref_eng, ref, _wall = cs._pipeline_run(zmws, cfg, params,
                                               [torch.device("cuda", 0)])
        for rep in range(args.repeats):
            for name, ids in (configs if rep % 2 == 0 else configs[::-1]):
                eng, res, wall = cs._pipeline_run(
                    zmws, cfg, params, [torch.device("cuda", i) for i in ids])
                cs._same_results(res, ref, name)
                if not np.array_equal(eng.polish_stats, ref_eng.polish_stats):
                    raise RuntimeError(f"{name}: polish_stats "
                                       f"{eng.polish_stats} vs "
                                       f"{ref_eng.polish_stats}")
                rows.append({"config": name, "devices": list(ids),
                             "run": rep, "wall_s": wall,
                             "device_s": eng.t_device,
                             "zmw_per_s": len(zmws) / wall})
                print(json.dumps(rows[-1]), flush=True)
    finally:
        shutdown_pool()
    med = {name: (float(np.median([r["wall_s"] for r in rows
                                   if r["config"] == name])),
                  float(np.median([r["device_s"] for r in rows
                                   if r["config"] == name])))
           for name, _ids in configs}
    one_wall, one_dev = med["1 card"]
    print(json.dumps({"cards_visible": n_cards, "zmws": len(zmws),
                      "median": {k: {"wall_s": w, "device_s": d,
                                     "wall_vs_1_card": one_wall / w,
                                     "device_vs_1_card": one_dev / d}
                                 for k, (w, d) in med.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
