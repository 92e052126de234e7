"""Train and audit a DC-refinement model on a torch device.

Run: ``python -m ccs_tpu_torch.models.train_dc [out.npz] [--device DEV]``
(the CUDA device unless ``--device`` names another; with no ``out.npz`` it
writes ``models/data/dc_v0.npz``).

Counterpart of ``ccs_tpu.models.train_dc``: trains the DeepConsensus-style
window refiner under chemistry mismatch (the condition it exists for,
revio.md:29-53), calibrates its confidence threshold on held-out data, and
refuses to write an artifact whose error head does not separate Arrow's
residual errors from clean positions, with the same shipping criteria.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from ccs_tpu_torch.models import dc_polisher as dc
from ccs_tpu_torch.models.chemistry import default_params


def mismatch_chemistry(scale_ins: float = 1.8, scale_del: float = 2.2):
    p = default_params()
    trans = p.trans.copy()
    trans[..., 1] *= scale_ins
    trans[..., 2] *= scale_ins
    trans[..., 3] *= scale_del
    trans /= trans.sum(-1, keepdims=True)
    return dataclasses.replace(p, trans=trans)


def main(out: str | None = None, device=None) -> int:
    import os

    from ccs_tpu_torch.cli import resolve_device
    device = resolve_device(device)[0]
    out = out or os.path.join(os.path.dirname(__file__), "data", "dc_v0.npz")
    log = lambda m: print(f"# {m}", file=sys.stderr, flush=True)  # noqa: E731
    true_chem = mismatch_chemistry()
    score_chem = default_params()
    model = dc.train(true_chem, score_chem, steps=1500, n_windows=256,
                     hidden=64, ctx=2, batches=12, seed=7, log=log,
                     device=device)
    # Shipping criteria:
    # 1. TEMPLATE EDITS ship only if the calibrated threshold strictly
    #    reduced held-out errors (else calibration pins conf=inf and
    #    refine_chunk never edits).
    # 2. The ERROR HEAD ships on its own merit: under chemistry mismatch it
    #    must separate Arrow's residual errors from clean positions, the rq
    #    recalibration role of the Revio DC stage (revio.md:41-44).
    rng = np.random.default_rng(4242)
    state, _qv, _cov, feats, labels, _w, truths = dc.make_training_batch(
        256, true_chem, score_chem, rng, device=device)
    disc, mass_ratio = dc.err_head_quality(model, state, feats, labels)
    log(f"err head held-out: discrimination {disc:.1f}x, "
        f"mass ratio {mass_ratio:.2f}")
    if np.isfinite(model.conf):
        err_base, err_dc = audit(model, true_chem, score_chem, seed=4243,
                                 log=log, device=device)
        if not err_dc < err_base:
            log(f"edit path failed audit ({err_base} -> {err_dc}); "
                "disabling edits (conf=inf)")
            model.conf = float("inf")
    if not (disc >= 5.0 and 0.4 <= mass_ratio <= 2.5):
        log("REFUSING to ship: error head not discriminative/calibrated")
        return 1
    model.save(out)
    log(f"wrote {out} (conf={model.conf} [inf = QV-recalibration only], "
        f"err-head disc {disc:.1f}x, mass {mass_ratio:.2f})")
    return 0


def audit(model, true_chem, score_chem, seed: int, log=None, device=None):
    rng = np.random.default_rng(seed)
    state, _qv, _cov, feats, _labels, _w, truths = dc.make_training_batch(
        256, true_chem, score_chem, rng, device=device)
    base = dc.residual_errors(dc._numpy(state.tpl), dc._numpy(state.tlen),
                              truths)
    with torch.no_grad():
        cls, _err = dc.dc_forward(model.module(feats.device), feats,
                                  model.ctx)
    ntpl, nlen, _cs, _ce, _ap = dc.apply_corrections(
        state.tpl, state.tlen, state.core_start, state.core_end, cls,
        torch.ones(len(truths), dtype=torch.bool, device=feats.device),
        conf_thresh=model.conf, allow_sub=bool(model.sub_ok))
    refined = dc.residual_errors(dc._numpy(ntpl), dc._numpy(nlen), truths)
    if log:
        log(f"audit: base {base} -> refined {refined}")
    return base, refined


if __name__ == "__main__":
    ap = argparse.ArgumentParser(
        prog="python -m ccs_tpu_torch.models.train_dc")
    ap.add_argument("out", nargs="?", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    a = ap.parse_args()
    sys.exit(main(a.out, a.device))
