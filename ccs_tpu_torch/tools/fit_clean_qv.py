"""Fit the clean-position p_err table (``models/data/clean_perr_v0.npy``).

Counterpart of the JAX package's ``tools/fit_clean_qv.py``. In
candidate-sparse mode unflagged positions carry no mutation scores; their
per-base p_err comes from a table keyed by (snr_bin, coverage)
(``pipeline.polish_fused.clean_perr``). This tool measures it: simulate
windows across the SNR x pass-count grid, polish them with DENSE scoring
(on a CUDA device the dense scorer kernel) and the production candidate
priorities, and average the dense-scored p_err at NON-candidate core
positions per (snr_bin, coverage) cell. A log-linear fit in coverage fills
the cells the sample leaves empty.

Run: ``python -m ccs_tpu_torch.tools.fit_clean_qv [--fast] [--out PATH]
[--device DEV]`` (the CUDA device unless ``--device`` names another;
without CUDA and without ``--device`` it raises). It writes ``--out``
(default ./clean_perr_v0.npy) and never the shipped table.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

# the JAX tool's grid: SNRs, passes, windows x subreads per cell
SNRS, PASSES, BP = (7.0, 9.0, 11.0), (4, 6, 10, 16, 22), 256
FAST_SNRS, FAST_PASSES, FAST_BP = (7.0, 9.0), (6, 10), 64
CP, HOLES, INSERT_LEN, MAX_ITERS = 24, 4, 700, 30


def _zin(z):
    from ccs_tpu_torch.pipeline.zmw import Subread, ZmwInput
    subs, qpos = [], 0
    for read, cx in zip(z.subreads, z.cx):
        subs.append(Subread(seq=read, cx=cx, qs=qpos, qe=qpos + len(read)))
        qpos += len(read) + 40
    return ZmwInput(hole=z.hole, movie="m", subreads=subs, snr=z.snr)


def cell_windows(snr: float, n_passes: int, bp: int, cp: int = CP):
    """The windows of one grid cell as the JAX tool builds them: the
    prepared windows of HOLES simulated 700 bp ZMWs, the first ``bp`` of
    them, padded to [bp, cp] subread lanes. Returns (arrays dict, count of
    real windows)."""
    from ccs_tpu_torch.config import CcsConfig
    from ccs_tpu_torch.models.chemistry import default_params
    from ccs_tpu_torch.pipeline.zmw import prepare_zmw
    from ccs_tpu_torch.sim.simulator import simulate_zmw
    cfg, params = CcsConfig(), default_params()
    TC, RC = cfg.tpu_window_tpl_cap, cfg.tpu_window_read_cap
    wins = []
    for h in range(HOLES):
        z = _zin(simulate_zmw(hole=h + int(snr * 100) + n_passes * 7,
                              insert_len=INSERT_LEN, n_passes=n_passes,
                              snr=snr))
        item = prepare_zmw(z, cfg, params.snr_edges, params=params)
        if item.terminal:
            continue
        b = item.batch
        for w in range(len(b.windows)):
            wins.append((b.tpl[w], b.tlen[w], item.snr_bin, b.reads[w],
                         b.rlens[w], b.core_start[w], b.core_end[w],
                         b.priority[w]))
    wins = wins[:bp]
    a = dict(tpl=np.full((bp, TC), -1, np.int8), tlen=np.ones(bp, np.int32),
             snr_bin=np.zeros(bp, np.int32),
             reads=np.full((bp, cp, RC), -1, np.int8),
             rlens=np.full((bp, cp), -1, np.int32),
             cs=np.zeros(bp, np.int32), ce=np.zeros(bp, np.int32),
             pri=np.zeros((bp, TC), np.float32))
    for i, w in enumerate(wins):
        a["tpl"][i], a["tlen"][i], a["snr_bin"][i] = w[0], w[1], w[2]
        c = min(w[3].shape[0], cp)
        a["reads"][i, :c] = w[3][:c]
        a["rlens"][i, :c] = w[4][:c]
        a["cs"][i], a["ce"][i], a["pri"][i] = w[5], w[6], w[7]
    return a, len(wins)


def cell_rows(a: dict, n: int, p_err, priority, core_start, core_end,
              rows: dict) -> None:
    """Add the core-only p_err at non-candidate positions of the first n
    windows to ``rows[(snr_bin, coverage)]``. Core only: window margins
    accumulate boundary artifacts with p_err ~ 1 that never reach the
    stitched consensus, and the table must price what is emitted."""
    cov = (a["rlens"] >= 0).sum(1)
    for i in range(n):
        lo, hi = int(core_start[i]), int(core_end[i])
        mask = priority[i, lo:hi] == 0
        rows.setdefault((int(a["snr_bin"][i]), int(cov[i])), []).append(
            p_err[i, lo:hi][mask])


def measure(fast: bool = False, device=None, snrs=None, passes=None,
            bp=None, cp: int = CP, log=print) -> dict:
    """{(snr_bin, coverage): p_err samples} over the grid (the JAX tool's
    unless ``snrs``/``passes``/``bp`` name others), polished with dense
    scoring on ``device`` (the CUDA device when None; raises without
    CUDA)."""
    import torch
    from ccs_tpu_torch.cli import resolve_device
    from ccs_tpu_torch.models.chemistry import default_params
    from ccs_tpu_torch.ops.tables import params_to_torch
    from ccs_tpu_torch.pipeline.polish_fused import polish_windows_fused
    dev = resolve_device(device)[0]
    tables = params_to_torch(default_params(), dev)
    snrs = snrs or (FAST_SNRS if fast else SNRS)
    passes = passes or (FAST_PASSES if fast else PASSES)
    bp = bp or (FAST_BP if fast else BP)
    rows: dict = {}
    for snr in snrs:
        for n_passes in passes:
            a, n = cell_windows(snr, n_passes, bp, cp)
            if not n:
                continue
            t = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
            state, _qv, p_err = polish_windows_fused(
                t["tpl"], t["tlen"], t["cs"], t["ce"], t["snr_bin"],
                t["reads"], t["rlens"], tables, max_iters=MAX_ITERS,
                priority=t["pri"], compact=True)
            cell_rows(a, n, p_err.cpu().numpy(),
                      state.priority.cpu().numpy(),
                      state.core_start.cpu().numpy(),
                      state.core_end.cpu().numpy(), rows)
            log(f"# snr={snr} P={n_passes}: {n} windows")
    return {k: np.concatenate(v) for k, v in rows.items()}


def fit_table(rows: dict, cov_cap: int = 40) -> np.ndarray:
    """Per-snr log-linear fit log10(p) = a + b*cov through the measured
    cell means (>= 80 samples), evaluated on the full grid and floored by
    the measurements where present."""
    out = np.zeros((8, cov_cap + 1), np.float32)
    for s in range(8):
        pts = [(c, v.mean()) for (sb, c), v in rows.items()
               if sb == s and len(v) >= 80]
        if len(pts) < 2:
            # no data at this snr bin: borrow the nearest measured bin
            near = min({sb for sb, _ in rows}, key=lambda x: abs(x - s),
                       default=None)
            pts = [(c, v.mean()) for (sb, c), v in rows.items()
                   if sb == near and len(v) >= 80]
        cv = np.asarray([p[0] for p in pts], np.float64)
        lp = np.log10(np.maximum([p[1] for p in pts], 1e-12))
        b, a = np.polyfit(cv, lp, 1)
        grid = np.arange(cov_cap + 1, dtype=np.float64)
        out[s] = np.minimum(10.0 ** (a + b * grid), 0.25)
        for c, m in pts:  # measured cells override the fit
            if c <= cov_cap:
                out[s, c] = min(m, 0.25)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ccs_tpu_torch.tools.fit_clean_qv",
        description="Fit the clean-position p_err table.")
    ap.add_argument("--fast", action="store_true",
                    help="the smoke grid: 2 SNRs x 2 pass counts, 64 windows")
    ap.add_argument("--out", default="clean_perr_v0.npy",
                    help="where to write the table (default: "
                         "./clean_perr_v0.npy)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    from ccs_tpu_torch.ops.tables import CLEAN_PERR_PATH
    if os.path.realpath(args.out) == os.path.realpath(CLEAN_PERR_PATH):
        ap.error("--out names the shipped table; write the new one elsewhere")
    rows = measure(fast=args.fast, device=args.device)
    for (s, c), v in sorted(rows.items()):
        if len(v) >= 80:
            print(f"# snr_bin={s} cov={c}: n={len(v)} mean={v.mean():.3e} "
                  f"QV={-10*np.log10(max(v.mean(), 1e-9)):.1f}")
    tab = fit_table(rows)
    np.set_printoptions(threshold=10_000)
    print("# clean_perr table (snr bin x coverage 0..40):")
    print(repr(tab.tolist()))
    np.save(args.out, tab)
    print(f"# saved {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
