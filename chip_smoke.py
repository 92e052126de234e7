"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero and prints
no result line):
1. environment: the card (nvidia-smi name and power limit), torch/CUDA
   versions, whether the native host aligner loaded;
2. build the CUDA kernels from ccs_tpu_torch/csrc into ccs_tpu_torch/build;
3. each kernel against its plain PyTorch version on the card, at the
   production shapes (2048 windows x 16 subreads, T=44, R=39, simulator
   reads, about a third of positions flagged), with their median times;
4. the CLI main path (``ccs_tpu_torch.cli.run``) on 400 simulated 2 kb
   10-pass ZMWs, then on a subset with --disable-heuristics; checks the
   report, the BAM, and that both kernels were launched; then times the
   400-ZMW run once more with the prepare pool warm;
5. the GPU engine against the CPU engine (plain versions) on 16 ZMWs.
The second-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
T_CAP, R_CAP, W, C = 44, 39, 2048, 16
E2E_ZMWS, E2E_INSERT, E2E_PASSES, E2E_SNR = 400, 2000, 10, 9.0
DENSE_SUBSET = 24
ENGINE_ZMWS = 16
LL0_TOL, LLS_TOL, QV_TOL = 2e-3, 5e-3, 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_environment():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    from ccs_tpu import native
    log(f"native host aligner loaded: {native.load() is not None}")


def phase_build():
    from ccs_tpu_torch.ops import _build
    t0 = time.monotonic()
    path = _build.build()
    log(f"kernels built in {time.monotonic() - t0:.1f} s -> "
        f"{os.path.relpath(path, ROOT)}")
    if _build.build_log:
        for line in _build.build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas: {line.strip()}")
    g, smem = _build.launch_shape(T_CAP, C, R_CAP)
    log(f"launch shape at T={T_CAP} C={C} R={R_CAP}: {g} reads per group, "
        f"{smem} B dynamic shared memory per CTA")


def window_batch(rng, params):
    """Production-shape windows as bench.py builds them: simulator reads at
    snr bin 4, 0-1 injected template errors, pileup-vote candidate masks."""
    import numpy as np
    from ccs_tpu.pipeline.draft import _pileup_consensus
    from ccs_tpu.pipeline.windows import candidate_priority_from_stats
    from ccs_tpu.sim.simulator import simulate_read
    tpl = np.full((W, T_CAP), -1, np.int8)
    tlen = np.zeros(W, np.int32)
    reads = np.full((W, C, R_CAP), -1, np.int8)
    rlens = np.full((W, C), -1, np.int32)
    cand = np.zeros((W, T_CAP), bool)
    for b in range(W):
        tl = int(rng.integers(26, 33))
        t = rng.integers(0, 4, tl).astype(np.int8)
        corrupt = t.copy()
        for _ in range(int(rng.integers(0, 2))):
            p = int(rng.integers(0, tl))
            corrupt[p] = (corrupt[p] + 1) % 4
        tpl[b, :tl] = corrupt
        tlen[b] = tl
        for c in range(C):
            r = simulate_read(t, params, 4, rng)[:R_CAP]
            reads[b, c, :len(r)] = r
            rlens[b, c] = len(r)
        rds = [reads[b, c, :rlens[b, c]] for c in range(C) if rlens[b, c] > 0]
        _d, _m, _i, _w, st, _r = _pileup_consensus(corrupt, rds,
                                                   want_stats=True)
        if st is not None and len(st) == tl:
            cand[b, :tl] = candidate_priority_from_stats(corrupt, st) > 0
        else:                       # no pileup stats: bench.py keeps all
            cand[b, :tl] = True
    snr_bin = np.full(W, 4, np.int32)
    return tpl, tlen, snr_bin, reads, rlens, cand


def _median_ms(fn, reps: int) -> float:
    import torch
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def phase_kernels(params, tables):
    """Kernel vs plain version on the card; returns the per-kernel rows."""
    import numpy as np
    import torch
    from ccs_tpu_torch.ops import hmm_score
    from ccs_tpu_torch.pipeline.polish_fused import mutation_valid_new
    dev = torch.device("cuda")
    t0 = time.monotonic()
    arrs = window_batch(np.random.default_rng(0), params)
    tpl, tlen, snr_bin, reads, rlens, cand = (
        torch.from_numpy(a).to(dev) for a in arrs)
    log(f"simulated {W} windows x {C} subreads in "
        f"{time.monotonic() - t0:.1f} s; candidate positions "
        f"{float(cand.sum()) / float(tlen.sum()):.3f} of template")
    valid = mutation_valid_new(tpl, tlen)
    T = T_CAP
    rows = []
    for name, kern, plain, extra in (
            ("hmm_score_dense", hmm_score.score_dense,
             hmm_score.score_dense_plain, ()),
            ("hmm_score_sparse", hmm_score.score_sparse,
             hmm_score.score_sparse_plain, (cand,))):
        args = (tpl, tlen, snr_bin, reads, rlens) + extra + (tables,)
        lls_k, ll0_k = kern(*args)
        torch.cuda.synchronize()
        lls_p, ll0_p = plain(*args)
        if not (torch.isfinite(lls_k).all() and torch.isfinite(ll0_k).all()):
            raise RuntimeError(f"{name}: non-finite kernel output")
        if lls_k.shape != (W, 9 * T + 4) or ll0_k.shape != (W,):
            raise RuntimeError(f"{name}: wrong output shapes")
        d0 = float((ll0_k - ll0_p).abs().max())
        if extra:
            bridged = hmm_score.scored_slots(tpl, tlen, cand)
            ok = valid & bridged
            unbridged = ~bridged
            unbridged[:, 9 * T:] = False
            nz = int((lls_k[unbridged] != 0).sum())
            if nz:
                raise RuntimeError(f"{name}: {nz} unbridged slots are not 0")
        else:
            ok = valid
        d = float(torch.where(ok, (lls_k - lls_p).abs(), 0.0).max())
        log(f"{name}: max |ll0 kernel - plain| = {d0:.3g} (bar {LL0_TOL}), "
            f"max |lls kernel - plain| over valid slots = {d:.3g} "
            f"(bar {LLS_TOL})")
        if not (d0 <= LL0_TOL and d <= LLS_TOL):
            raise RuntimeError(f"{name}: kernel disagrees with plain version")
        # reruns are bit-identical (fixed-order sums, no atomics)
        lls_k2, ll0_k2 = kern(*args)
        if not (torch.equal(lls_k, lls_k2) and torch.equal(ll0_k, ll0_k2)):
            raise RuntimeError(f"{name}: rerun is not bit-identical")
        ms = _median_ms(lambda: kern(*args), 11)
        plain_ms = _median_ms(lambda: plain(*args), 3)
        log(f"{name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
            f"(median, {W} windows x {C} subreads)")
        rows.append({"name": name, "route": "cuda",
                     "source": "ccs_tpu_torch/csrc/hmm_score.cu",
                     "replaces": ("ccs_tpu/ops/hmm_score_pallas.py:582"
                                  if extra else
                                  "ccs_tpu/ops/hmm_score_pallas.py:151"),
                     "launches": 0, "max_abs_err": max(d0, d),
                     "ms": ms, "plain_ms": plain_ms})
    return rows


class _WallSplit(logging.Handler):
    """Keeps the arguments of the CLI's last 'wall split' log record."""

    args = None

    def emit(self, record):
        if record.getMessage().startswith("wall split"):
            self.args = record.args


def _read_report(path: str) -> dict:
    out = {}
    with open(path) as fh:
        for line in fh:
            k, _, v = line.partition(":")
            if v.split() and v.split()[0].isdigit():
                out.setdefault(k.strip(), int(v.split()[0]))
    return out


def phase_main_path(sims, workdir):
    from ccs_tpu.io.bam import BamReader
    from ccs_tpu.sim.simulator import write_subreads_bam
    from ccs_tpu_torch import cli
    from ccs_tpu_torch.ops import hmm_score
    in_bam = os.path.join(workdir, "in.subreads.bam")
    sub_bam = os.path.join(workdir, "subset.subreads.bam")
    write_subreads_bam(in_bam, sims)
    write_subreads_bam(sub_bam, sims[:DENSE_SUBSET])
    cap = _WallSplit(level=logging.INFO)
    logging.getLogger("ccs_tpu").addHandler(cap)

    # the main path's run: counters from 0, then default + dense runs
    hmm_score.score_dense.launches = 0
    hmm_score.score_sparse.launches = 0
    out_bam = os.path.join(workdir, "out.bam")
    t0 = time.monotonic()
    rc = cli.run([in_bam, out_bam, "--log-level", "INFO"])
    dt = time.monotonic() - t0
    if rc != 0:
        raise RuntimeError(f"cli.run returned {rc}")
    split = cap.args
    rc = cli.run([sub_bam, os.path.join(workdir, "dense.bam"),
                  "--disable-heuristics", "--log-level", "INFO"])
    if rc != 0:
        raise RuntimeError(f"cli.run --disable-heuristics returned {rc}")
    launches = {"hmm_score_dense": hmm_score.score_dense.launches,
                "hmm_score_sparse": hmm_score.score_sparse.launches}
    # the same run again: the prepare pool, spawned by the first run, is warm
    t0 = time.monotonic()
    rc = cli.run([in_bam, os.path.join(workdir, "warm.bam"),
                  "--log-level", "INFO"])
    dt_warm = time.monotonic() - t0
    if rc != 0:
        raise RuntimeError(f"warm cli.run returned {rc}")
    split_warm = cap.args
    logging.getLogger("ccs_tpu").removeHandler(cap)

    rep = _read_report(os.path.join(workdir, "out.ccs_report.txt"))
    with BamReader(out_bam) as r:
        n_rec = sum(1 for _ in r)
    n_in, n_pass = rep["ZMWs input"], rep["ZMWs pass filters"]
    for name, t, sp in (("first run, spawns the prepare pool", dt, split),
                        ("second run, warm pool", dt_warm, split_warm)):
        log(f"main path ({name}): {n_in} ZMWs in {t:.3f} s = "
            f"{n_in / t:.2f} ZMW/s; wall split prepare {sp[0]:.3f} "
            f"thread-s, device {sp[1]:.3f} s, busy {sp[2]:.3f} s, "
            f"finalize {sp[3]:.3f} s")
    log(f"main path: {n_pass} SUCCESS, {n_rec} BAM records")
    log(f"kernel launches in the main path: {launches}")
    if n_in != E2E_ZMWS or n_pass < 0.99 * n_in:
        raise RuntimeError(f"only {n_pass}/{n_in} ZMWs succeeded")
    if n_rec != n_pass:
        raise RuntimeError(f"{n_rec} BAM records but {n_pass} in the report")
    for k, v in launches.items():
        if v <= 0:
            raise RuntimeError(f"{k} was not launched in the main path")
    return launches


def _zin(z):
    from ccs_tpu.pipeline.zmw import Subread, ZmwInput
    subs, qpos = [], 0
    for read, cx in zip(z.subreads, z.cx):
        subs.append(Subread(seq=read, cx=cx, qs=qpos, qe=qpos + len(read)))
        qpos += len(read) + 40
    return ZmwInput(hole=z.hole, movie="m_smoke", subreads=subs, snr=z.snr)


def phase_gpu_vs_cpu(sims, params):
    import numpy as np
    from ccs_tpu.config import CcsConfig
    from ccs_tpu_torch.pipeline.engine import CcsEngine
    zmws = [_zin(z) for z in sims[:ENGINE_ZMWS]]
    # 256-window chunks keep the CPU side's padding rows few
    cfg = CcsConfig(tpu_window_buckets=(256,))
    t0 = time.monotonic()
    res_g = CcsEngine(cfg, params, "cuda").process_batch(zmws)
    t1 = time.monotonic()
    res_c = CcsEngine(cfg, params, "cpu").process_batch(zmws)
    t2 = time.monotonic()
    worst = 0.0
    for a, b in zip(res_g, res_c):
        if a.status != b.status:
            raise RuntimeError(f"hole {a.hole}: {a.status} vs {b.status}")
        if (a.seq is None) != (b.seq is None) or (
                a.seq is not None and not np.array_equal(a.seq, b.seq)):
            raise RuntimeError(f"hole {a.hole}: sequences differ")
        if a.qv is not None:
            worst = max(worst, float(np.abs(a.qv - b.qv).max()))
    if worst > QV_TOL:
        raise RuntimeError(f"QVs differ by {worst} > {QV_TOL}")
    log(f"GPU engine == CPU engine on {len(zmws)} ZMWs: statuses and "
        f"sequences identical, max |QV diff| {worst:.3g} (bar {QV_TOL}); "
        f"GPU {t1 - t0:.1f} s, CPU {t2 - t1:.1f} s")


def main() -> int:
    phase_environment()
    import numpy as np
    import torch
    from ccs_tpu.models.chemistry import default_params, load_model
    from ccs_tpu.sim.simulator import make_subreads_header, simulate_zmw
    from ccs_tpu_torch.ops.tables import params_to_torch
    from ccs_tpu_torch.pipeline.orchestrator import shutdown_pool
    phase_build()
    rows = phase_kernels(default_params(),
                         params_to_torch(default_params(), "cuda"))
    t0 = time.monotonic()
    sims = [simulate_zmw(hole=h, insert_len=E2E_INSERT, n_passes=E2E_PASSES,
                         snr=E2E_SNR) for h in range(E2E_ZMWS)]
    log(f"simulated {E2E_ZMWS} x {E2E_INSERT // 1000} kb {E2E_PASSES}-pass "
        f"ZMWs in {time.monotonic() - t0:.1f} s")
    # scratch files stay inside the checkout, in the ignored build dir
    scratch = os.path.join(ROOT, "ccs_tpu_torch", "build")
    os.makedirs(scratch, exist_ok=True)
    try:
        with tempfile.TemporaryDirectory(dir=scratch) as workdir:
            launches = phase_main_path(sims, workdir)
        # the CLI resolves the model from the BAM's chemistry; use the same
        params = load_model(make_subreads_header().chemistry())
        phase_gpu_vs_cpu(sims, params)
    finally:
        shutdown_pool()
    for row in rows:
        row["launches"] = launches[row["name"]]
    if "jax" in sys.modules:
        raise RuntimeError("the port's main path imported jax")
    if not np.isfinite([r["ms"] for r in rows]).all():
        raise RuntimeError("kernel timing failed")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
