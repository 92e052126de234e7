"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero and prints
no result line):
1. environment: the card (nvidia-smi name and power limit), torch/CUDA
   versions; the port's native host aligner must load (with the NumPy
   fallbacks every time below would describe another program);
2. build the CUDA kernels from ccs_tpu_torch/csrc into ccs_tpu_torch/build;
3. each kernel against its plain PyTorch version on the card, with their
   median times: the two scorers at the production shapes (2048 windows x
   16 subreads, T=44, R=39, simulator reads, about a third of positions
   flagged), with the launch shape the library chose and the split of
   their time between column sweeps and bridges; the scorers again at
   the edge shapes of the lane-tiled sweep (1, 8 and 32 subreads, read
   lengths around the 32-lane boundary, empty and dead reads, templates of
   0, 1 and T bases, other caps, no and all candidates); the banded edit
   distance on every subread of the 400 simulated ZMWs against its ZMW's
   true insert (band 64, one launch), also against the dense oracle, then
   driven once through its entry point with its launches counted;
4. the CLI main path (``ccs_tpu_torch.cli.run``) on 400 simulated 2 kb
   10-pass ZMWs, then on a subset with --disable-heuristics; checks the
   report, the BAM, and that both kernels were launched; then times the
   400-ZMW run once more with the prepare pool warm;
5. the GPU engine against the CPU engine (plain versions) on 16 ZMWs.
The second-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.

``bound_ms`` of a kernel is the least time the card could take for the same
work on this run's inputs: the larger of bytes moved (every input and
output tensor once) over the memory rate and operations over the peak rate
of their type outside the tensor cores. The peaks are NVIDIA's published
H100 SXM figures at the full 700 W power limit.
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
EDIT_BAND, EDIT_ORACLE_PAIRS = 64, 8
# H100 SXM peaks: HBM3 bytes/s; float32 FLOP/s outside the tensor cores
# (128 lanes x 2 per FMA per SM); int32 op/s (64 lanes per SM, no FMA: a
# quarter of the float32 figure)
HBM_BYTES_S, FP32_FLOP_S, INT32_OP_S = 3.35e12, 67e12, 16.75e12
# float32 operations per cell of the scorer's recurrences as hmm_score.cu
# writes them: a column step (forward or backward) and a three-operator
# bridge step; integer operations per cell of the edit-distance recurrence
SWEEP_FLOPS, BRIDGE_FLOPS, EDIT_OPS = 21, 59, 8


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
    from ccs_tpu_torch import native
    if native.load() is None:
        raise RuntimeError("the port's native host aligner did not load "
                           "(g++ build failed or CCS_TPU_NO_NATIVE is set)")
    log("native host aligner loaded: True")


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
    log(f"launch shape at T={T_CAP} C={C} R={R_CAP}: {_shape_text()}")


def _shape_text() -> str:
    from ccs_tpu_torch.ops import _build
    g, smem, threads, ctas = _build.launch_shape(T_CAP, C, R_CAP)
    return (f"{threads} threads per CTA, {g} reads per group, {smem} B "
            f"dynamic shared memory per CTA, {ctas} CTAs per SM")


def window_batch(rng, params):
    """Production-shape windows as bench.py builds them: simulator reads at
    snr bin 4, 0-1 injected template errors, pileup-vote candidate masks."""
    import numpy as np
    from ccs_tpu_torch.pipeline.draft import _pileup_consensus
    from ccs_tpu_torch.pipeline.windows import candidate_priority_from_stats
    from ccs_tpu_torch.sim.simulator import simulate_read
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


def _bound(ops: float, peak: float, nbytes: int) -> tuple[float, str]:
    """(bound_ms, bound_by) from an operation count and the bytes moved."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _scorer_flops(tlen, rlens, cand) -> float:
    """float32 operations the scorer needs for these windows: per live
    subread of rl bases, 2*tl+1 column steps and 8 bridges per scored
    position (+4 prepends), each over rl+1 cells."""
    import numpy as np
    tl = tlen.astype(np.int64)
    cells = np.where(rlens >= 0, np.minimum(rlens, R_CAP) + 1, 0).sum(axis=1)
    pos_ok = np.arange(T_CAP)[None, :] < tl[:, None]
    npos = (pos_ok if cand is None else pos_ok & cand).sum(axis=1)
    return float((cells * (SWEEP_FLOPS * (2 * tl + 1)
                           + BRIDGE_FLOPS * (8 * npos + 4))).sum())


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
        bound_ms, bound_by = _bound(
            _scorer_flops(arrs[1], arrs[4], arrs[5] if extra else None),
            FP32_FLOP_S, _nbytes(*args[:-1], tables["ctx"], tables["pw"],
                                 lls_k, ll0_k))
        log(f"{name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
            f"(median, {W} windows x {C} subreads); bound {bound_ms:.4f} ms "
            f"by {bound_by}")
        rows.append({"name": name, "route": "cuda",
                     "source": "ccs_tpu_torch/csrc/hmm_score.cu",
                     "replaces": ("ccs_tpu/ops/hmm_score_pallas.py:582"
                                  if extra else
                                  "ccs_tpu/ops/hmm_score_pallas.py:151"),
                     "launches": 0, "max_abs_err": max(d0, d),
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None})
    _sweep_bridge_split(rows, tpl, tlen, snr_bin, reads, rlens, cand, tables)
    return rows


def _sweep_bridge_split(rows, tpl, tlen, snr_bin, reads, rlens, cand, tables):
    """How a scorer's time splits: a sparse launch with no candidate does
    everything but the positions' bridges (staging, both column sweeps of
    every subread, the 4 prepend bridges, the output row)."""
    import torch
    from ccs_tpu_torch.ops import hmm_score
    none = torch.zeros_like(cand)
    sweep_ms = _median_ms(lambda: hmm_score.score_sparse(
        tpl, tlen, snr_bin, reads, rlens, none, tables), 11)
    log(f"scorer without candidates (sweeps, staging, prepends): "
        f"{sweep_ms:.3f} ms; bridges of the positions: dense "
        f"{rows[0]['ms'] - sweep_ms:.3f} ms, sparse "
        f"{rows[1]['ms'] - sweep_ms:.3f} ms")


EDGE_CAPS = ((1, T_CAP, R_CAP), (8, T_CAP, R_CAP), (32, T_CAP, R_CAP),
             (16, 30, 24), (4, 20, 70))     # (C, T, R)


def phase_scorer_edges(params):
    """Both scorers against their plain versions at the edge shapes, with
    non-trivial pulse-width factors; same bars as at the production shape."""
    import copy
    import numpy as np
    import torch
    from ccs_tpu_torch.ops import hmm_score
    from ccs_tpu_torch.ops.tables import params_to_torch
    from ccs_tpu_torch.pipeline.polish_fused import mutation_valid_new
    from ccs_tpu_torch.sim.edges import edge_batch
    dev = torch.device("cuda")
    rng = np.random.default_rng(42)
    params = copy.deepcopy(params)
    params.pw_match = rng.uniform(0.6, 1.4, (8, 4)).astype(np.float32)
    params.pw_ins = rng.uniform(0.5, 2.0, (8, 4)).astype(np.float32)
    params.pw_match[:, 0] = params.pw_ins[:, 0] = 1.0
    tables = params_to_torch(params, dev)
    worst0 = worst = 0.0
    n_cases = 0
    for n_reads, t_cap, r_cap in EDGE_CAPS:
        arrs = edge_batch(rng, n_reads, t_cap, r_cap)
        args = tuple(torch.from_numpy(a).to(dev) for a in arrs)
        tpl, tlen = args[:2]
        valid = mutation_valid_new(tpl, tlen)
        some = torch.from_numpy(rng.random(arrs[0].shape) < 0.4).to(dev)
        for name, cand in (("dense", None), ("no candidate", some & False),
                           ("all candidates", some | True),
                           ("some candidates", some)):
            if cand is None:
                got = hmm_score.score_dense(*args, tables)
                again = hmm_score.score_dense(*args, tables)
                ref = hmm_score.score_dense_plain(*args, tables)
            else:
                got = hmm_score.score_sparse(*args, cand, tables)
                again = hmm_score.score_sparse(*args, cand, tables)
                ref = hmm_score.score_sparse_plain(*args, cand, tables)
            torch.cuda.synchronize()
            what = f"edge shapes C={n_reads} T={t_cap} R={r_cap}, {name}"
            if not (torch.isfinite(got[0]).all()
                    and torch.isfinite(got[1]).all()):
                raise RuntimeError(f"{what}: non-finite kernel output")
            if not (torch.equal(got[0], again[0])
                    and torch.equal(got[1], again[1])):
                raise RuntimeError(f"{what}: rerun is not bit-identical")
            scored = hmm_score.scored_slots(tpl, tlen, cand)
            if int((got[0][~scored] != 0).sum()):
                raise RuntimeError(f"{what}: unscored slots are not 0")
            d0 = float((got[1] - ref[1]).abs().max())
            d = float(torch.where(valid & scored, (got[0] - ref[0]).abs(),
                                  0.0).max())
            if not (d0 <= LL0_TOL and d <= LLS_TOL):
                raise RuntimeError(f"{what}: max |ll0 diff| {d0:.3g}, max "
                                   f"|lls diff| {d:.3g} exceed the bars")
            worst0, worst = max(worst0, d0), max(worst, d)
            n_cases += 1
    log(f"scorer edge shapes: {n_cases} cases over (C, T, R) in "
        f"{list(EDGE_CAPS)}: max |ll0 kernel - plain| = {worst0:.3g} (bar "
        f"{LL0_TOL}), max |lls kernel - plain| = {worst:.3g} (bar "
        f"{LLS_TOL}), unscored slots 0, reruns bit-identical")


def edit_pairs(sims):
    """Every subread of the simulated ZMWs, brought to the forward strand,
    against its ZMW's true insert: (tpl, tlen, reads, rlens) numpy arrays."""
    import numpy as np
    from ccs_tpu_torch.ops import dna
    pairs = [(dna.revcomp(read) if strand else read, z.insert)
             for z in sims for read, strand in zip(z.subreads, z.strands)]
    n = len(pairs)
    tlen = np.array([len(t) for _, t in pairs], np.int32)
    rlens = np.array([len(r) for r, _ in pairs], np.int32)
    tpl = np.full((n, int(tlen.max())), -1, np.int8)
    reads = np.full((n, int(rlens.max())), -1, np.int8)
    for b, (r, t) in enumerate(pairs):
        tpl[b, :len(t)] = t
        reads[b, :len(r)] = r
    return tpl, tlen, reads, rlens


def _edit_cells(tlen, rlens, band: int) -> float:
    """Cell updates the banded distance needs for these pairs: a pair whose
    lengths differ by more than the band is BIG from its lengths alone and
    needs none; any other needs, in each read row i of 1..rlen, the band's
    cells whose template position j lies in [0, tlen]."""
    import numpy as np
    cells = 0
    for tl, rl in zip(tlen.tolist(), rlens.tolist()):
        if abs(tl - rl) <= band:
            i = np.arange(1, rl + 1)
            cells += int(np.maximum(np.minimum(tl, i + band)
                                    - np.maximum(0, i - band) + 1, 0).sum())
    return float(cells)


def phase_edit_kernel(sims):
    """The banded edit-distance kernel against its plain version and the
    dense oracle at the 400-ZMW 2 kb size, then driven once through its
    entry point with its launches counted; returns its row."""
    import numpy as np
    import torch
    from ccs_tpu_torch.ops import align_banded
    from ccs_tpu_torch.ops.align_banded import BIG
    dev = torch.device("cuda")
    arrs = edit_pairs(sims)
    tpl, tlen, reads, rlens = arrs
    args = tuple(torch.from_numpy(a).to(dev) for a in arrs)
    kern = align_banded.edit_distance_banded

    def clip(d):                    # every value >= BIG/2 means "left the band"
        return torch.where(d >= BIG / 2, torch.full_like(d, BIG), d)

    got = kern(*args, band=EDIT_BAND)
    torch.cuda.synchronize()
    ref = align_banded.edit_distance_banded_plain(*args, band=EDIT_BAND)
    if got.shape != (len(tlen),) or got.dtype != torch.float32:
        raise RuntimeError("edit_distance_banded: wrong output shape or type")
    err = float((clip(got) - clip(ref)).abs().max())
    in_band = (got < BIG / 2).cpu().numpy()
    log(f"edit_distance_banded: {len(tlen)} pairs, TMAX {tpl.shape[1]}, "
        f"RMAX {reads.shape[1]}, band {EDIT_BAND}; in band "
        f"{in_band.mean():.4f} of pairs; max |kernel - plain| = {err:g} "
        f"(bar: exact)")
    if err != 0.0:
        raise RuntimeError("edit_distance_banded: kernel disagrees with "
                           "plain version")
    if not torch.equal(got, kern(*args, band=EDIT_BAND)):
        raise RuntimeError("edit_distance_banded: rerun is not bit-identical")
    checked = np.flatnonzero(in_band & (tlen >= E2E_INSERT))
    checked = checked[:: max(1, len(checked) // EDIT_ORACLE_PAIRS)]
    checked = checked[:EDIT_ORACLE_PAIRS]
    if len(checked) < EDIT_ORACLE_PAIRS:
        raise RuntimeError(f"only {len(checked)} in-band 2 kb pairs")
    got_np = got.cpu().numpy()
    for b in checked:
        want = align_banded.edit_distance_dense_oracle(
            reads[b, :rlens[b]], tpl[b, :tlen[b]])
        if got_np[b] != want:
            raise RuntimeError(f"edit_distance_banded: pair {b} gives "
                               f"{got_np[b]}, dense oracle {want}")
    log(f"edit_distance_banded: equal to the dense oracle on "
        f"{len(checked)} in-band 2 kb pairs (distances "
        f"{[int(got_np[b]) for b in checked]})")
    # a length difference beyond the band reports BIG; an empty read costs
    # its template's length
    edge = kern(torch.zeros((2, 40), dtype=torch.int8, device=dev),
                torch.tensor([40, 12], dtype=torch.int32, device=dev),
                torch.full((2, 8), -1, dtype=torch.int8, device=dev),
                torch.tensor([4, 0], dtype=torch.int32, device=dev), band=16)
    if not (float(edge[0]) >= BIG / 2 and float(edge[1]) == 12.0):
        raise RuntimeError(f"edit_distance_banded: edge cases give {edge}")

    ms = _median_ms(lambda: kern(*args, band=EDIT_BAND), 11)
    plain_ms = _median_ms(lambda: align_banded.edit_distance_banded_plain(
        *args, band=EDIT_BAND), 3)
    bound_ms, bound_by = _bound(
        EDIT_OPS * _edit_cells(tlen, rlens, EDIT_BAND), INT32_OP_S,
        _nbytes(*args, got))
    log(f"edit_distance_banded: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
        f"(median, {len(tlen)} pairs); bound {bound_ms:.4f} ms by {bound_by}")

    # this slice's path: the entry point, once, at this size
    kern.launches = 0
    driven = kern(*args, band=EDIT_BAND)
    torch.cuda.synchronize()
    launches = kern.launches
    if launches <= 0:
        raise RuntimeError("edit_distance_banded was not launched")
    if not torch.equal(driven, got):
        raise RuntimeError("edit_distance_banded: driven run differs")
    return {"name": "edit_distance_banded", "route": "cuda",
            "source": "ccs_tpu_torch/csrc/edit_banded.cu",
            "replaces": "ccs_tpu/ops/align_pallas.py:70",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


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
    from ccs_tpu_torch.io.bam import BamReader
    from ccs_tpu_torch.sim.simulator import write_subreads_bam
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
    from ccs_tpu_torch.pipeline.zmw import Subread, ZmwInput
    subs, qpos = [], 0
    for read, cx in zip(z.subreads, z.cx):
        subs.append(Subread(seq=read, cx=cx, qs=qpos, qe=qpos + len(read)))
        qpos += len(read) + 40
    return ZmwInput(hole=z.hole, movie="m_smoke", subreads=subs, snr=z.snr)


def phase_gpu_vs_cpu(sims, params):
    import numpy as np
    from ccs_tpu_torch.config import CcsConfig
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
    from ccs_tpu_torch.models.chemistry import default_params, load_model
    from ccs_tpu_torch.sim.simulator import make_subreads_header, simulate_zmw
    from ccs_tpu_torch.ops.tables import params_to_torch
    from ccs_tpu_torch.pipeline.orchestrator import shutdown_pool
    phase_build()
    rows = phase_kernels(default_params(),
                         params_to_torch(default_params(), "cuda"))
    phase_scorer_edges(default_params())
    t0 = time.monotonic()
    sims = [simulate_zmw(hole=h, insert_len=E2E_INSERT, n_passes=E2E_PASSES,
                         snr=E2E_SNR) for h in range(E2E_ZMWS)]
    log(f"simulated {E2E_ZMWS} x {E2E_INSERT // 1000} kb {E2E_PASSES}-pass "
        f"ZMWs in {time.monotonic() - t0:.1f} s")
    edit_row = phase_edit_kernel(sims)
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
    rows.append(edit_row)
    foreign = sorted(m for m in sys.modules if m in ("jax", "ccs_tpu")
                     or m.startswith(("jax.", "ccs_tpu.")))
    if foreign:
        raise RuntimeError(f"the port's run imported {foreign}")
    if not np.isfinite([r["ms"] for r in rows]).all():
        raise RuntimeError("kernel timing failed")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
