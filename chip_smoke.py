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
   true insert (band 64, one launch), also against the dense oracle, timed
   at that size and with the pairs tiled 8 times, then driven once through
   its entry point with its launches counted;
4. the CLI main path (``ccs_tpu_torch.cli.run``) on 400 simulated 2 kb
   10-pass ZMWs, then on a subset with --disable-heuristics; checks the
   report, the BAM, and that both kernels were launched; then times the
   400-ZMW run once more with the prepare pool warm;
5. the GPU engine against the CPU engine (plain versions) on 16 ZMWs;
6. the DC stage, (a)-(f) (see their functions);
7. the parallel layer: (g) the engine over [cuda:0, cuda:0] (two shards on
   one card, each on its own thread and stream) on the 400 ZMWs and on the
   subset with --disable-heuristics, against the single-device engine,
   with both scorers' launches counted over the shard threads (and over
   [cuda:0, cuda:1] where a second card is visible); (h) two CLI host
   processes (--tpu-num-hosts 2, a gloo coordinator on localhost) on the
   400-ZMW BAM, merged by host 0, against the single CLI run of phase 4;
8. the CLI's modes, (k): --by-strand, --hd-finder and --hifi-kinetics on
   the card against the port's CPU run of the same BAM, --all, FASTQ and
   XML output and --chunk 1/2 + 2/2 against the card's own runs, then 16
   ZMWs of 15 kb at tests/test_scale.py's bars;
9. after the DC refinement and training checks, (i) both scorer kernels
   against brute-force forwards of every mutant template (pipeline.polish,
   ops.hmm_forward) and the round-1 brute-force loop against the fused
   loop, and (j) the clean-position table refit (tools/fit_clean_qv.py)
   against the JAX tool's own refit and the shipped table.
The second-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.

``bound_ms`` of a kernel is the least time the card could take for the same
work on this run's inputs: the larger of bytes moved (every input and
output tensor once) over the memory rate and operations over the peak rate
of their type outside the tensor cores. The peaks are NVIDIA's published
H100 SXM figures at the full 700 W power limit. The edit distance's rows
are a serial recurrence, so its bound has a third term, the longest pair's
dependent instructions at one a cycle of the SM clock the card reports.
"""

from __future__ import annotations

import json
import logging
import os
import re
import socket
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
# the DC stage: a finite correction threshold for the edit-and-rescore path
# (the shipped model's is inf), and the GPU vs CPU bar on rq
DC_CONF, DC_RQ_TOL = 2.0, 1e-4
EDIT_BAND, EDIT_ORACLE_PAIRS, EDIT_TILE = 64, 8, 8
# H100 SXM peaks: HBM3 bytes/s; float32 FLOP/s outside the tensor cores
# (128 lanes x 2 per FMA per SM); int32 op/s (64 lanes per SM, no FMA: a
# quarter of the float32 figure)
HBM_BYTES_S, FP32_FLOP_S, INT32_OP_S = 3.35e12, 67e12, 16.75e12
# float32 operations per cell of the scorer's recurrences as hmm_score.cu
# writes them: a column step (forward or backward) and a three-operator
# bridge step; integer operations per cell of the edit-distance recurrence
# taken cell by cell
SWEEP_FLOPS, BRIDGE_FLOPS, EDIT_OPS = 21, 59, 8
# The cheapest formulation known of that recurrence is a bit-vector row
# (Myers 1999, Hyyro 2003): a row of a pair is ceil(2*band/32) 32-bit words
# of state, and per word 12 integer operations: Eq from two-bit template
# planes (two three-input logic operations and a funnel shift: 3), and one
# each for Xv, Eq & Pv, the add with carry, D0, Ph, Mh, the shift of Xv, Pv
# and Mv (9). What a row does once, whatever its words (the read base's
# masks, the count of D0's bit 0), is left out of the bound. Of these a
# row's dependent chain is the carry through every word and four more:
# Eq & Pv, D0, Ph, Pv.
EDIT_WORD_OPS, EDIT_CHAIN_OPS = 12, 4
# (i) brute force: windows of the production batch, mutants per forward
BRUTE_WINDOWS, BRUTE_M_CHUNK = 256, 89
# (i) the range of float32 scores: a window counts when every live read's
# LL against its template (float64 forward) is at least EDGE_LANE_FLOOR, a
# slot when its float32 brute-force LL equals the float64 one to FLOAT32_OK
EDGE_LANE_FLOOR, FLOAT32_OK = -60.0, 1e-3
# (j) the clean-position table refit: cells with at least FIT_MIN_SAMPLES
# samples are measured; each must lie within FIT_QV_TOL QV of the JAX tool's
# own refit (tools/fit_clean_qv.py, full grid, on the CPU: the cell means
# below; the port's CPU refit read at most 0.37 QV from them) and within
# FIT_SHIPPED_BAR QV of the shipped table (both CPU refits read up to 20.25
# QV from it, at snr bin 3, coverage 16: the shipped file predates the
# tool's present loop)
FIT_MIN_SAMPLES, FIT_QV_TOL, FIT_SHIPPED_BAR = 80, 1.0, 21.25
JAX_REFIT_MEANS = {
    (2, 4): 4.609e-02, (2, 6): 7.399e-03, (2, 10): 1.387e-03,
    (2, 16): 1.881e-04, (2, 22): 5.255e-07, (3, 4): 2.260e-02,
    (3, 6): 6.218e-03, (3, 10): 6.422e-04, (3, 16): 1.300e-05,
    (3, 22): 7.329e-10, (4, 4): 3.279e-02, (4, 6): 3.019e-03,
    (4, 10): 9.092e-04, (4, 16): 5.653e-07, (4, 22): 5.103e-08,
    (5, 4): 2.129e-02, (5, 6): 4.546e-03, (5, 10): 4.475e-04,
    (5, 16): 1.562e-06, (5, 22): 4.797e-07}
# (k) the CLI modes: ZMWs of MODES_INSERT bp with kinetics plus one
# heteroduplex; then the 15 kb run, and tests/test_scale.py's bars on it
MODES_ZMWS, MODES_INSERT, MODES_PASSES = 8, 250, 10
SCALE_ZMWS, SCALE_INSERT, SCALE_PASSES = 16, 15_000, 8
SCALE_LEN_TOL, SCALE_MIN_ANCHORS = 100, 10_000


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


def _back_to_back_ms(fn, launches: int) -> float:
    """Mean time of a call in a run of calls queued back to back: the card
    never waits for the host, so this is the kernel's own time."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def _bound(ops: float, peak: float, nbytes: int,
           serial_ms: float = 0.0) -> tuple[float, str]:
    """(bound_ms, bound_by) from an operation count, the bytes moved and,
    where the work is a serial chain, that chain's least time."""
    terms = {"operations": ops / peak * 1e3,
             "bytes": nbytes / HBM_BYTES_S * 1e3, "serial depth": serial_ms}
    by = max(terms, key=terms.get)
    return terms[by], by


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
    return rows, arrs


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


def _edit_rows(tlen, rlens, band: int):
    """What the bit-vector kernel's threads do for these pairs: (rows of the
    pairs in band by their lengths, the longest of them, the share of
    lane-rows idle when 32 consecutive pairs share a warp that runs to its
    longest in-band read)."""
    import numpy as np
    rows = np.where(np.abs(tlen.astype(np.int64) - rlens) <= band, rlens, 0)
    rows = np.concatenate([rows, np.zeros(-len(rows) % 32, rows.dtype)])
    warp_rows = rows.reshape(-1, 32).max(axis=1).sum()
    idle = 1.0 - rows.sum() / max(32 * warp_rows, 1)
    return int(rows.sum()), int(rows.max()), float(idle)


def _sm_clock_hz() -> float:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(smi.stdout.strip().splitlines()[0]) * 1e6


def phase_edit_kernel(sims):
    """The banded edit-distance kernel against its plain version and the
    dense oracle at the 400-ZMW 2 kb size, timed there and with the pairs
    tiled 8 times, then driven once through its entry point with its
    launches counted; returns its row."""
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
    # a code outside 0..3, whatever its two low bits, matches nothing
    odd = tuple(a[:64].clone() for a in args)
    rng = np.random.default_rng(0)
    for side, n in ((odd[0], tpl.shape[1]), (odd[2], reads.shape[1])):
        at_ = torch.from_numpy(rng.integers(0, n, (64, 40))).to(dev)
        code = rng.integers(4, 256, (64, 40)).astype(np.uint8).view(np.int8)
        side.scatter_(1, at_, torch.from_numpy(code).to(dev))
    if not torch.equal(
            clip(kern(*odd, band=EDIT_BAND)),
            clip(align_banded.edit_distance_banded_plain(*odd,
                                                         band=EDIT_BAND))):
        raise RuntimeError("edit_distance_banded: codes outside the bases "
                           "give another distance than the plain version")

    ms = _median_ms(lambda: kern(*args, band=EDIT_BAND), 11)
    plain_ms = _median_ms(lambda: align_banded.edit_distance_banded_plain(
        *args, band=EDIT_BAND), 3)
    cells = _edit_cells(tlen, rlens, EDIT_BAND)
    rows, longest, idle = _edit_rows(tlen, rlens, EDIT_BAND)
    words, clock = max(1, -(-2 * EDIT_BAND // 32)), _sm_clock_hz()
    chain = words + EDIT_CHAIN_OPS
    serial_ms = longest * chain / clock * 1e3
    bound_ms, bound_by = _bound(EDIT_WORD_OPS * rows * words, INT32_OP_S,
                                _nbytes(*args, got), serial_ms)
    log(f"edit_distance_banded: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
        f"(median, {len(tlen)} pairs = {len(tlen) / ms * 1e3:.4g} pairs/s); "
        f"bound {bound_ms:.4f} ms by {bound_by}")
    log(f"edit_distance_banded: bound terms: {rows} rows x {words} words x "
        f"{EDIT_WORD_OPS} operations = "
        f"{EDIT_WORD_OPS * rows * words / INT32_OP_S * 1e3:.4f} ms; bytes "
        f"{_nbytes(*args, got) / HBM_BYTES_S * 1e3:.4f} ms; serial depth "
        f"{longest} rows x {chain} instructions at "
        f"{clock / 1e6:.0f} MHz = {serial_ms:.4f} ms; the same {cells:.0f} "
        f"cells taken one by one ({EDIT_OPS} operations each) would cost "
        f"{EDIT_OPS * cells / INT32_OP_S * 1e3:.4f} ms; idle lane-rows "
        f"(warps of 32 consecutive pairs) {idle:.4f}")
    if ms < bound_ms:
        raise RuntimeError("edit_distance_banded ran under its bound: the "
                           "bound is wrong")

    # the filled-card regime: the same pairs 8 times over, kernel only
    many = tuple(a.repeat((EDIT_TILE,) + (1,) * (a.dim() - 1)) for a in args)
    got_many = kern(*many, band=EDIT_BAND)
    if not torch.equal(got_many, got.repeat(EDIT_TILE)):
        raise RuntimeError("edit_distance_banded: the tiled pairs differ")
    ms_many = _median_ms(lambda: kern(*many, band=EDIT_BAND), 11)
    log(f"edit_distance_banded: {len(tlen) * EDIT_TILE} pairs (the same, "
        f"tiled {EDIT_TILE}x) {ms_many:.3f} ms = "
        f"{len(tlen) * EDIT_TILE / ms_many * 1e3:.4g} pairs/s, "
        f"{ms_many / ms:.2f}x the time of {len(tlen)}")
    b2b = _back_to_back_ms(lambda: kern(*args, band=EDIT_BAND), 200)
    b2b_many = _back_to_back_ms(lambda: kern(*many, band=EDIT_BAND), 200)
    log(f"edit_distance_banded: 200 launches back to back (the wrapper's "
        f"host time hidden): {b2b:.4f} ms each at {len(tlen)} pairs = "
        f"{b2b * 1e-3 * clock / longest:.1f} cycles a row of the longest "
        f"read, {b2b_many:.4f} ms each at {len(tlen) * EDIT_TILE}")

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


def _brute_force(tpl, tlen, snr_bin, reads, rlens, tables):
    """Every mutant of the 9-kind enumeration scored by a full forward of
    its template, and the template's own forward: (lls [B, 9T+4] with NEG
    at invalid slots, ll0 [B]), in the tables' float type."""
    from ccs_tpu_torch.ops.hmm_forward import forward_batch
    from ccs_tpu_torch.pipeline import polish
    mt, ml, v8 = polish.make_mutants(tpl, tlen)
    lls = polish.score_mutants(mt, ml, v8, snr_bin, reads, rlens, tables,
                               m_chunk=BRUTE_M_CHUNK)
    return (polish.absolute_layout(lls, tpl),
            forward_batch(tpl, tlen, snr_bin, reads, rlens, tables).sum(-1))


def phase_brute_force(arrs, params):
    """(i) Both scorer kernels against brute-force forwards, which share
    none of the bridging algebra: every mutant template of the 9-kind
    enumeration built and scored by ops.hmm_forward.forward_batch, on the
    first BRUTE_WINDOWS production windows and at the edge shapes (with
    pulse-width factors; there on the windows and slots within float32's
    range, see below); then the round-1 brute-force polish loop against
    the fused loop on the dense kernel."""
    import copy
    import numpy as np
    import torch
    from ccs_tpu_torch.ops import hmm_score
    from ccs_tpu_torch.ops.hmm_forward import forward_batch
    from ccs_tpu_torch.ops.tables import params_to_torch
    from ccs_tpu_torch.pipeline import polish
    from ccs_tpu_torch.pipeline.polish_fused import (mutation_valid_new,
                                                     polish_windows_fused)
    from ccs_tpu_torch.sim.edges import edge_batch
    dev = torch.device("cuda")
    tables = params_to_torch(params, dev)
    rng = np.random.default_rng(7)
    eparams = copy.deepcopy(params)
    eparams.pw_match = rng.uniform(0.6, 1.4, (8, 4)).astype(np.float32)
    eparams.pw_ins = rng.uniform(0.5, 2.0, (8, 4)).astype(np.float32)
    eparams.pw_match[:, 0] = eparams.pw_ins[:, 0] = 1.0
    etables = params_to_torch(eparams, dev)
    batches = [(f"{BRUTE_WINDOWS} production windows",
                tuple(a[:BRUTE_WINDOWS] for a in arrs[:5]),
                arrs[5][:BRUTE_WINDOWS], tables)]
    for n_reads, t_cap, r_cap in EDGE_CAPS:
        e = edge_batch(rng, n_reads, t_cap, r_cap)
        batches.append((f"edges C={n_reads} T={t_cap} R={r_cap}", e,
                        rng.random(e[0].shape) < 0.4, etables))
    worst = {"dense": [0.0, 0.0], "sparse": [0.0, 0.0]}
    n_mut, n_out, n_win, t_brute = 0, 0, 0, 0.0
    for what, a, cand_np, tab in batches:
        tpl, tlen, snr_bin, reads, rlens = (torch.from_numpy(x).to(dev)
                                            for x in a)
        cand = torch.from_numpy(cand_np).to(dev)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        brute, ll0 = _brute_force(tpl, tlen, snr_bin, reads, rlens, tab)
        torch.cuda.synchronize()
        t_brute += time.monotonic() - t0
        valid = mutation_valid_new(tpl, tlen)
        if not torch.equal(valid, brute > polish.NEG / 2):
            raise RuntimeError(f"brute force, {what}: the enumerations' "
                               "valid slots differ")
        # The range of float32 scores: the forward floors a column entry
        # at 1e-30 of the column's maximum and a bridge its dot product at
        # 1e-30 (the scorers and the JAX package alike), so a read of random
        # bases far from its template (the edge shapes) scores wrong in
        # both, differently. The comparison holds on the windows whose
        # every live read scores above EDGE_LANE_FLOOR against the
        # template, at the slots where the float32 forward equals the
        # float64 one.
        t64 = {k: v.double() for k, v in tab.items()}
        exact, exact0 = _brute_force(tpl, tlen, snr_bin, reads, rlens, t64)
        lanes = forward_batch(tpl, tlen, snr_bin, reads, rlens, t64)
        rep0 = (((lanes >= EDGE_LANE_FLOOR) | (rlens < 0)).all(-1)
                & ((ll0 - exact0).abs() <= FLOAT32_OK))
        rep = rep0[:, None] & ((brute - exact).abs() <= FLOAT32_OK)
        n_mut += int((valid & rep).sum())
        n_out += int((valid & ~rep).sum())
        n_win += int(rep0.sum())
        if what == batches[0][0] and not (bool(rep[valid].all())
                                          and bool(rep0.all())):
            raise RuntimeError("brute force: production windows outside "
                               "float32's range")
        scored = hmm_score.scored_slots(tpl, tlen, cand)
        for name, (lls, k0), ok in (
                ("dense", hmm_score.score_dense(tpl, tlen, snr_bin, reads,
                                                rlens, tab), valid & rep),
                ("sparse", hmm_score.score_sparse(tpl, tlen, snr_bin, reads,
                                                  rlens, cand, tab),
                 valid & rep & scored)):
            d0 = float(torch.where(rep0, (k0 - ll0).abs(), 0.0).max())
            d = float(torch.where(ok, (lls - brute).abs(), 0.0).max())
            worst[name] = [max(worst[name][0], d0), max(worst[name][1], d)]
            if not (d0 <= LL0_TOL and d <= LLS_TOL):
                raise RuntimeError(f"brute force, {what}: {name} kernel "
                                   f"max |ll0 diff| {d0:.3g}, max |lls "
                                   f"diff| {d:.3g} exceed the bars")
            if name == "sparse" and int((lls[~scored] != 0).sum()):
                raise RuntimeError(f"brute force, {what}: unbridged sparse "
                                   "slots are not 0")
    log(f"(i) brute force: {n_mut} valid mutants of {n_win} windows in "
        f"{len(batches)} batches ({', '.join(b[0] for b in batches)}) by "
        f"full forwards in {t_brute:.2f} s wall ({n_out} more at the edge "
        f"shapes outside float32's range, left out); dense kernel max "
        f"|ll0 - forward| "
        f"{worst['dense'][0]:.3g}, max |lls - forward| "
        f"{worst['dense'][1]:.3g}; sparse {worst['sparse'][0]:.3g}, "
        f"{worst['sparse'][1]:.3g} (bars {LL0_TOL}, {LLS_TOL}); unbridged "
        f"sparse slots 0")

    tpl, tlen, snr_bin, reads, rlens = (torch.from_numpy(x).to(dev)
                                        for x in batches[0][1])
    zero = torch.zeros_like(tlen)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    st_old, _q, _p = polish.polish_windows(tpl, tlen, zero, tlen, snr_bin,
                                           reads, rlens, tables,
                                           max_iters=20, scoring="dense",
                                           m_chunk=BRUTE_M_CHUNK)
    torch.cuda.synchronize()
    t1 = time.monotonic()
    st_new, _q, _p = polish_windows_fused(tpl, tlen, zero, tlen, snr_bin,
                                          reads, rlens, tables, max_iters=20)
    torch.cuda.synchronize()
    t2 = time.monotonic()
    differ = int(((st_old.tpl != st_new.tpl).any(-1)
                  | (st_old.tlen != st_new.tlen)).sum())
    log(f"(i) round-1 brute-force loop against the fused loop (dense "
        f"kernel) on {BRUTE_WINDOWS} windows: {differ} templates differ "
        f"(bar 1); {int(st_old.n_iter.max())} and "
        f"{int(st_new.n_iter.max())} iterations, {t1 - t0:.2f} s and "
        f"{t2 - t1:.3f} s")
    if differ > 1 or bool(st_new.active.any()):
        raise RuntimeError("the fused loop's templates differ from the "
                           "brute-force loop's")


def phase_fitter():
    """(j) The clean-position table refit on the card (the full grid,
    dense scoring: the dense kernel), against the JAX tool's own refit and
    the shipped table, cell by cell over the measured cells."""
    import numpy as np
    from ccs_tpu_torch.ops import hmm_score
    from ccs_tpu_torch.ops.tables import load_clean_perr
    from ccs_tpu_torch.tools import fit_clean_qv as fit
    # this slice's path: the fitter, counters from 0
    hmm_score.score_dense.launches = 0
    hmm_score.score_sparse.launches = 0
    t0 = time.monotonic()
    rows = fit.measure(device="cuda", log=lambda m: None)
    wall = time.monotonic() - t0
    launches = {"hmm_score_dense": hmm_score.score_dense.launches,
                "hmm_score_sparse": hmm_score.score_sparse.launches}
    tab, shipped = fit.fit_table(rows), load_clean_perr()
    cells = sorted(k for k, v in rows.items() if len(v) >= FIT_MIN_SAMPLES)

    def dqv(a, b):
        return 10.0 * abs(np.log10(a) - np.log10(b))

    d_ref = {k: dqv(min(rows[k].mean(), 0.25), JAX_REFIT_MEANS[k])
             for k in cells if k in JAX_REFIT_MEANS}
    d_ship = {k: dqv(tab[k], shipped[k]) for k in cells}
    worst_ref, worst_ship = max(d_ref, key=d_ref.get), max(d_ship,
                                                           key=d_ship.get)
    log(f"(j) clean-position refit on the card: {len(rows)} cells, "
        f"{len(cells)} measured, {sum(len(v) for v in rows.values())} "
        f"samples, {wall:.1f} s wall; kernel launches {launches}")
    log(f"(j) against the JAX tool's CPU refit: max |dQV| "
        f"{d_ref[worst_ref]:.3f} at (snr bin, coverage) {worst_ref} (bar "
        f"{FIT_QV_TOL}); against the shipped table: max |dQV| "
        f"{d_ship[worst_ship]:.3f} at {worst_ship} (bar {FIT_SHIPPED_BAR}), "
        f"mean {np.mean(list(d_ship.values())):.3f}")
    if cells != sorted(JAX_REFIT_MEANS):
        raise RuntimeError(f"the refit measured cells {cells}, the JAX tool "
                           f"{sorted(JAX_REFIT_MEANS)}")
    if d_ref[worst_ref] > FIT_QV_TOL or d_ship[worst_ship] > FIT_SHIPPED_BAR:
        raise RuntimeError("the refit table is off its references")
    if launches["hmm_score_dense"] <= 0:
        raise RuntimeError("the fitter did not launch the dense kernel")
    return launches


def _capturing_run(argv, device=None):
    """cli.run with the results it emits captured: (rc, results in input
    order, seconds, wall split, kernel launches from 0)."""
    from ccs_tpu_torch import cli
    from ccs_tpu_torch.ops import hmm_score
    from ccs_tpu_torch.pipeline import orchestrator
    run_pipeline, results = orchestrator.run_pipeline, []

    def spy(engine, zmws, emit, **kw):
        def keep(res, n_in):
            results.extend(res)
            emit(res, n_in)
        return run_pipeline(engine, zmws, keep, **kw)

    cap = _LogArgs()
    logging.getLogger("ccs_tpu").addHandler(cap)
    hmm_score.score_dense.launches = 0
    hmm_score.score_sparse.launches = 0
    orchestrator.run_pipeline = spy
    try:
        t0 = time.monotonic()
        rc = cli.run(argv + ["--log-level", "INFO"], device=device)
        dt = time.monotonic() - t0
    finally:
        orchestrator.run_pipeline = run_pipeline
        logging.getLogger("ccs_tpu").removeHandler(cap)
    if rc != 0:
        raise RuntimeError(f"cli.run {argv} returned {rc}")
    return rc, results, dt, cap.args["wall split"], {
        "hmm_score_dense": hmm_score.score_dense.launches,
        "hmm_score_sparse": hmm_score.score_sparse.launches}


def _same_cli_results(got, ref, what) -> float:
    """Statuses, strands and sequences identical; QVs and rq within
    QV_TOL; returns the largest gap."""
    import numpy as np
    if len(got) != len(ref):
        raise RuntimeError(f"{what}: {len(got)} results, {len(ref)} expected")
    worst = 0.0
    for a, b in zip(got, ref):
        key = (a.hole, a.strand, a.status.name)
        if key != (b.hole, b.strand, b.status.name):
            raise RuntimeError(f"{what}: {key} vs {(b.hole, b.strand, b.status.name)}")
        if (a.seq is None) != (b.seq is None) or (
                a.seq is not None and not np.array_equal(a.seq, b.seq)):
            raise RuntimeError(f"{what}: hole {a.hole} {a.strand}: "
                               "sequences differ")
        if a.qv is not None:
            worst = max(worst, float(np.abs(a.qv - b.qv).max()),
                        abs(a.rq - b.rq))
    if worst > QV_TOL:
        raise RuntimeError(f"{what}: QVs or rq differ by {worst} > {QV_TOL}")
    return worst


def phase_cli_modes(workdir):
    """(k) The CLI's modes on the card. --by-strand, --hd-finder and
    --hifi-kinetics against the port's CPU run on the same BAM (MODES_ZMWS
    ZMWs with kinetics tags and a heteroduplex): statuses, strands and
    sequences identical, QVs and rq within QV_TOL, reports equal, and with
    --hifi-kinetics the kinetics tags equal. --all, FASTQ and XML output,
    --chunk 1/2 + 2/2 on the card alone, each against the card's own runs
    (--all: one record per ZMW but the heteroduplex). Returns the kernel
    launches of the card runs."""
    import gzip
    import numpy as np
    from ccs_tpu_torch.ops import dna
    from ccs_tpu_torch.sim.simulator import (simulate_heteroduplex_zmw,
                                             simulate_zmw,
                                             write_subreads_bam)
    d = os.path.join(workdir, "modes")
    os.makedirs(d)
    inp = os.path.join(d, "in.subreads.bam")
    zmws = [simulate_zmw(hole=h, insert_len=MODES_INSERT,
                         n_passes=MODES_PASSES, snr=E2E_SNR)
            for h in range(MODES_ZMWS)]
    zmws.append(simulate_heteroduplex_zmw(hole=MODES_ZMWS, insert_len=400,
                                          n_passes=12, ins_len=40,
                                          snr=E2E_SNR))
    write_subreads_bam(inp, zmws, with_kinetics=True)
    launches = {"hmm_score_dense": 0, "hmm_score_sparse": 0}

    def on_card(argv):
        out = _capturing_run([inp] + argv)
        for k, v in out[4].items():
            launches[k] += v
        return out

    def path(name):
        return os.path.join(d, name)

    for flags in (["--by-strand", "--min-rq", "0.9"],
                  ["--hd-finder", "--min-rq", "0.9"], ["--hifi-kinetics"]):
        tag = flags[0].strip("-")
        _rc, res_g, t_g, _sp, _l = on_card([path(f"{tag}.g.bam")] + flags)
        _rc, res_c, t_c, _sp, _l = _capturing_run(
            [inp, path(f"{tag}.c.bam")] + flags, device="cpu")
        worst = _same_cli_results(res_g, res_c, f"--{tag} card vs CPU")
        with open(path(f"{tag}.g.ccs_report.txt")) as fg, \
                open(path(f"{tag}.c.ccs_report.txt")) as fc:
            if fg.read() != fc.read():
                raise RuntimeError(f"--{tag}: the reports differ")
        rec_g, rec_c = (_bam_rows(path(f"{tag}.{x}.bam")) for x in "gc")
        if [r[0] for r in rec_g] != [r[0] for r in rec_c] or any(
                a[1] != b[1] for a, b in zip(rec_g, rec_c)):
            raise RuntimeError(f"--{tag}: the BAM records differ")
        kin = ("fi", "fp", "ri", "rp", "fn", "rn")
        if tag == "hifi-kinetics" and any(
                {k: a[3].get(k) for k in kin} != {k: b[3].get(k) for k in kin}
                or "fi" not in a[3] for a, b in zip(rec_g, rec_c)):
            raise RuntimeError("--hifi-kinetics: the kinetics tags differ")
        strands = sorted({r.strand for r in res_g})
        n_ok = sum(r.status.name == "SUCCESS" for r in res_g)
        log(f"(k) --{tag}: card == CPU on {len(res_g)} results ({n_ok} "
            f"SUCCESS, strands {strands}), max |QV or rq diff| {worst:.3g} "
            f"(bar {QV_TOL}), reports and records equal; card {t_g:.2f} s, "
            f"CPU {t_c:.2f} s")

    # card-only modes, each against the card's own default run
    t_w = on_card([path("whole.consensusreadset.xml")])[2]
    whole = _bam_rows(path("whole.bam"))
    with open(path("whole.consensusreadset.xml")) as fh:
        xml = fh.read()
    want = (f"<pbds:NumRecords>{len(whole)}</pbds:NumRecords>",
            f"<pbds:TotalLength>{sum(len(r[1]) for r in whole)}"
            "</pbds:TotalLength>")
    if not all(w in xml for w in want) or not os.path.exists(
            path("whole.bam.pbi")):
        raise RuntimeError("XML output: the dataset does not describe its BAM")
    on_card([path("out.fastq.gz")])
    with gzip.open(path("out.fastq.gz"), "rt") as fh:
        lines = fh.read().strip().split("\n")
    fq = [(lines[i][1:], lines[i + 1], lines[i + 3])
          for i in range(0, len(lines), 4)]
    bam = [(r[0], dna.decode(np.frombuffer(r[1], np.int8)).decode(),
            "".join(chr(q + 33) for q in r[2])) for r in whole]
    if fq != bam:
        raise RuntimeError("FASTQ output: other sequences or QVs than the "
                           "BAM run")
    merged = []
    for i in (1, 2):
        on_card([path(f"c{i}.bam"), "--chunk", f"{i}/2"])
        merged += _bam_rows(path(f"c{i}.bam"))
    if sorted(merged, key=lambda r: r[0]) != sorted(whole,
                                                     key=lambda r: r[0]):
        raise RuntimeError("--chunk 1/2 + 2/2 do not merge to the whole run")
    _rc, res_a, _t, _sp, _l = on_card([path("all.bam"), "--all"])
    n_all = len(_bam_rows(path("all.bam")))
    n_hd = sum(r.status.name == "HETERODUPLEXES" for r in res_a)
    if n_hd != 1 or n_all != len(zmws) - n_hd:
        raise RuntimeError(f"--all wrote {n_all} records for {len(zmws)} "
                           f"ZMWs, {n_hd} of them heteroduplexes")
    log(f"(k) card only: XML ({len(whole)} records, {t_w:.2f} s), FASTQ = "
        f"the BAM's sequences and QVs, --chunk 1/2 + 2/2 = the whole run "
        f"({len(merged)} records), --all {n_all} records for {len(zmws)} "
        f"ZMWs (one a heteroduplex, which --all does not write); kernel "
        f"launches of the card runs {launches}")
    if launches["hmm_score_sparse"] <= 0:
        raise RuntimeError("the CLI modes did not launch the sparse kernel")
    return launches


def phase_scale(workdir):
    """(k) SCALE_ZMWS ZMWs of 15 kb x SCALE_PASSES passes through the CLI on
    the card, each held to tests/test_scale.py's bars: SUCCESS, rq > 0.99,
    length within SCALE_LEN_TOL of the insert, more than SCALE_MIN_ANCHORS
    13-mer anchors against the truth (in either orientation)."""
    from ccs_tpu_torch.ops import dna
    from ccs_tpu_torch.ops.align import anchor_chain
    from ccs_tpu_torch.sim.simulator import simulate_zmw, write_subreads_bam
    inp = os.path.join(workdir, "scale.subreads.bam")
    t0 = time.monotonic()
    sims = [simulate_zmw(hole=h, insert_len=SCALE_INSERT,
                         n_passes=SCALE_PASSES, snr=E2E_SNR)
            for h in range(SCALE_ZMWS)]
    write_subreads_bam(inp, sims)
    t_sim = time.monotonic() - t0
    _rc, res, dt, sp, launches = _capturing_run(
        [inp, os.path.join(workdir, "scale.bam")])
    worst_len, fewest = 0, None
    for z, r in zip(sims, res):
        if r.status.name != "SUCCESS" or not r.rq > 0.99:
            raise RuntimeError(f"15 kb hole {r.hole}: {r.status.name}, rq "
                               f"{r.rq}")
        worst_len = max(worst_len, abs(len(r.seq) - SCALE_INSERT))
        n = max(len(anchor_chain(r.seq, z.insert, 13)),
                len(anchor_chain(r.seq, dna.revcomp(z.insert), 13)))
        fewest = n if fewest is None else min(fewest, n)
    log(f"(k) 15 kb: {len(res)} ZMWs x {SCALE_PASSES} passes in {dt:.3f} s "
        f"= {len(res) / dt:.3f} ZMW/s (simulated in {t_sim:.1f} s); wall "
        f"split prepare {sp[0]:.3f} thread-s, device {sp[1]:.3f} s, busy "
        f"{sp[2]:.3f} s, finalize {sp[3]:.3f} s; all SUCCESS, min rq "
        f"{min(r.rq for r in res):.5f}, max |length - {SCALE_INSERT}| "
        f"{worst_len}, fewest 13-mer anchors {fewest}; kernel launches "
        f"{launches}")
    if len(res) != SCALE_ZMWS or worst_len >= SCALE_LEN_TOL or \
            fewest <= SCALE_MIN_ANCHORS:
        raise RuntimeError("15 kb run below tests/test_scale.py's bars")
    if launches["hmm_score_sparse"] <= 0:
        raise RuntimeError("the 15 kb run did not launch the sparse kernel")


class _LogArgs(logging.Handler):
    """Keeps the arguments of the CLI's last 'wall split' and 'DC
    refinement' log records."""

    def __init__(self):
        super().__init__(level=logging.INFO)
        self.args = {}

    def emit(self, record):
        for key in ("wall split", "DC refinement"):
            if record.msg.startswith(key):
                self.args[key] = record.args


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
    cap = _LogArgs()
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
    split = cap.args["wall split"]
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
    split_warm = cap.args["wall split"]
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


def _same_results(got, ref, what) -> float:
    """Statuses and sequences identical; returns the largest QV gap."""
    import numpy as np
    if len(got) != len(ref):
        raise RuntimeError(f"{what}: {len(got)} results, {len(ref)} expected")
    worst = 0.0
    for a, b in zip(got, ref):
        if a.hole != b.hole or a.status != b.status:
            raise RuntimeError(f"{what}: hole {a.hole} {a.status} vs hole "
                               f"{b.hole} {b.status}")
        if (a.seq is None) != (b.seq is None) or (
                a.seq is not None and not np.array_equal(a.seq, b.seq)):
            raise RuntimeError(f"{what}: hole {a.hole}: sequences differ")
        if a.qv is not None:
            worst = max(worst, float(np.abs(a.qv - b.qv).max()))
    if worst > QV_TOL:
        raise RuntimeError(f"{what}: QVs differ by {worst} > {QV_TOL}")
    return worst


def phase_gpu_vs_cpu(sims, params):
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
    worst = _same_results(res_g, res_c, "GPU engine against CPU engine")
    log(f"GPU engine == CPU engine on {len(zmws)} ZMWs: statuses and "
        f"sequences identical, max |QV diff| {worst:.3g} (bar {QV_TOL}); "
        f"GPU {t1 - t0:.1f} s, CPU {t2 - t1:.1f} s")


def _bam_records(path: str) -> dict:
    """name -> (sequence bytes, binned QV bytes, rq) of a BAM's records."""
    import numpy as np
    from ccs_tpu_torch.io.bam import BamReader
    with BamReader(path) as r:
        return {rec.name: (np.asarray(rec.seq).tobytes(),
                           np.asarray(rec.qual).tobytes(),
                           float(rec.tag("rq"))) for rec in r}


class _BundleDir:
    """$SMRT_CHEMISTRY_BUNDLE_DIR pointing at ``path`` while in the block."""

    def __init__(self, path: str):
        self.path = path

    def __enter__(self):
        self.old = os.environ.get("SMRT_CHEMISTRY_BUNDLE_DIR")
        os.environ["SMRT_CHEMISTRY_BUNDLE_DIR"] = self.path

    def __exit__(self, *exc):
        if self.old is None:
            del os.environ["SMRT_CHEMISTRY_BUNDLE_DIR"]
        else:
            os.environ["SMRT_CHEMISTRY_BUNDLE_DIR"] = self.old


def finite_conf_bundle(workdir: str) -> str:
    """A bundle directory holding only dc_model.npz: the shipped model with
    its edits enabled (conf 2.0 in place of inf)."""
    import dataclasses
    from ccs_tpu_torch.models.dc_polisher import builtin_model
    bundle = os.path.join(workdir, "bundle")
    os.makedirs(bundle, exist_ok=True)
    dataclasses.replace(builtin_model(), conf=DC_CONF).save(
        os.path.join(bundle, "dc_model.npz"))
    return bundle


def _dc_cli_run(argv, what):
    """One CLI run with the DC stage, counters from 0: (seconds, wall
    split, DC counts, launches)."""
    from ccs_tpu_torch import cli
    from ccs_tpu_torch.ops import hmm_score
    cap = _LogArgs()
    logging.getLogger("ccs_tpu").addHandler(cap)
    hmm_score.score_dense.launches = 0
    hmm_score.score_sparse.launches = 0
    try:
        t0 = time.monotonic()
        rc = cli.run(argv + ["--tpu-dc-polish", "--log-level", "INFO"])
        dt = time.monotonic() - t0
    finally:
        logging.getLogger("ccs_tpu").removeHandler(cap)
    launches = {"hmm_score_dense": hmm_score.score_dense.launches,
                "hmm_score_sparse": hmm_score.score_sparse.launches}
    if rc != 0:
        raise RuntimeError(f"{what}: cli.run returned {rc}")
    processed, windows, corrected, zmws = (int(v) for v in
                                           cap.args["DC refinement"])
    return dt, cap.args["wall split"], (processed, windows, corrected,
                                        zmws), launches


def _check_dc_against_plain(out, plain, what):
    """Identical record names, sequences and binned QVs; returns the count
    of records whose rq differs."""
    got = _bam_records(out)
    if got.keys() != plain.keys():
        raise RuntimeError(f"{what}: other records than the plain run")
    if any(got[k][:2] != plain[k][:2] for k in got):
        raise RuntimeError(f"{what}: sequences or QVs differ from the plain "
                           "run")
    return sum(got[k][2] != plain[k][2] for k in got)


def phase_dc_cli(workdir):
    """(a) warm CLI runs with --tpu-dc-polish and the shipped model
    (conf = inf: it never edits) against the plain warm run, at the default
    threshold and at QV 40 (with --min-rq 0, so every ZMW keeps its record
    whatever its recalibrated rq): identical sequences and QVs, rq changed
    on as many ZMWs as hold a processed window; then the plain run once
    more, for the spread. (b) The same input with the finite-conf model in
    a bundle directory and every window with reads processed (threshold
    93): the re-score launches the dense kernel."""
    from ccs_tpu_torch import cli
    in_bam = os.path.join(workdir, "in.subreads.bam")
    plain = _bam_records(os.path.join(workdir, "warm.bam"))
    for thresh, extra in (("25", []), ("40", ["--min-rq", "0"])):
        out = os.path.join(workdir, f"dc{thresh}.bam")
        dt, sp, (proc, wins, corr, zmws), launches = _dc_cli_run(
            [in_bam, out, "--tpu-dc-qv-thresh", thresh] + extra,
            f"--tpu-dc-polish at QV {thresh}")
        rep = _read_report(os.path.join(workdir,
                                        f"dc{thresh}.ccs_report.txt"))
        n_in, n_pass = rep["ZMWs input"], rep["ZMWs pass filters"]
        log(f"DC run (shipped dc_v0, threshold {thresh}, warm pool): {n_in} "
            f"ZMWs in {dt:.3f} s = {n_in / dt:.2f} ZMW/s; wall split prepare "
            f"{sp[0]:.3f} thread-s, device {sp[1]:.3f} s, busy {sp[2]:.3f} "
            f"s, finalize {sp[3]:.3f} s")
        log(f"DC run at QV {thresh}: {n_pass} SUCCESS; {proc} of {wins} "
            f"windows processed ({proc / wins:.5f}), {corr} corrected, in "
            f"{zmws} ZMWs; kernel launches {launches}")
        if n_in != E2E_ZMWS or n_pass < 0.99 * n_in:
            raise RuntimeError(f"DC run: {n_pass}/{n_in} SUCCESS")
        changed = _check_dc_against_plain(out, plain, f"DC run at {thresh}")
        log(f"DC run at QV {thresh}: sequences and QVs identical to the "
            f"plain warm run; rq differs on {changed} ZMWs, {zmws} hold a "
            f"processed window")
        if changed != zmws or corr != 0 or (thresh == "40" and not proc):
            raise RuntimeError("DC run: rq changed on another number of "
                               "ZMWs than hold a processed window, an edit, "
                               "or nothing processed at QV 40")
    cap = _LogArgs()
    logging.getLogger("ccs_tpu").addHandler(cap)
    t0 = time.monotonic()
    rc = cli.run([in_bam, os.path.join(workdir, "warm2.bam"), "--log-level",
                  "INFO"])
    dt = time.monotonic() - t0
    logging.getLogger("ccs_tpu").removeHandler(cap)
    if rc != 0:
        raise RuntimeError(f"plain rerun: cli.run returned {rc}")
    sp = cap.args["wall split"]
    log(f"main path again (warm pool, after the DC runs): "
        f"{E2E_ZMWS / dt:.2f} ZMW/s, device {sp[1]:.3f} s")

    with _BundleDir(finite_conf_bundle(workdir)):
        dt, sp, (proc, wins, corr, zmws), launches = _dc_cli_run(
            [in_bam, os.path.join(workdir, "dc_edit.bam"),
             "--tpu-dc-qv-thresh", "93"], "finite-conf DC run")
    rep = _read_report(os.path.join(workdir, "dc_edit.ccs_report.txt"))
    n_rec = len(_bam_records(os.path.join(workdir, "dc_edit.bam")))
    log(f"DC run (conf {DC_CONF}, threshold 93): {dt:.3f} s = "
        f"{E2E_ZMWS / dt:.2f} ZMW/s, device {sp[1]:.3f} s; {proc} of {wins} "
        f"windows processed, {corr} corrected, in {zmws} ZMWs; "
        f"{rep['ZMWs pass filters']} SUCCESS, {n_rec} BAM records; kernel "
        f"launches {launches}")
    if n_rec != rep["ZMWs pass filters"]:
        raise RuntimeError("finite-conf DC run: records and report differ")
    if corr <= 0 or launches["hmm_score_dense"] <= 0:
        raise RuntimeError("finite-conf DC run: no correction, or the "
                           "re-score did not launch the dense kernel")


def phase_dc_gpu_vs_cpu(sims, params, workdir):
    """(c) the DC engine (finite-conf model, every window processed) on
    the GPU against the CPU on the 16 ZMWs of phase_gpu_vs_cpu."""
    import numpy as np
    from ccs_tpu_torch.config import CcsConfig
    from ccs_tpu_torch.pipeline.engine import CcsEngine
    zmws = [_zin(z) for z in sims[:ENGINE_ZMWS]]
    cfg = CcsConfig(tpu_window_buckets=(256,), tpu_dc_polish=True,
                    tpu_dc_qv_thresh=93.0)
    with _BundleDir(finite_conf_bundle(workdir)):
        eng_g, eng_c = (CcsEngine(cfg, params, d) for d in ("cuda", "cpu"))
    t0 = time.monotonic()
    res_g = eng_g.process_batch(zmws)
    t1 = time.monotonic()
    res_c = eng_c.process_batch(zmws)
    t2 = time.monotonic()
    worst = worst_rq = 0.0
    for a, b in zip(res_g, res_c):
        if a.status != b.status:
            raise RuntimeError(f"DC hole {a.hole}: {a.status} vs {b.status}")
        if (a.seq is None) != (b.seq is None) or (
                a.seq is not None and not np.array_equal(a.seq, b.seq)):
            raise RuntimeError(f"DC hole {a.hole}: sequences differ")
        if a.qv is not None:
            worst = max(worst, float(np.abs(a.qv - b.qv).max()))
            worst_rq = max(worst_rq, abs(a.rq - b.rq))
    if worst > QV_TOL or worst_rq > DC_RQ_TOL:
        raise RuntimeError(f"DC engine: QVs differ by {worst}, rq by "
                           f"{worst_rq}")
    if not np.array_equal(eng_g.dc_stats, eng_c.dc_stats) or \
            eng_g.dc_stats[2] <= 0:
        raise RuntimeError(f"DC counts GPU {eng_g.dc_stats} CPU "
                           f"{eng_c.dc_stats}")
    log(f"DC engine GPU == CPU on {len(zmws)} ZMWs (conf {DC_CONF}, "
        f"threshold 93): statuses and sequences identical, max |QV diff| "
        f"{worst:.3g} (bar {QV_TOL}), max |rq diff| {worst_rq:.3g} (bar "
        f"{DC_RQ_TOL}); [windows, processed, corrected, ZMWs] "
        f"{eng_g.dc_stats.tolist()} on both; GPU {t1 - t0:.1f} s, CPU "
        f"{t2 - t1:.1f} s")


def phase_dc_refine(arrs, params):
    """(d) refine_chunk alone on a polished 2048 x 16 chunk: the shipped
    model (no edit, no re-score) and the finite-conf model with every
    window processed (edits, one dense re-score); CUDA-event medians."""
    import dataclasses
    import numpy as np
    import torch
    from ccs_tpu_torch.models.dc_polisher import builtin_model, refine_chunk
    from ccs_tpu_torch.ops import hmm_score
    from ccs_tpu_torch.ops.tables import params_to_torch
    from ccs_tpu_torch.parallel.step import make_polish_step
    dev = torch.device("cuda")
    tables = params_to_torch(params, dev)
    tpl, tlen, snr_bin, reads, rlens, cand = (
        torch.from_numpy(a).to(dev) for a in arrs)
    state, qv, _stats = make_polish_step(tables, dev, compact=True,
                                         sparse=True)(
        tpl, tlen, torch.zeros_like(tlen), tlen.clone(), snr_bin, reads,
        rlens, torch.zeros_like(tlen, dtype=torch.bool), cand.float())
    shipped = builtin_model()
    edits = dataclasses.replace(shipped, conf=DC_CONF)
    rows = []
    for name, model, thresh in (("shipped dc_v0", shipped, 25.0),
                                (f"conf {DC_CONF}, threshold 93", edits,
                                 93.0)):
        net = model.module(dev)

        def call():
            return refine_chunk(net, model.ctx, tables, state, qv, reads,
                                rlens, snr_bin, qv_thresh=thresh,
                                conf_thresh=model.conf)
        hmm_score.score_dense.launches = 0
        out = call()
        torch.cuda.synchronize()
        rescored = hmm_score.score_dense.launches
        edited = int(((out[0] != state.tpl).any(-1)
                      | (out[1] != state.tlen)).sum())
        ms = _median_ms(call, 11)
        rows.append(ms)
        log(f"refine_chunk at {W} windows x {C} subreads ({name}): "
            f"{ms:.3f} ms median; {int(out[6].sum())} windows processed, "
            f"{edited} edited, dense re-score launches {rescored}")
        if (rescored > 0) != bool(np.isfinite(model.conf)):
            raise RuntimeError(f"refine_chunk ({name}): re-score launches "
                               f"{rescored}")
    log(f"refine_chunk: the re-score adds {rows[1] - rows[0]:.3f} ms to a "
        f"{W}-window chunk")


def phase_dc_train():
    """(e) train() on the card at the JAX package's slow-test settings,
    held to that test's contract on a fresh held-out batch."""
    import numpy as np
    import torch
    from ccs_tpu_torch.models import dc_polisher as dc
    from ccs_tpu_torch.models.chemistry import default_params
    from ccs_tpu_torch.models.train_dc import mismatch_chemistry
    stamps = []
    true_chem, score_chem = mismatch_chemistry(), default_params()
    t0 = time.monotonic()
    model = dc.train(true_chem, score_chem, steps=400, n_windows=192,
                     hidden=48, ctx=2, batches=4, seed=3, device="cuda",
                     log=lambda m: stamps.append((time.monotonic(), m)))
    wall = time.monotonic() - t0
    steps = [(t, int(m.split()[3].rstrip(":"))) for t, m in stamps
             if m.startswith("dc train step")]
    (ta, sa), (tb, sb) = steps[0], steps[-1]
    state, _qv, _cov, feats, labels, _w, truths = dc.make_training_batch(
        192, true_chem, score_chem, np.random.default_rng(99), device="cuda")
    base = dc.residual_errors(dc._numpy(state.tpl), dc._numpy(state.tlen),
                              truths)
    with torch.no_grad():
        cls, _err = dc.dc_forward(model.module("cuda"), feats, model.ctx)
    ntpl, nlen, _cs, _ce, _ap = dc.apply_corrections(
        state.tpl, state.tlen, state.core_start, state.core_end, cls,
        torch.ones(len(truths), dtype=torch.bool, device="cuda"),
        conf_thresh=model.conf, allow_sub=bool(model.sub_ok))
    refined = dc.residual_errors(dc._numpy(ntpl), dc._numpy(nlen), truths)
    disc, mass = dc.err_head_quality(model, state, feats, labels)
    log(f"DC train on the card (400 steps, 192 windows x 4 batches, hidden "
        f"48, seed 3): {wall:.1f} s wall; steps {sa}-{sb} at "
        f"{(sb - sa) / (tb - ta):.1f} steps/s; conf {model.conf}, sub_ok "
        f"{model.sub_ok}; held-out errors {base} -> {refined}; error head "
        f"discrimination {disc:.2f}x, mass ratio {mass:.3f}")
    if np.isfinite(model.conf) and not refined < base:
        raise RuntimeError("DC train: calibrated edits did not help")
    if not np.isfinite(model.conf) and refined != base:
        raise RuntimeError("DC train: gated-off edits changed templates")
    if not (base > 0 and disc >= 5.0 and 0.3 <= mass <= 3.0):
        raise RuntimeError("DC train: error head below the contract")


def phase_profile(workdir):
    """(f) a small CLI run with --tpu-profile-dir: the Chrome trace exists
    and names the scorer kernel."""
    import glob
    from ccs_tpu_torch import cli
    trace_dir = os.path.join(workdir, "trace")
    sub_bam = os.path.join(workdir, "subset.subreads.bam")
    t0 = time.monotonic()
    if cli.run([sub_bam, os.path.join(workdir, "unprof.bam")]) != 0:
        raise RuntimeError("unprofiled subset run failed")
    t1 = time.monotonic()
    rc = cli.run([sub_bam, os.path.join(workdir, "prof.bam"),
                  "--tpu-profile-dir", trace_dir])
    dt = time.monotonic() - t1
    traces = glob.glob(os.path.join(trace_dir, "*.trace.json"))
    if rc != 0 or len(traces) != 1:
        raise RuntimeError(f"profiled run: rc {rc}, traces {traces}")
    with open(traces[0]) as fh:
        text = fh.read()
    n_kern = text.count('"cat": "kernel"')
    log(f"profiled CLI run on {DENSE_SUBSET} ZMWs: {dt:.2f} s (unprofiled "
        f"{t1 - t0:.2f} s); trace "
        f"{len(text) / 1e6:.1f} MB, {n_kern} kernel events, scorer kernel "
        f"named: {'score_kernel' in text}")
    if "score_kernel" not in text:
        raise RuntimeError("the trace does not name the scorer kernel")


def _pipeline_run(zmws, cfg, params, devices):
    """One engine over ``devices`` driven through the orchestrator (the
    warm prepare pool): (engine, results in input order, wall seconds)."""
    import torch
    from ccs_tpu_torch.pipeline.engine import CcsEngine
    from ccs_tpu_torch.pipeline.orchestrator import run_pipeline
    eng = CcsEngine(cfg, params, devices)
    results = []
    t0 = time.monotonic()
    run_pipeline(eng, iter(zmws), lambda res, _n: results.extend(res),
                 batch_size=cfg.batch_size, num_threads=cfg.num_threads,
                 input_buffer=cfg.input_buffer)
    torch.cuda.synchronize()
    return eng, results, time.monotonic() - t0


def phase_sharded_engine(sims, params):
    """(g) The engine over [cuda:0, cuda:0] against the single-device
    engine, on the 400 ZMWs and on the --disable-heuristics subset; both
    scorers' launches counted over the two shard threads."""
    import numpy as np
    import torch
    from ccs_tpu_torch.config import CcsConfig
    from ccs_tpu_torch.ops import hmm_score
    zmws = [_zin(z) for z in sims]
    default, dense = CcsConfig(), CcsConfig(disable_heuristics=True)
    two = [torch.device("cuda", 0)] * 2
    one = [torch.device("cuda", 0)]
    # the parallel layer's run: counters from 0, the sharded default and
    # dense runs, counters read
    hmm_score.score_dense.launches = 0
    hmm_score.score_sparse.launches = 0
    eng_2, res_2, wall_2 = _pipeline_run(zmws, default, params, two)
    eng_2d, res_2d, _ = _pipeline_run(zmws[:DENSE_SUBSET], dense, params,
                                      two)
    launches = {"hmm_score_dense": hmm_score.score_dense.launches,
                "hmm_score_sparse": hmm_score.score_sparse.launches}
    eng_1, res_1, wall_1 = _pipeline_run(zmws, default, params, one)
    eng_1d, res_1d, _ = _pipeline_run(zmws[:DENSE_SUBSET], dense, params,
                                      one)
    worst = max(_same_results(res_2, res_1, "sharded engine"),
                _same_results(res_2d, res_1d,
                              "sharded engine, --disable-heuristics"))
    for a, b, what in ((eng_2, eng_1, "default"), (eng_2d, eng_1d, "dense")):
        if not np.array_equal(a.polish_stats, b.polish_stats):
            raise RuntimeError(f"sharded engine ({what}): polish_stats "
                               f"{a.polish_stats} vs {b.polish_stats}")
    for k, v in launches.items():
        if v <= 0:
            raise RuntimeError(f"{k} was not launched by the sharded engine")
    # the same pair once more, the other way round, for the spread
    _e, _r, wall_1b = _pipeline_run(zmws, default, params, one)
    eng_2b, _r, wall_2b = _pipeline_run(zmws, default, params, two)
    n_ok = sum(r.status.name == "SUCCESS" for r in res_2)
    log(f"sharded engine [cuda:0, cuda:0] == single-device engine on "
        f"{len(zmws)} ZMWs ({n_ok} SUCCESS) and {DENSE_SUBSET} with "
        f"--disable-heuristics: statuses and sequences identical, max |QV "
        f"diff| {worst:.3g} (bar {QV_TOL}), polish_stats equal "
        f"{eng_2.polish_stats.tolist()}; kernel launches over both shard "
        f"threads {launches}")
    log(f"sharded engine: wall single {wall_1:.3f}, {wall_1b:.3f} s, two "
        f"shards on one card {wall_2:.3f}, {wall_2b:.3f} s; device step "
        f"single {eng_1.t_device:.3f} s, two shards {eng_2.t_device:.3f}, "
        f"{eng_2b.t_device:.3f} s; {len(zmws) / wall_2:.2f} against "
        f"{len(zmws) / wall_1:.2f} ZMW/s")
    if torch.cuda.device_count() >= 2:
        cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
        eng_c, res_c, wall_c = _pipeline_run(zmws, default, params, cards)
        _same_results(res_c, res_1, "engine over two cards")
        log(f"engine over [cuda:0, cuda:1]: wall {wall_c:.3f} s, device "
            f"step {eng_c.t_device:.3f} s; scaling against one card "
            f"{wall_1 / wall_c:.3f}x (wall), "
            f"{eng_1.t_device / eng_c.t_device:.3f}x (device step)")
    else:
        log("engine over two cards: not measured "
            f"({torch.cuda.device_count()} card visible)")
    return launches


# One host of phase (h): the CLI with --tpu-num-hosts on the card, then its
# kernel launches; argv: host id, coordinator, input BAM, output BAM
_HOST = r"""
import logging, sys
logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                    format="%(asctime)s %(levelname)s %(message)s")
import torch.distributed as dist
from ccs_tpu_torch import cli
from ccs_tpu_torch.ops import hmm_score
from ccs_tpu_torch.pipeline.orchestrator import shutdown_pool
i, coord, bam, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
try:
    rc = cli.run([bam, out, '-j', '4', '--log-level', 'INFO',
                  '--tpu-num-hosts', '2', '--tpu-host-id', str(i),
                  '--tpu-coordinator', coord])
finally:
    shutdown_pool()
print('LAUNCHES', hmm_score.score_sparse.launches,
      hmm_score.score_dense.launches, flush=True)
if dist.is_initialized():
    dist.destroy_process_group()
sys.exit(rc)
"""


def _bam_rows(path: str) -> list:
    """(name, sequence, binned QVs, tags) of a BAM's records, in order;
    array tags as bytes."""
    import numpy as np
    from ccs_tpu_torch.io.bam import BamReader
    with BamReader(path) as r:
        return [(rec.name, np.asarray(rec.seq).tobytes(),
                 np.asarray(rec.qual).tobytes(),
                 {k: (np.asarray(v.value).tobytes()
                      if isinstance(v.value, np.ndarray) else v.value)
                  for k, v in rec.tags.items()}) for rec in r]


def phase_two_hosts(workdir):
    """(h) Two CLI host processes on the one card, joined by a gloo
    process group on localhost, on the 400-ZMW BAM: host 0's merge equals
    the single run of phase 4 record for record, with the same report,
    and the all-reduce of the counters reads its totals."""
    in_bam = os.path.join(workdir, "in.subreads.bam")
    merged = os.path.join(workdir, "mh.bam")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _HOST, str(i), coord, in_bam, merged],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for i in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.monotonic() - t0
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"host {i} exited {p.returncode}:\n"
                               f"{err[-4000:]}")
    single = _bam_rows(os.path.join(workdir, "out.bam"))
    got = _bam_rows(merged)
    n_diff = sum(a != b for a, b in zip(got, single))
    with open(os.path.join(workdir, "out.ccs_report.txt")) as fh:
        rep_single = fh.read()
    with open(os.path.join(workdir, "mh.ccs_report.txt")) as fh:
        rep_merged = fh.read()
    bases = sum(len(r[1]) for r in single)
    launches, totals = [], []
    for out, err in outs:
        m = re.search(r"LAUNCHES (\d+) (\d+)", out)
        t = re.search(r"cluster totals via all_reduce: (\d+) ZMWs, (\d+) "
                      r"bases", err)
        if not (m and t and "gloo process group" in err):
            raise RuntimeError(f"a host did not log its process group, its "
                               f"totals or its launches:\n{err[-4000:]}")
        launches.append((int(m.group(1)), int(m.group(2))))
        totals.append((int(t.group(1)), int(t.group(2))))
    left = [f for f in os.listdir(workdir) if ".host" in f]
    log(f"two hosts on one card (gloo on {coord}): {len(got)} merged "
        f"records, {n_diff} differ from the single run's {len(single)}; "
        f"report equal: {rep_merged == rep_single}; all-reduce totals "
        f"{totals} against the single run's ({E2E_ZMWS}, {bases}); sparse "
        f"and dense launches per host {launches}; {wall:.3f} s wall for "
        f"both processes (start-up, spawn of their prepare pools and the "
        f"merge included)")
    if len(got) != len(single) or n_diff or rep_merged != rep_single:
        raise RuntimeError("two hosts: the merged records or report differ "
                           "from the single run")
    if any(t != (E2E_ZMWS, bases) for t in totals):
        raise RuntimeError("two hosts: the all-reduce read other totals")
    if any(sp <= 0 for sp, _d in launches) or left:
        raise RuntimeError(f"two hosts: a host launched no sparse scorer, "
                           f"or host files remain: {left}")


def main() -> int:
    t_start = time.monotonic()
    phase_environment()
    import numpy as np
    import torch
    from ccs_tpu_torch.models.chemistry import default_params, load_model
    from ccs_tpu_torch.sim.simulator import make_subreads_header, simulate_zmw
    from ccs_tpu_torch.ops.tables import params_to_torch
    from ccs_tpu_torch.pipeline.orchestrator import shutdown_pool
    phase_build()
    rows, window_arrs = phase_kernels(
        default_params(), params_to_torch(default_params(), "cuda"))
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
            phase_dc_cli(workdir)
            phase_profile(workdir)
            # the CLI resolves the model from the BAM's chemistry; use the
            # same
            params = load_model(make_subreads_header().chemistry())
            phase_gpu_vs_cpu(sims, params)
            phase_dc_gpu_vs_cpu(sims, params, workdir)
            phase_sharded_engine(sims, params)
            phase_two_hosts(workdir)
            t0 = time.monotonic()
            phase_cli_modes(workdir)
            phase_scale(workdir)
            log(f"(k) took {time.monotonic() - t0:.1f} s")
        phase_dc_refine(window_arrs, default_params())
        phase_dc_train()
        t0 = time.monotonic()
        phase_brute_force(window_arrs, default_params())
        log(f"(i) took {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        phase_fitter()
        log(f"(j) took {time.monotonic() - t0:.1f} s")
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
    log(f"chip_smoke.py ran {time.monotonic() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
