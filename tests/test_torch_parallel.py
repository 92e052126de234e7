"""The port's parallel layer (``ccs_tpu_torch.parallel.mesh`` and
``.multihost``) held against its own single-device path and the JAX
package, on the CPU: shards are CPU devices, each on a thread of its own.

Bars: the sharded polish step's templates and lengths identical to the
single-device step's and to JAX's ``polish_windows_fused`` (the twin of
``tests/test_mesh.py``), QVs within 1e-3, counters equal to the local
reduction exactly. The sharded engine against the single-device port
engine and the JAX engine on tie-free ZMWs: statuses and sequences
identical, QVs within 1e-3 (``__graft_entry__.py:142-151``), polish
counters equal. Two hosts merge to a single port run exactly (records,
.pbi, report, metrics) and to the JAX package's merged run at the
engine bars; the gloo all-reduce of int64 counters is exact."""

import gzip
import json
import os
import socket
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccs_tpu.cli import run as run_jax
from ccs_tpu.config import CcsConfig as JaxConfig
from ccs_tpu.models.chemistry import default_params as jax_default_params
from ccs_tpu.ops.hmm_jax import params_to_device
from ccs_tpu.pipeline import orchestrator as jax_orchestrator
from ccs_tpu.pipeline import zmw as jax_zmw
from ccs_tpu.pipeline.engine import CcsEngine as JaxEngine
from ccs_tpu.pipeline.polish_fused import polish_windows_fused
from ccs_tpu_torch import cli
from ccs_tpu_torch.config import CcsConfig
from ccs_tpu_torch.io.bam import BamReader
from ccs_tpu_torch.io.pbi import read_pbi
from ccs_tpu_torch.models.chemistry import default_params
from ccs_tpu_torch.ops import _build
from ccs_tpu_torch.ops.tables import params_to_torch
from ccs_tpu_torch.parallel import mesh
from ccs_tpu_torch.parallel.step import make_polish_step
from ccs_tpu_torch.pipeline import zmw as port_zmw
from ccs_tpu_torch.pipeline.engine import CcsEngine
from ccs_tpu_torch.pipeline.orchestrator import shutdown_pool
from ccs_tpu_torch.sim.simulator import (simulate_read, simulate_zmw,
                                         write_subreads_bam)
from ccs_tpu_torch.statuses import ZmwStatus

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _stop_prepare_pools():
    yield
    shutdown_pool()
    if jax_orchestrator._PROC_POOL is not None:
        jax_orchestrator._PROC_POOL.shutdown(wait=True)
        jax_orchestrator._PROC_POOL = None


# -- device resolution ------------------------------------------------------

@pytest.fixture
def visible_cards(monkeypatch):
    """Pretend ``n`` CUDA cards are visible (0: no CUDA at all)."""
    def set_cards(n):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    return set_cards


@pytest.mark.parametrize("cards, kw, want", [
    (3, {}, ["cuda:0", "cuda:1", "cuda:2"]),
    (3, {"n_devices": 2}, ["cuda:0", "cuda:1"]),
    (1, {}, ["cuda:0"]),
    (0, {"devices": ["cpu", "cpu"]}, ["cpu", "cpu"]),
])
def test_make_zmw_mesh(visible_cards, cards, kw, want):
    visible_cards(cards)
    assert mesh.make_zmw_mesh(**kw) == [torch.device(d) for d in want]


def test_make_zmw_mesh_without_cuda_raises(visible_cards):
    visible_cards(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_zmw_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        CcsEngine(CcsConfig(), None, None)


def test_cli_resolves_every_visible_card(visible_cards):
    visible_cards(2)
    assert cli.resolve_device(None) == [torch.device("cuda", 0),
                                        torch.device("cuda", 1)]
    assert cli.resolve_device("cpu") == [torch.device("cpu")]
    assert cli.resolve_device(["cpu", "cpu"]) == [torch.device("cpu")] * 2


@pytest.mark.parametrize("shape, devices, n_dev, w_buckets", [
    (None, ["cpu", "cpu"], 2, (256, 2048)),
    ((1,), ["cpu", "cpu"], 1, (256, 2048)),
    ((2,), ["cpu"] * 3, 2, (256, 2048)),
    (None, ["cpu"] * 3, 3, (258, 2049)),
])
def test_engine_device_count(shape, devices, n_dev, w_buckets):
    """tpu_mesh_shape takes the first prod(shape) devices; window buckets
    round up to a multiple of the device count (ccs_tpu engine.py:189)."""
    eng = CcsEngine(CcsConfig(tpu_mesh_shape=shape), None, devices)
    assert eng.n_dev == n_dev and len(eng.devices) == n_dev
    assert eng.w_buckets == w_buckets


def test_shard_slices():
    assert mesh.shard_slices(6, 3) == [slice(0, 2), slice(2, 4),
                                       slice(4, 6)]
    with pytest.raises(ValueError, match="equal shards"):
        mesh.shard_slices(7, 2)


class _YieldingCounter:
    """A ``launches`` attribute whose read lets another thread run between
    the read and the write of ``+= 1``, as a free-threaded interpreter
    may: without the lock, increments are lost."""

    def __init__(self):
        self._n = 0

    @property
    def launches(self):
        n = self._n
        time.sleep(0)
        return n

    @launches.setter
    def launches(self, n):
        self._n = n


def test_launch_counter_loses_no_increment():
    """Shard threads launch at once; the counter must not lose updates."""
    wrapper = _YieldingCounter()
    n_threads, per_thread = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.count_launch(wrapper) for _ in range(per_thread)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == n_threads * per_thread


# -- the sharded polish step (twin of tests/test_mesh.py) -------------------

@pytest.fixture(scope="module")
def window_batch():
    """test_mesh.py's batch: 16 windows, 8 subreads, one error each."""
    rng = np.random.default_rng(0)
    params = default_params()
    B, C, T_CAP, R_CAP = 16, 8, 48, 56
    tpl = np.full((B, T_CAP), -1, np.int8)
    tlen = np.zeros(B, np.int32)
    reads = np.full((B, C, R_CAP), -1, np.int8)
    rlens = np.full((B, C), -1, np.int32)
    for b in range(B):
        tl = int(rng.integers(22, 30))
        t = rng.integers(0, 4, tl).astype(np.int8)
        corrupt = t.copy()
        p = int(rng.integers(0, tl))
        corrupt[p] = (corrupt[p] + 1) % 4
        tpl[b, :tl] = corrupt
        tlen[b] = tl
        for c in range(C):
            r = simulate_read(t, params, 3, rng)[:R_CAP]
            reads[b, c, :len(r)] = r
            rlens[b, c] = len(r)
    return (tpl, tlen, np.full(B, 4, np.int32), tlen - 4,
            np.full(B, 3, np.int32), reads, rlens, np.zeros(B, dtype=bool),
            np.ones((B, T_CAP), np.float32))


@pytest.mark.parametrize("n_shards, sparse, compact, presharded", [
    (4, False, False, False),
    (2, True, True, False),
    (4, False, True, True),
])
def test_sharded_step_equals_single_and_jax(window_batch, n_shards, sparse,
                                            compact, presharded):
    args = window_batch
    tables = params_to_torch(default_params(), "cpu")
    kw = dict(max_iters=6, sparse=sparse, compact=compact)
    st1, qv1, stats1 = make_polish_step(tables, "cpu", **kw)(*args)
    devices = ["cpu"] * n_shards
    fn = mesh.shard_fused_polish(devices, [tables] * n_shards, **kw)
    call = mesh.device_put_sharded_batch(devices, args) if presharded \
        else args
    st, qv, stats = fn(*call)
    jst, jqv, _ = polish_windows_fused(
        *map(jnp.asarray, args[:7]), params_to_device(jax_default_params()),
        max_iters=6, is_first=jnp.asarray(args[7]),
        priority=jnp.asarray(args[8]), sparse=sparse)
    for got in (st1, st):
        np.testing.assert_array_equal(got.tpl.numpy(), np.asarray(jst.tpl))
        np.testing.assert_array_equal(got.tlen.numpy(),
                                      np.asarray(jst.tlen))
    for f in st._fields:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      getattr(st1, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(qv.numpy(), qv1.numpy())
    np.testing.assert_allclose(qv.numpy(), np.asarray(jqv), rtol=0,
                               atol=1e-3)
    # counters: int64, equal to the local reduction over the whole batch
    live = (args[6] >= 0).any(-1)
    s = st1
    want = [int((~s.active.numpy() & live).sum()), int(s.n_iter.sum()),
            int(np.where(live, np.maximum(s.core_end.numpy()
                                          - s.core_start.numpy(), 0),
                         0).sum())]
    assert stats.dtype == torch.int64
    assert stats.tolist() == stats1.tolist() == want
    assert want[1] > 0


# -- the sharded engine -----------------------------------------------------

def _zin(z, zmw=port_zmw):
    subs, qpos = [], 0
    for read, cx in zip(z.subreads, z.cx):
        subs.append(zmw.Subread(seq=read, cx=cx, qs=qpos,
                                qe=qpos + len(read)))
        qpos += len(read) + 40
    return zmw.ZmwInput(hole=z.hole, movie="m_test", subreads=subs,
                        snr=z.snr)


ENGINE_KW = dict(tpu_window_buckets=(64,), tpu_coverage_buckets=(16,),
                 tpu_window_coverage_cap=16)
# the tie-free holes of test_torch_engine.test_engine_matches_jax_engine
ENGINE_HOLES = ((6, 8), (8, 10), (7, 2), (9, 8), (11, 10), (12, 8))
ENGINE_CASES = {
    "default": ({}, 2),
    "dc": (dict(tpu_dc_polish=True, tpu_dc_qv_thresh=33.5), 2),
    "disable_heuristics": (dict(disable_heuristics=True), 2),
    "three_devices": ({}, 3),
}


@pytest.fixture(scope="module")
def engine_zmws():
    return [simulate_zmw(hole=h, insert_len=250, n_passes=n, snr=9.0)
            for h, n in ENGINE_HOLES]


@pytest.fixture(scope="module")
def single_device_runs(engine_zmws):
    """Per configuration, made once: (the single-device port engine after
    its run, its results, the JAX engine's results)."""
    runs = {}

    def get(extra):
        key = tuple(sorted(extra.items()))
        if key not in runs:
            kw = dict(ENGINE_KW, **extra)
            single = CcsEngine(CcsConfig(**kw), None, "cpu")
            one = single.process_batch([_zin(z) for z in engine_zmws])
            ref = JaxEngine(JaxConfig(**kw),
                            devices=jax.devices()[:1]).process_batch(
                [_zin(z, jax_zmw) for z in engine_zmws])
            runs[key] = (single, one, ref)
        return runs[key]
    return get


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_sharded_engine_equals_single_and_jax(engine_zmws,
                                              single_device_runs, case):
    extra, n_dev = ENGINE_CASES[case]
    sharded = CcsEngine(CcsConfig(**ENGINE_KW, **extra), None,
                        ["cpu"] * n_dev)
    assert sharded.n_dev == n_dev
    assert sharded.w_buckets == (-(-64 // n_dev) * n_dev,)
    got = sharded.process_batch([_zin(z) for z in engine_zmws])
    single, one, ref = single_device_runs(extra)
    assert single.n_dev == 1
    assert sum(r.status == ZmwStatus.SUCCESS for r in got) == 5
    for g, o, r in zip(got, one, ref):
        assert g.status == o.status and g.status.name == r.status.name
        if r.seq is None:
            assert g.seq is None and o.seq is None
            continue
        np.testing.assert_array_equal(g.seq, o.seq)
        np.testing.assert_array_equal(g.seq, r.seq)
        np.testing.assert_allclose(g.qv, o.qv, rtol=0, atol=1e-3)
        np.testing.assert_allclose(g.qv, r.qv, rtol=0, atol=1e-3)
        assert abs(g.rq - o.rq) < 1e-3 and abs(g.rq - r.rq) < 1e-3
    np.testing.assert_array_equal(sharded.polish_stats, single.polish_stats)
    assert sharded.polish_stats[1] > 0
    np.testing.assert_array_equal(sharded.dc_stats, single.dc_stats)
    if case == "dc":
        assert sharded.dc_stats[3] == 2


# -- multi-host (twins of tests/test_multihost.py) --------------------------

@pytest.fixture(scope="module")
def subreads_bam(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mh") / "in.subreads.bam")
    write_subreads_bam(path, [
        simulate_zmw(hole=h, insert_len=220, n_passes=8, snr=9.0)
        for h in range(8)])
    return path


@pytest.fixture(scope="module")
def single_run(subreads_bam, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("single") / "single.bam")
    assert cli.run([subreads_bam, out, "-j", "1"], device="cpu") == 0
    return out


def _records(path):
    with BamReader(path) as r:
        return [(rec.name, rec.seq.tobytes(), rec.qual.tobytes(),
                 rec.tag("rq"), rec.tag("np")) for rec in r]


def _metrics(prefix):
    with gzip.open(prefix + ".zmw_metrics.json.gz") as fh:
        return json.load(fh)


def _read(path):
    with open(path) as fh:
        return fh.read()


def test_two_hosts_merge_equals_single(subreads_bam, single_run, tmp_path):
    merged = str(tmp_path / "merged.bam")
    # sequential hosts on a shared filesystem: host 1 first, then host 0,
    # which finds the sentinel and merges
    for i in (1, 0):
        assert cli.run([subreads_bam, merged, "-j", "1", "--tpu-num-hosts",
                        "2", "--tpu-host-id", str(i)], device="cpu") == 0
    rec_m, rec_s = _records(merged), _records(single_run)
    assert len(rec_s) == 8 and rec_m == rec_s
    # .pbi: every column equal; the offsets differ (the @PG lines name
    # other arguments) but each points at its record
    pm, ps = read_pbi(merged + ".pbi"), read_pbi(single_run + ".pbi")
    for col in ("rg_id", "q_start", "q_end", "hole_number", "read_qual",
                "ctxt_flag"):
        np.testing.assert_array_equal(getattr(pm, col), getattr(ps, col))
    with BamReader(merged) as r:
        for off, want in zip(pm.file_offset, rec_s):
            r.seek_virtual(int(off))
            rec = r.read_record()
            assert (rec.name, rec.seq.tobytes()) == want[:2]
    prefix_s = single_run[:-len(".bam")]
    assert _read(str(tmp_path / "merged.ccs_report.txt")) == \
        _read(prefix_s + ".ccs_report.txt")
    assert _metrics(str(tmp_path / "merged")) == _metrics(prefix_s)
    assert len(_metrics(prefix_s)["zmws"]) == 8
    left = [p for p in os.listdir(tmp_path) if ".host" in p]
    assert not left, left

    # the JAX package's merged run, at the engine bars
    merged_j = str(tmp_path / "jax" / "merged.bam")
    os.makedirs(os.path.dirname(merged_j))
    for i in (1, 0):
        assert run_jax([subreads_bam, merged_j, "-j", "1", "--tpu-num-hosts",
                        "2", "--tpu-host-id", str(i)]) == 0
    rec_j = _records(merged_j)
    assert [r[0] for r in rec_j] == [r[0] for r in rec_m]
    for a, b in zip(rec_j, rec_m):
        assert a[1] == b[1] and a[4] == b[4]
        assert abs(a[3] - b[3]) < 1e-3
    # every line of the reports but the count of bases at >= Q30: these
    # holes are not tie-free, and per-base QVs at a tie differ from the
    # JAX loop's (ROADMAP Queue 3, ties settled by rounding)
    rep_j, rep_m = (_read(str(p)).splitlines() for p in (
        tmp_path / "jax" / "merged.ccs_report.txt",
        tmp_path / "merged.ccs_report.txt"))
    assert [ln for ln in rep_j if not ln.startswith("Base quality")] == \
        [ln for ln in rep_m if not ln.startswith("Base quality")]


@pytest.mark.parametrize("flags", [["--tpu-host-id", "5"],
                                   ["--tpu-host-id", "0", "--chunk", "1/2"]])
def test_host_id_validation(subreads_bam, tmp_path, flags):
    with pytest.raises(SystemExit):
        cli.run([subreads_bam, str(tmp_path / "x.bam"), "--tpu-num-hosts",
                 "2", *flags], device="cpu")


_HOST = """
import logging, sys
import numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
logging.basicConfig(level=logging.INFO, stream=sys.stderr)
from ccs_tpu_torch import cli
from ccs_tpu_torch.parallel.multihost import allreduce_counters
i, coord, bam, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
rc = cli.run([bam, out, '-j', '1', '--log-level', 'INFO', '--tpu-num-hosts',
              '2', '--tpu-host-id', str(i), '--tpu-coordinator', coord],
             device='cpu')
assert rc == 0, rc
tot = allreduce_counters(np.asarray([2 ** 40 + i, i], np.int64), True)
print('SUM', int(tot[0]), int(tot[1]), tot.dtype, flush=True)
dist.destroy_process_group()
"""


def test_two_process_gloo(subreads_bam, single_run, tmp_path):
    """Two real processes joined by a gloo process group: the merged output
    equals the single run, and the int64 all-reduce is exact past 2^24."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    merged = str(tmp_path / "merged2p.bam")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _HOST, str(i), coord, subreads_bam, merged],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for i in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            outs.append((out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for out, err in outs:
        assert f"SUM {2 ** 41 + 1} 1 int64" in out, out
        assert "gloo process group" in err, err[-3000:]
        assert "cluster totals via all_reduce: 8 ZMWs" in err, err[-3000:]
    assert _records(merged) == _records(single_run)
