"""The port's own copies of the framework-free host modules, each held
against its original in the JAX package on the same seeded inputs.

Outputs are compared as arrays, bytes or text, never as objects: the two
packages' classes (ZmwStatus, ZmwInput, ArrowParams, ...) are different
classes, so every result is first flattened to plain values (an enum to its
name, a dataclass to a dict of its fields). Bar: exact equality; the copies
run the same code. Plus the guard that a CPU run of the port's CLI imports
neither jax nor anything of ccs_tpu."""

import dataclasses
import enum
import gzip
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("ccs_tpu", "ccs_tpu_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _flat(x):
    """Plain, package-independent form of a result."""
    if isinstance(x, enum.Enum):
        return x.name
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _flat(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {_flat(k): _flat(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_flat(v) for v in x]
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, np.generic):
        return x.item()
    if x is None or isinstance(x, (bool, int, float, str, bytes)):
        return x
    raise TypeError(f"cannot flatten {type(x)}")


def _assert_same(a, b, where="result"):
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_same(u, v, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, (where, a, b)


def _sims(pkg, n=3, insert_len=220, with_pw=False):
    sim = _mod(pkg, "sim.simulator")
    return [sim.simulate_zmw(hole=h, insert_len=insert_len,
                             n_passes=[9, 2, 8, 6][h % 4], snr=8.5,
                             with_pw=with_pw) for h in range(n)]


def _zin(pkg, z):
    zmw = _mod(pkg, "pipeline.zmw")
    subs, qpos = [], 0
    for read, cx in zip(z.subreads, z.cx):
        subs.append(zmw.Subread(seq=read, cx=cx, qs=qpos,
                                qe=qpos + len(read)))
        qpos += len(read) + 40
    return zmw.ZmwInput(hole=z.hole, movie="m_test", subreads=subs,
                        snr=z.snr)


def _results(pkg):
    """A few ConsensusResults of different statuses for the reports."""
    zmw, st = _mod(pkg, "pipeline.zmw"), _mod(pkg, "statuses").ZmwStatus
    rng = np.random.default_rng(11)
    out = []
    for hole, status in enumerate([st.SUCCESS, st.SUCCESS, st.POOR_SNR,
                                   st.TOO_FEW_PASSES, st.SUCCESS]):
        n = 150 + 40 * hole
        ok = status == st.SUCCESS
        out.append(zmw.ConsensusResult(
            hole=hole, movie="m_test", status=status,
            seq=rng.integers(0, 4, n).astype(np.int8) if ok else None,
            qv=rng.uniform(5, 60, n).astype(np.float32) if ok else None,
            rq=0.999 - 0.003 * hole if ok else -1.0, num_passes=8 + hole,
            effective_coverage=7.5 + hole, insert_size=n,
            polymerase_length=10 * n, snr=np.full(4, 8.0, np.float32),
            n_windows=n // 22))
    return out


def _stats(pkg):
    st = _mod(pkg, "report.stats").RunStats()
    res = _results(pkg)
    st.add_zmws(len(res))
    for r in res:
        st.add(r)
    return st


# --- one case per copied module (or group): pkg -> a result to flatten ---

def case_statuses_config(pkg, tmp):
    statuses, config = _mod(pkg, "statuses"), _mod(pkg, "config")
    return {"statuses": [(s.name, s.value) for s in statuses.ZmwStatus],
            "labels": {s.name: v for s, v in statuses.REPORT_LABELS.items()},
            "config": config.CcsConfig()}


def case_dna(pkg, tmp):
    dna = _mod(pkg, "ops.dna")
    codes = np.random.default_rng(0).integers(0, 4, 77).astype(np.int8)
    packed = dna.pack_nibbles(codes)
    return [dna.decode(codes), dna.revcomp(codes), dna.encode("ACGTTGCA"),
            packed, dna.unpack_nibbles(packed, len(codes)),
            dna.revcomp_str(b"AACGT")]


def case_simulator(pkg, tmp):
    sim = _mod(pkg, "sim.simulator")
    return [_sims(pkg, 2, with_pw=True),
            sim.simulate_heteroduplex_zmw(hole=5, insert_len=150,
                                          n_passes=4)]


def case_bam_pbi_bytes(pkg, tmp):
    """Bytes from the two writers, and what the two readers make of them."""
    sim, bam = _mod(pkg, "sim.simulator"), _mod(pkg, "io.bam")
    pbi = _mod(pkg, "io.pbi")
    path = os.path.join(tmp, "in.subreads.bam")
    sim.write_subreads_bam(path, _sims(pkg, 3, with_pw=True))
    with open(path, "rb") as fh:
        bam_bytes = fh.read()
    with open(path + ".pbi", "rb") as fh:
        pbi_bytes = fh.read()
    with bam.BamReader(path) as r:
        recs = [(rec.name, rec.seq, rec.tag("cx"), rec.tag("sn"))
                for rec in r]
    idx = pbi.read_pbi(path + ".pbi")
    return {"bam": bam_bytes, "pbi": pbi_bytes, "records": recs,
            "zmws": idx.unique_zmws(), "chunks": idx.zmw_chunk_ranges(2),
            "header": bam.make_ccs_header("m_test", [{"ID": "x"}], "1.0",
                                          "ccs in out").text}


def case_fastq_xml(pkg, tmp):
    fastq, xml = _mod(pkg, "io.fastq"), _mod(pkg, "io.datasetxml")
    rng = np.random.default_rng(3)
    path = os.path.join(tmp, "o.fastq.gz")
    with fastq.FastqWriter(path) as w:
        for i in range(3):
            w.write(f"m/{i}/ccs", rng.integers(0, 4, 50).astype(np.int8),
                    rng.integers(0, 94, 50).astype(np.float32))
    fa = os.path.join(tmp, "c.fasta")
    with open(fa, "w") as fh:
        fh.write(">ctl\nACGTACGTTTGA\nCCA\n")
    xml.write_subreadset(os.path.join(tmp, "s.xml"),
                         os.path.join(tmp, "s.bam"), [1, 5, 9])
    with open(os.path.join(tmp, "s.xml")) as fh:
        text = fh.read()
    # drop the time stamps and random ids, which differ between two calls
    lines = [ln for ln in text.splitlines() if "reated" not in ln
             and "TimeStampedName" not in ln and "UniqueId" not in ln]
    with open(path, "rb") as fh:
        return {"fastq": gzip.decompress(fh.read()),
                "fasta": fastq.read_fasta(fa), "xml": lines}


def case_bin_qvs(pkg, tmp):
    qvbin = _mod(pkg, "pipeline.qvbin")
    qv = np.random.default_rng(4).uniform(0, 95, 300).astype(np.float32)
    return [qvbin.bin_qvs(qv), qvbin.qv_to_ascii(qv)]


def case_load_model(pkg, tmp):
    chem, sim = _mod(pkg, "models.chemistry"), _mod(pkg, "sim.simulator")
    p = chem.load_model(sim.make_subreads_header().chemistry())
    bases = np.arange(8, dtype=np.int8) % 4
    return [p, chem.default_params(),
            chem.pack_read_pw(bases, np.arange(8) % 4),
            [int(p.snr_bin(s)) for s in (2.0, 6.0, 9.0, 20.0)]]


NATIVE_SYMBOLS = ("ccs_edit_align", "ccs_affine_align", "ccs_anchor_chain",
                  "ccs_pileup_draft", "ccs_dust_profile",
                  "ccs_guided_identity", "ccs_orient_chain_batch",
                  "ccs_chain_batch")


def case_native_symbols(pkg, tmp):
    lib = _mod(pkg, "native").load()
    assert lib is not None, f"{pkg}: the native aligner did not load"
    assert f"{pkg}_native_" in lib._name or \
        os.path.dirname(_mod(pkg, "native").__file__) in lib._name
    return [hasattr(lib, s) for s in NATIVE_SYMBOLS]


def _read_pair(seed, n=260):
    rng = np.random.default_rng(seed)
    tpl = rng.integers(0, 4, n).astype(np.int8)
    keep = rng.random(n) > 0.04
    read = np.where(rng.random(n) < 0.05, rng.integers(0, 4, n), tpl)
    return read[keep].astype(np.int8), tpl


def case_align_sdust(pkg, tmp):
    align, sdust = _mod(pkg, "ops.align"), _mod(pkg, "ops.sdust")
    read, tpl = _read_pair(6)
    chain = align.anchor_chain(read, tpl)
    rep = np.tile(np.array([0, 1, 2], np.int8), 500)
    return [align.edit_align(read, tpl), align.affine_align(read, tpl),
            align.guided_align(read, tpl), chain,
            align.interp_read_pos(chain, np.arange(0, len(tpl), 25),
                                  len(read), len(tpl)),
            align.chain_batch([read, read[10:]], tpl),
            align.orient_chain_batch([read, read[::-1].copy()], tpl),
            sdust.dust_score_profile(tpl), sdust.has_long_tandem_repeat(rep),
            sdust.max_tandem_repeat_length(np.concatenate([tpl, rep]))]


def case_draft_windows(pkg, tmp):
    draft, windows = _mod(pkg, "pipeline.draft"), _mod(pkg, "pipeline.windows")
    z = _sims(pkg, 1)[0]
    d = draft.generate_draft(z.subreads, [True] * len(z.subreads))
    return [d, windows.cut_windows(d.draft), windows.hp_run_mask(d.draft),
            windows.repeat_runs(d.draft)]


def case_prepare_zmw(pkg, tmp):
    """prepare_zmw (filters, draft, build_window_batch) on simulated ZMWs:
    one passes, one lacks passes, one has poor SNR."""
    zmw, chem = _mod(pkg, "pipeline.zmw"), _mod(pkg, "models.chemistry")
    cfg = _mod(pkg, "config").CcsConfig()
    params = chem.default_params()
    sims = _sims(pkg, 3, with_pw=False)
    sims[2].snr[:] = 1.0
    items = [zmw.prepare_zmw(_zin(pkg, z), cfg, params.snr_edges,
                             params=params) for z in sims]
    assert [it.result.status.name for it in items] == [
        "SUCCESS", "TOO_FEW_PASSES", "POOR_SNR"]
    assert items[0].batch is not None and items[0].batch.tpl.shape[0] > 5
    fwd, rev = zmw.split_by_strand(_zin(pkg, sims[0]))
    return [items, fwd, rev]


def case_adapters_hd_kinetics(pkg, tmp):
    ad, hd = _mod(pkg, "pipeline.adapters"), _mod(pkg, "pipeline.heteroduplex")
    kin = _mod(pkg, "pipeline.kinetics")
    frames = np.arange(0, 1000, 7)
    codes = kin.codec_v1_encode(frames)
    rpos = [np.arange(0, 300, 3), np.arange(0, 330, 3) + (np.arange(110) > 50)
            * 30, None]
    return [ad.adapter_counts([3, 1, 2, 3, 0], [0, 1, 0, 1, 0]),
            ad.classify_adapter_artifacts(_read_pair(8)[0]),
            codes, kin.codec_v1_decode(codes),
            hd.strand_span_difference(rpos, [0, 1, 0], 20, 60)]


def case_hmm_oracle(pkg, tmp):
    """The numpy log-space oracle: forward and backward matrices, the
    marginal LL and the path enumeration, with pulse-width codes."""
    oracle, chem = _mod(pkg, "ops.hmm_oracle"), _mod(pkg, "models.chemistry")
    params = chem.default_params()
    rng = np.random.default_rng(12)
    tpl = rng.integers(0, 4, 9).astype(np.int8)
    read = chem.pack_read_pw(rng.integers(0, 4, 11), rng.integers(0, 4, 11))
    small_t, small_r = tpl[:4], read[:5]
    return [oracle.position_tables(tpl, params, 3),
            oracle.decode_read(read, params, 3),
            oracle.forward_matrix(tpl, read, params, 3),
            oracle.backward_matrix(tpl, read, params, 3),
            oracle.forward_ll(tpl, read, params, 3),
            oracle.forward_ll(tpl[:0], read[:0], params),
            oracle.brute_force_ll(small_t, small_r, params, 5)]


def case_report_text(pkg, tmp):
    stats = _mod(pkg, "report.stats")
    st = _stats(pkg)
    path = os.path.join(tmp, "m.json.gz")
    _mod(pkg, "report.metrics").write_zmw_metrics(path, st)
    with open(path, "rb") as fh:
        metrics = gzip.decompress(fh.read())
    hifi = stats.hifi_summary_dict(st)
    # rates per hour of wall time since the RunStats was made
    hifi = {k: v for k, v in hifi.items() if "per_hr" not in k}
    return {"report": stats.format_ccs_report(st),
            "strand": stats.format_ccs_report_strand(st),
            "json": stats.report_json_dict(st), "hifi": hifi,
            "metrics": metrics}


def case_checkpoint_round_trip(pkg, tmp):
    ckpt, bam = _mod(pkg, "pipeline.checkpoint"), _mod(pkg, "io.bam")
    header = bam.make_ccs_header("m_test", [{"ID": "x"}], "1.0", "ccs")
    recs = [bam.BamRecord(name=f"m_test/{r.hole}/ccs", seq=r.seq,
                          qual=np.clip(r.qv, 0, 93).astype(np.uint8),
                          tags={"np": bam.TagValue("i", r.num_passes)})
            for r in _results(pkg) if r.seq is not None]
    d = os.path.join(tmp, "ckpt")
    c = ckpt.Checkpointer(d, header)
    c.write_batch(recs[:2], [], _stats(pkg), last_hole=1)
    c.write_batch(recs[2:], recs[:1], _stats(pkg), last_hole=4)
    c2 = ckpt.Checkpointer(d, header)
    out = {"next": c2.next_batch, "resume": c2.resume_hole,
           "skip": [c2.should_skip(h) for h in (0, 4, 5)],
           "stats": ckpt.stats_delta_dict(c2.completed_stats()),
           "records": [(r.name, r.seq, r.tag("np"))
                       for r in c2.iter_batch_records()],
           "fail": [r.name for r in c2.iter_batch_records(fail=True)]}
    with open(os.path.join(d, "batch_1.bam"), "rb") as fh:
        out["bytes"] = fh.read()
    c2.cleanup()
    out["left"] = sorted(os.listdir(d))
    return out


CASES = {name[5:]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_copy_equals_original(name, tmp_path):
    results = []
    for pkg in PACKAGES:
        tmp = tmp_path / pkg
        tmp.mkdir()
        results.append(_flat(CASES[name](pkg, str(tmp))))
    _assert_same(*results)


COPIED_MODULES = (
    "statuses", "config", "ops.dna", "ops.align", "ops.sdust",
    "ops.hmm_oracle", "io.bgzf",
    "io.bam", "io.pbi", "io.fastq", "io.datasetxml", "models.chemistry",
    "models.fit", "models.fit_bundle", "native", "pipeline.qvbin",
    "pipeline.draft", "pipeline.windows", "pipeline.adapters",
    "pipeline.heteroduplex", "pipeline.kinetics", "pipeline.zmw",
    "pipeline.checkpoint", "report.stats", "report.metrics", "sim.simulator")


@pytest.mark.parametrize("name", COPIED_MODULES)
def test_copy_has_the_originals_names(name):
    """Same relative path, same names: a reader finds the counterpart of a
    module, and of each function in it, at once."""
    a, b = _mod("ccs_tpu", name), _mod("ccs_tpu_torch", name)
    assert sorted(vars(a).keys() - {"__builtins__"}) == sorted(
        vars(b).keys() - {"__builtins__"})
    for data in ("arrow_101-894-200.json", "clean_perr_v0.npy"):
        paths = [os.path.join(ROOT, pkg, "models", "data", data)
                 for pkg in PACKAGES]
        with open(paths[0], "rb") as fa, open(paths[1], "rb") as fb:
            assert fa.read() == fb.read(), data


def test_native_caches_are_separate():
    a = _mod("ccs_tpu", "native").load()
    b = _mod("ccs_tpu_torch", "native").load()
    assert a is not None and b is not None
    assert os.path.realpath(a._name) != os.path.realpath(b._name)


def test_cli_cpu_run_imports_neither_jax_nor_ccs_tpu(tmp_path):
    """The verify recipe's 3-ZMW fixture through the port's CLI on the CPU,
    in a fresh interpreter; then no module of jax or ccs_tpu is loaded."""
    code = (
        "import sys\n"
        "import ccs_tpu_torch.cli as cli\n"
        "from ccs_tpu_torch.sim.simulator import simulate_zmw, "
        "write_subreads_bam\n"
        "from ccs_tpu_torch.io.bam import BamReader\n"
        "from ccs_tpu_torch.pipeline.orchestrator import shutdown_pool\n"
        "zmws = [simulate_zmw(hole=h, insert_len=200, n_passes=[9,2,8][h],"
        " snr=[8.5,8.5,1.0][h]) for h in range(3)]\n"
        "write_subreads_bam('in.subreads.bam', zmws)\n"
        "rc = cli.run(['in.subreads.bam', 'out.bam'], device='cpu')\n"
        "shutdown_pool()\n"
        "with BamReader('out.bam') as r:\n"
        "    n = sum(1 for _ in r)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'ccs_tpu')"
        " or m.startswith(('jax.', 'ccs_tpu.')))\n"
        "print(rc, n, bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=600)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "0 1 []"
    report = (tmp_path / "out.ccs_report.txt").read_text()
    assert "ZMWs input" in report
