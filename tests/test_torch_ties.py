"""Where the port's polish loop and the JAX loop select different mutations,
and why: the two loops are driven iteration by iteration through their
public functions (score_all / select_mutations / apply_mutations) on the
windows of simulated ZMWs, and every window's first differing selection is
classified.

Deleting any base of a homopolymer run gives one template, and so does
inserting x at any junction along a run of x (the prepend is the junction
before position 0): such mutations form a class whose members score the
same in exact arithmetic. The reference rule is "leftmost wins ties". The
JAX loop applies it to rounded float32 scores, so rounding picks the member
(and, through the radius-2 spacing filter, sometimes whether the class is
applied in this iteration, or twice). The port gives every member the class
maximum first (polish_fused.equalize_equivalent), so the rule sees the
exact-arithmetic tie.

A difference is of kind (a), a tie settled by rounding, when
  1. every pick that only one loop made belongs to a class of at least two
     valid members whose JAX scores agree within the scorer's bar (5e-3,
     the bar of the mutation scores themselves), and
  2. the JAX select_mutations, run on the JAX scores with each class given
     its maximum, selects exactly what the port selected.
Kind "a1" has the same classes picked through other members, "a2" has a
class that one loop applies and the other postpones or applies twice.
Anything else is kind (b): a result of the port that differs from the
reference for another reason."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccs_tpu.models.chemistry import default_params as jax_default_params
from ccs_tpu.ops.hmm_jax import params_to_device
from ccs_tpu.pipeline import polish_fused as jpf
from ccs_tpu_torch.cli import iter_zmws
from ccs_tpu_torch.config import CcsConfig
from ccs_tpu_torch.io.bam import BamReader
from ccs_tpu_torch.pipeline import polish_fused as tpf
from ccs_tpu_torch.pipeline import zmw as port_zmw
from ccs_tpu_torch.pipeline.engine import CcsEngine
from ccs_tpu_torch.sim.simulator import (simulate_heteroduplex_zmw,
                                         simulate_zmw, write_subreads_bam)

torch.set_num_threads(1)

LLS_TOL = 5e-3
CAREFUL_AFTER = 6          # both loops' default
ROW_PAD = 16               # batches are padded so the jitted scorer is shared
ENGINE_KW = dict(tpu_window_buckets=(64,), tpu_coverage_buckets=(16,),
                 tpu_window_coverage_cap=16)
# the pinned set of tests/test_torch_engine.py: holes 0..33, 8 + hole % 3
# passes, SNR 9, 250 bp. Holes whose engine output differs from the JAX
# engine's (1 sequence, 14 QV sets), and every hole with a window whose
# selection differs at some iteration, by the kinds of its windows.
OUTPUT_DIFFS = [0, 1, 2, 5, 7, 10, 13, 16, 20, 23, 24, 25, 27, 29, 31]
KINDS_BY_HOLE = {
    0: ["a1"], 1: ["a1"], 2: ["a2", "a1"], 5: ["a1", "a1"], 7: ["a1"],
    10: ["a1"], 11: ["a2"], 13: ["a2"], 16: ["a1"], 17: ["a2", "a1"],
    20: ["a1", "a1", "a1", "a1"], 21: ["a1"], 23: ["a1"], 24: ["a1"],
    25: ["a1", "a1"], 27: ["a1"], 29: ["a1", "a1", "a1"], 31: ["a1"],
    33: ["a2"]}


def _jax_class_max(vals, seg):
    """The maximum of vals [B, N] over each segment id of seg [B, N],
    written back to every member."""
    def row(v, sg):
        return jax.ops.segment_max(v, sg, num_segments=v.shape[0])[sg]
    return jax.vmap(row)(vals, seg)


def jax_equalize_equivalent(lls, tpl):
    """polish_fused.equalize_equivalent (the port's tie rule) on JAX
    arrays, for use inside the JAX loop's jit."""
    B, T = tpl.shape
    t = tpl.astype(jnp.int32)
    reg = lls[:, :9 * T].reshape(B, T, 9)
    start = jnp.concatenate([jnp.ones((B, 1), bool), t[:, 1:] != t[:, :-1]],
                            axis=1)
    dl = reg[..., 4]
    dl = jnp.where(dl > jpf.NEG / 2,
                   _jax_class_max(dl, jnp.cumsum(start, axis=1) - 1), dl)
    junc = jnp.concatenate([lls[:, 9 * T:][:, None, :], reg[..., 5:]],
                           axis=1)                         # [B, T+1, 4]
    jstart = jnp.concatenate([jnp.ones((B, 1, 4), bool),
                              t[:, :, None] != jnp.arange(4)], axis=1)
    cm = jax.vmap(_jax_class_max, in_axes=2, out_axes=2)(
        junc, jnp.cumsum(jstart, axis=1) - 1)
    junc = jnp.where(junc > jpf.NEG / 2, cm, junc)
    reg = jnp.concatenate([reg[..., :4], dl[..., None], junc[:, 1:]], axis=-1)
    return jnp.concatenate([reg.reshape(B, 9 * T), junc[:, 0]], axis=1)


@contextlib.contextmanager
def jax_ties_resolved():
    """While in the block, the JAX loop's scorer gives every class of
    equivalent mutations its maximum, as the port does: a JAX run then
    differs from the port's only by something other than a tie settled by
    rounding. The JAX package's files are untouched."""
    orig = jpf.score_all

    def score_all(tpl, *args, **kw):
        lls, ll0 = orig(tpl, *args, **kw)
        return jax_equalize_equivalent(lls, tpl), ll0

    jpf.score_all = score_all
    try:
        yield
    finally:
        jpf.score_all = orig


def heteroduplex_with_kinetics(path):
    """The heteroduplex of the strand-mode divergence (tests/
    test_torch_cli_strand.py): hole 11, 400 bp, 12 passes, a 40 bp
    insertion on the reverse strand, SNR 9, written with kinetics tags
    (pulse widths reach the polish as pw bins)."""
    write_subreads_bam(path, [simulate_heteroduplex_zmw(
        hole=11, insert_len=400, n_passes=12, ins_len=40, snr=9.0)],
        with_kinetics=True)


def _zin(z):
    subs, qpos = [], 0
    for read, cx in zip(z.subreads, z.cx):
        subs.append(port_zmw.Subread(seq=read, cx=cx, qs=qpos,
                                     qe=qpos + len(read)))
        qpos += len(read) + 40
    return port_zmw.ZmwInput(hole=z.hole, movie="m_test", subreads=subs,
                             snr=z.snr)


@functools.lru_cache(maxsize=1)
def _jax_scorer():
    tables = params_to_device(jax_default_params())
    return jax.jit(lambda t, tl, sb, rd, rl, cand: jpf.score_all(
        t, tl, sb, rd, rl, tables, cand=cand))


def _window_rows(zmws, cfg_kw):
    """The polish inputs of every window of the ZMWs, as the engine stages
    them under the config ``cfg_kw`` (the host prepare is the port's; it is
    held equal to the JAX package's by test_torch_host.py), padded with dead
    rows."""
    eng = CcsEngine(CcsConfig(**cfg_kw), None, "cpu")
    cfg = eng.cfg
    items = eng.prepare_batch(zmws)
    assert not any(it.terminal or it.result.has_tandem_repeat for it in items)
    rows = [(it, w) for it in items for w in range(len(it.batch.windows))]
    n = -(-len(rows) // ROW_PAD) * ROW_PAD
    T, R, C = cfg.tpu_window_tpl_cap, cfg.tpu_window_read_cap, 16
    a = dict(tpl=np.full((n, T), -1, np.int8), tlen=np.ones(n, np.int32),
             cs=np.zeros(n, np.int32), ce=np.zeros(n, np.int32),
             snr_bin=np.zeros(n, np.int32),
             reads=np.full((n, C, R), -1, np.int8),
             rlens=np.full((n, C), -1, np.int32),
             is_first=np.zeros(n, bool), pri=np.zeros((n, T), np.float32),
             hole=np.full(n, -1), win=np.full(n, -1),
             strand=np.full(n, "", object))
    for i, (it, w) in enumerate(rows):
        b = it.batch
        cc = min(b.reads.shape[1], C)
        a["tpl"][i], a["tlen"][i] = b.tpl[w], b.tlen[w]
        a["cs"][i], a["ce"][i] = b.core_start[w], b.core_end[w]
        a["snr_bin"][i] = it.snr_bin
        a["reads"][i, :cc], a["rlens"][i, :cc] = b.reads[w, :cc], b.rlens[w, :cc]
        a["is_first"][i] = w == 0
        a["pri"][i] = b.priority[w]
        a["hole"][i], a["win"][i] = it.zmw.hole, w
        a["strand"][i] = it.result.strand
    a["pri"] = np.where(np.arange(T)[None, :] < a["tlen"][:, None],
                        a["pri"], 0.0).astype(np.float32)
    return a, eng.tables, cfg


def _class_of(tpl, p, k):
    """Class of mutation (p, k) on ``tpl`` (k 0..8; p = -1 is prepend k)."""
    if p >= 0 and k <= 3:
        return ("sub", p, k)
    if p >= 0 and k == 4:
        q = p
        while q > 0 and tpl[q - 1] == tpl[p]:
            q -= 1
        return ("del", q)
    x, j = (k - 5, p + 1) if p >= 0 else (k, 0)
    while j > 0 and tpl[j - 1] == x:
        j -= 1
    return ("ins", x, j)


def _members(tpl, tlen, cls):
    """(p, k) of every member of a class on tpl[:tlen]."""
    if cls[0] == "sub":
        return [(cls[1], cls[2])]
    if cls[0] == "del":
        q = cls[1]
        out = []
        while q < tlen and tpl[q] == tpl[cls[1]]:
            out.append((q, 4))
            q += 1
        return out
    _, x, j = cls
    out = [(j - 1, 5 + x) if j > 0 else (-1, x)]
    while j < tlen and tpl[j] == x:
        j += 1
        out.append((j - 1, 5 + x))
    return out


def _picks(sel, pkind, pre_sel, pre_base):
    """Per row, the selected mutations as (p, k) pairs."""
    out = []
    for i in range(sel.shape[0]):
        s = [(int(p), int(pkind[i, p])) for p in np.flatnonzero(sel[i])]
        if pre_sel[i]:
            s.append((-1, int(pre_base[i])))
        out.append(s)
    return out


def _slot(T, p, k):
    return 9 * p + k if p >= 0 else 9 * T + k


def classify_divergence(holes):
    """classify_zmws on the pinned set's holes under ENGINE_KW."""
    sims = [simulate_zmw(hole=h, insert_len=250, n_passes=8 + h % 3, snr=9.0)
            for h in holes]
    return classify_zmws([_zin(z) for z in sims], ENGINE_KW)


def classify_zmws(zmws, cfg_kw):
    """Drive both loops on the windows of the ZMWs (port ZmwInputs) as the
    engine prepares them under the config ``cfg_kw``; return one record per
    window whose selections differ, taken at its first differing iteration:
    dict(hole, strand, win, it, kind, jax, port)."""
    a, tables, cfg = _window_rows(zmws, cfg_kw)
    n, T = a["tpl"].shape
    thresh, max_iters = cfg.tpu_polish_thresh, cfg.max_polish_iterations
    jscore = _jax_scorer()
    const_j = tuple(jnp.asarray(a[k]) for k in ("snr_bin", "reads", "rlens"))
    const_t = tuple(torch.from_numpy(a[k]) for k in ("snr_bin", "reads",
                                                     "rlens"))
    first_j, first_t = jnp.asarray(a["is_first"]), torch.from_numpy(
        a["is_first"])
    J = {k: jnp.asarray(a[k]) for k in ("tpl", "tlen", "cs", "ce", "pri")}
    P = {k: torch.from_numpy(a[k]) for k in ("tpl", "tlen", "cs", "ce", "pri")}
    J["lls"], J["ll"] = jscore(J["tpl"], J["tlen"], *const_j, J["pri"] > 0)
    P["lls"], P["ll"] = tpf.score_all(P["tpl"], P["tlen"], *const_t, tables,
                                      cand=P["pri"] > 0)
    has_cov = (a["rlens"] >= 0).any(-1)
    s0 = jpf.select_mutations(J["lls"], J["ll"], J["pri"], T, thresh=thresh)
    J["active"] = jnp.asarray(has_cov) & (s0[0].any(-1) | s0[2])
    J["n"] = jnp.zeros(n, jnp.int32)
    s0 = tpf.select_mutations(P["lls"], P["ll"], P["pri"], T, thresh=thresh)
    P["active"] = torch.from_numpy(has_cov) & (s0[0].any(-1) | s0[2])
    P["n"] = torch.zeros(n, dtype=torch.int32)

    records, seen = [], set()
    for it in range(max_iters):
        if not (bool(J["active"].any()) or bool(P["active"].any())):
            break
        js = jpf.select_mutations(J["lls"], J["ll"], J["pri"], T,
                                  thresh=thresh)[:4]
        js = (js[0] & J["active"][:, None], js[1], js[2] & J["active"], js[3])
        ps = tpf.select_mutations(P["lls"], P["ll"], P["pri"], T,
                                  thresh=thresh)[:4]
        ps = (ps[0] & P["active"][:, None], ps[1], ps[2] & P["active"], ps[3])
        # the JAX rule on the JAX scores with every class at its maximum
        eq = tpf.equalize_equivalent(torch.from_numpy(np.array(J["lls"])),
                                     torch.from_numpy(np.array(J["tpl"])))
        es = jpf.select_mutations(jnp.asarray(eq.numpy()), J["ll"], J["pri"],
                                  T, thresh=thresh)[:4]
        es = (es[0] & J["active"][:, None], es[1], es[2] & J["active"], es[3])
        pj, pp, pe = (_picks(*(np.asarray(x) for x in s))
                      for s in (js, ps, es))
        jn = {k: np.asarray(v) for k, v in J.items()}
        pn = {k: v.numpy() for k, v in P.items()}
        for i in range(n):
            if i in seen or pj[i] == pp[i]:
                continue
            seen.add(i)
            # up to here the two loops agreed on this window
            for k in ("tpl", "tlen", "cs", "ce", "pri", "n"):
                assert np.array_equal(jn[k][i], pn[k][i]), (i, it, k)
            tpl_i, tl_i = jn["tpl"][i], int(jn["tlen"][i])
            cj = sorted(_class_of(tpl_i, p, k) for p, k in pj[i])
            cp = sorted(_class_of(tpl_i, p, k) for p, k in pp[i])
            kind = "a1" if cj == cp else "a2"
            for p, k in set(pj[i]) ^ set(pp[i]):
                mem = _members(tpl_i, tl_i, _class_of(tpl_i, p, k))
                sc = [float(jn["lls"][i, _slot(T, q, m)]) for q, m in mem]
                sc = [s for s in sc if s > jpf.NEG / 2]
                if len(sc) < 2 or max(sc) - min(sc) > LLS_TOL:
                    kind = "b"
            if pe[i] != pp[i]:
                kind = "b"
            records.append(dict(hole=int(a["hole"][i]),
                                strand=a["strand"][i], win=int(a["win"][i]),
                                it=it, kind=kind, jax=pj[i], port=pp[i]))
        J = _advance_jax(J, js, first_j, const_j, jscore)
        P = _advance_port(P, ps, first_t, const_t, tables)
    # a window whose selections never differed ends in the same state
    qj = np.asarray(jpf._qv_from_lls(J["lls"], J["ll"], J["tpl"],
                                     J["tlen"])[0])
    qp = tpf._qv_from_lls(P["lls"], P["ll"], P["tpl"], P["tlen"])[0].numpy()
    for i in set(range(n)) - seen:
        for k in ("tpl", "tlen", "cs", "ce", "pri"):
            assert np.array_equal(np.asarray(J[k])[i], P[k].numpy()[i]), (i, k)
        assert np.abs(qj[i] - qp[i]).max() <= 1e-3
    return sorted(records, key=lambda r: (r["hole"], r["it"], r["win"]))


def _advance_jax(J, sel, is_first, const, jscore):
    ntpl, nlen, ncs, nce, npri, imp = jpf.apply_mutations(
        J["tpl"], J["tlen"], J["cs"], J["ce"], J["pri"], *sel, is_first,
        single=J["n"] >= CAREFUL_AFTER)
    m = imp[:, None]
    N = dict(tpl=jnp.where(m, ntpl, J["tpl"]),
             tlen=jnp.where(imp, nlen, J["tlen"]),
             pri=jnp.where(m, npri, J["pri"]), cs=jnp.where(imp, ncs, J["cs"]),
             ce=jnp.where(imp, nce, J["ce"]), active=imp,
             n=J["n"] + J["active"].astype(jnp.int32))
    N["lls"], N["ll"] = jscore(N["tpl"], N["tlen"], *const, N["pri"] > 0)
    return N


def _advance_port(P, sel, is_first, const, tables):
    ntpl, nlen, ncs, nce, npri, imp = tpf.apply_mutations(
        P["tpl"], P["tlen"], P["cs"], P["ce"], P["pri"], *sel, is_first,
        single=P["n"] >= CAREFUL_AFTER)
    m = imp[:, None]
    N = dict(tpl=torch.where(m, ntpl, P["tpl"]),
             tlen=torch.where(imp, nlen, P["tlen"]),
             pri=torch.where(m, npri, P["pri"]),
             cs=torch.where(imp, ncs, P["cs"]),
             ce=torch.where(imp, nce, P["ce"]), active=imp,
             n=P["n"] + P["active"].to(torch.int32))
    rows = torch.nonzero(imp).squeeze(1)     # as the compacting loop does
    N["lls"], N["ll"] = P["lls"].clone(), P["ll"].clone()
    if rows.numel():
        lls, ll = tpf.score_all(N["tpl"][rows], N["tlen"][rows],
                                *(c[rows] for c in const), tables,
                                cand=N["pri"][rows] > 0)
        N["lls"][rows], N["ll"][rows] = lls, ll
    return N


@pytest.mark.parametrize("hole", [7, 2, 11])
def test_first_divergence_is_a_tie_settled_by_rounding(hole):
    """Hole 7: one window, another member of one insertion class (a1).
    Hole 2: one window of kind a1, and one where the JAX rounding makes the
    last member of an insertion class the strict maximum, three positions
    from a better substitution, so JAX applies it in this iteration and
    the port (whose leftmost member is one position from that
    substitution) does not (a2). Hole 11: JAX deletes two bases of one run in one iteration,
    each scored as a single deletion (a2)."""
    recs = classify_divergence([hole])
    assert [r["kind"] for r in recs] == KINDS_BY_HOLE[hole], recs


def test_jax_tie_rule_equals_the_ports():
    """jax_equalize_equivalent gives what polish_fused.equalize_equivalent
    gives, bit for bit: homopolymer-rich templates, invalid slots."""
    rng = np.random.default_rng(0)
    tpl = rng.integers(0, 2, (6, 20)).astype(np.int8)
    lls = rng.normal(0, 3, (6, 9 * 20 + 4)).astype(np.float32)
    lls[rng.random(lls.shape) < 0.2] = jpf.NEG
    want = tpf.equalize_equivalent(torch.from_numpy(lls),
                                   torch.from_numpy(tpl)).numpy()
    got = np.asarray(jax_equalize_equivalent(jnp.asarray(lls),
                                             jnp.asarray(tpl)))
    np.testing.assert_array_equal(got, want)


# The strand-mode divergence of the two CLIs on heteroduplex_with_kinetics
# (tests/test_torch_cli_strand.py): its windows as the engine prepares them
# under --by-strand and under --hd-finder (the same strand windows), and the
# kinds of each window's first differing selection.
STRAND_KINDS = [("fwd", 11, "a1"), ("fwd", 17, "a1"), ("rev", 2, "a1"),
                ("rev", 9, "a2")]


@pytest.mark.parametrize("mode", ["by_strand", "hd_finder"])
def test_strand_divergence_is_a_tie_settled_by_rounding(mode, tmp_path):
    """Forward windows 11 and 17: another member of one insertion class
    (a1), as in the record that differs between the CLIs. Reverse window
    2: the same (a1); reverse window 9: JAX inserts two bases of one class
    in one iteration, each scored as a single insertion (a2). Neither
    reverse window changes that strand's record."""
    path = str(tmp_path / "in.subreads.bam")
    heteroduplex_with_kinetics(path)
    with BamReader(path) as r:
        zmws = list(iter_zmws(r, r.header.movie_name()))
    recs = classify_zmws(zmws, {mode: True, "min_rq": 0.9})
    assert [(r["strand"], r["win"], r["kind"]) for r in recs] == \
        STRAND_KINDS, recs


@pytest.mark.slow
def test_every_divergence_of_the_pinned_set_is_a_tie():
    recs = classify_divergence(range(34))
    assert not [r for r in recs if r["kind"] == "b"], recs
    by_hole = {}
    for r in recs:
        by_hole.setdefault(r["hole"], []).append(r["kind"])
    assert by_hole == KINDS_BY_HOLE
    # every ZMW whose engine output differs has such a window
    assert set(OUTPUT_DIFFS) <= set(by_hole)
