"""The ``--all --hifi-kinetics`` deployment in the benchmark: kinetics in
the traffic, the checks of what that mode writes (the kinetics tags, the
polished reads under rq 0.99) and their controls; and the default cells'
inputs and check numbers, which kinetics must leave as they were."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

from ccsbench import bamio, control, generator, harness, reference
from ccsbench.tests import tiny

SEED = 2 ** 40 + 123
# sha256 of the subreads BAM and its .pbi that write_bam makes of the
# traffic file's pool cut to 4 members, 6 ZMWs from member 1, at SEED:
# recorded before the traffic had a kinetics key
DIGESTS = {
    "15kb_p8": (
        "2502afa20bb2307641d6e050a6b1bc8d96b41758234ee1f023fe1e1ed2281336",
        "6d1475c5f71231d445855f7ffd9547c561944d8ac3f0221b9e99aca7c659e2fb"),
    "2kb_p10": (
        "e7f107f37c846f3f2f50eb677a307442627ae3ef517693a328c6389ad5e7fb2a",
        "cc2bcf7c1cbdf57c59ad22aa9404187af6e6aa5ad4ede38ec02a4a0c94ae6661"),
}
# what judge read from _default_outputs() before the kinetics checks
DEFAULT_NUMBERS = {"breaches": 4.0, "hifi_shortfall": 0.25,
                   "hifi_err_per_kb": 9.444444444444445,
                   "hifi_worst_err_per_kb": 13.333333333333334,
                   "hifi_err_over_claim": 2.6990553306342897,
                   "qv_worst_bin_err_over_claim": 0.3478984896698452}


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_default_inputs_byte_for_byte(name, tmp_path):
    traffic = dict(generator.load(tiny.REPO, name), pool_zmws=4)
    pool = generator.make_pool(traffic, SEED)
    path = str(tmp_path / "in.subreads.bam")
    generator.write_bam(path, generator.pool_parts(pool), 6, first=1)
    got = tuple(hashlib.sha256(open(p, "rb").read()).hexdigest()
                for p in (path, path + ".pbi"))
    assert got == DIGESTS[name]


def test_kinetics_pool_is_the_programs_simulation():
    """Each member's reads and pulse widths are what the program's
    simulator draws with pulse widths from the member's stream; its IPDs
    come from a stream of their own, uniform codes 4-59."""
    from ccs_tpu_torch.sim import simulator
    pool = generator.make_pool(tiny.KIN_TRAFFIC, SEED)
    for i, z in enumerate(pool):
        ref = simulator.simulate_zmw(i, 300, len(z.subreads),
                                     rng=generator._rng(SEED, 1, i), snr=9.0,
                                     with_pw=True)
        assert all(np.array_equal(x, y) for x, y in
                   zip(ref.subreads, z.subreads))
        assert all(np.array_equal(x, y) for x, y in zip(ref.pws, z.pws))
        rng = generator._rng(SEED, 2, i)
        for read, ip in zip(z.subreads, z.ipds):
            assert np.array_equal(ip, rng.integers(4, 60, len(read)))
            assert ip.dtype == np.uint8 and 4 <= ip.min() <= ip.max() < 60


def test_kinetics_round_trip_through_the_program_reader(tmp_path):
    from ccs_tpu_torch.cli import subread_from_record
    from ccs_tpu_torch.io.bam import BamReader
    pool = generator.make_pool(dict(tiny.KIN_TRAFFIC, pool_zmws=4), 9)
    path = str(tmp_path / "in.subreads.bam")
    holes, _ends = generator.write_bam(path, generator.pool_parts(pool), 6)
    recs = iter(BamReader(path))
    for m in holes.values():
        for read, ip, pw in zip(pool[m].subreads, pool[m].ipds,
                                pool[m].pws):
            sub = subread_from_record(next(recs))
            assert np.array_equal(sub.seq, read)
            assert np.array_equal(sub.ipd, ip) and np.array_equal(sub.pw, pw)
    assert next(recs, None) is None
    back = bamio.read_records(path)
    assert np.array_equal(back[0]["tags"]["pw"], pool[holes[
        bamio.HOLE_BASE]].pws[0])


def test_codec_v1_equals_the_programs():
    from ccs_tpu_torch.pipeline import kinetics
    codes = np.arange(256)
    assert np.array_equal(reference.codec_v1_decode(codes),
                          kinetics.codec_v1_decode(codes))
    frames = np.arange(1200)
    assert np.array_equal(reference.codec_v1_encode(frames),
                          kinetics.codec_v1_encode(frames))


def test_aligned_pairs_against_plain_dp():
    """The rescaled band's path: its cost is the edit distance where the
    band holds the pair, and it pairs positions in order."""
    rng = np.random.default_rng(3)
    seqs, truths = [], []
    for _ in range(60):
        t = rng.integers(0, 4, rng.integers(1, 90)).astype(np.int8)
        s = t.copy()
        for _e in range(rng.integers(0, 12)):
            k = int(rng.integers(0, len(s) + 1))
            if rng.random() < 0.7:      # reads drift longer than the truth
                s = np.insert(s, k, rng.integers(0, 4)).astype(np.int8)
            elif k < len(s):
                s = np.delete(s, k)
        seqs.append(s)
        truths.append(t)
    for s, t, (si, ti) in zip(seqs, truths,
                              reference.aligned_pairs(seqs, truths)):
        assert (np.diff(si) > 0).all() and (np.diff(ti) > 0).all()
        cost = len(s) + len(t) - 2 * len(si) + int((s[si] != t[ti]).sum())
        assert cost == _plain_dp(s, t)


def _plain_dp(a, b):
    d = np.arange(len(b) + 1)
    for i in range(1, len(a) + 1):
        prev, d = d, d.copy()
        d[0] = i
        for j in range(1, len(b) + 1):
            d[j] = min(prev[j] + 1, d[j - 1] + 1,
                       prev[j - 1] + (a[i - 1] != b[j - 1]))
    return int(d[-1])


def _default_outputs():
    """Records of a ccs_default run made up from a tiny pool: HiFi records
    with a few edits and mixed QVs on both strands, one under the filters,
    one shortcut, one hole written twice."""
    pool = generator.make_pool(tiny.TRAFFIC, 5)
    rng = np.random.default_rng(11)
    holes = {bamio.HOLE_BASE + i: i % len(pool)
             for i in range(len(pool) + 2)}
    recs = []
    for h, m in holes.items():
        ins = pool[m].insert
        seq = ins.copy() if h % 2 else reference.revcomp_codes(ins)
        for _ in range(int(rng.integers(0, 6))):
            k = int(rng.integers(0, len(seq)))
            op = int(rng.integers(0, 3))
            if op == 0:
                seq[k] = (seq[k] + 1) % 4
            elif op == 1:
                seq = np.insert(seq, k, int(rng.integers(0, 4))).astype(
                    np.int8)
            else:
                seq = np.delete(seq, k)
        qual = rng.choice(np.array([10, 22, 35, 40], np.uint8), len(seq))
        rq = float(rng.choice([0.995, 0.999, 0.9995]))
        recs.append({"name": f"m/{h}/ccs", "seq": seq, "qual": qual,
                     "tags": {"zm": h, "rq": rq, "np": 8}})
    recs[1]["tags"]["rq"] = 0.95
    recs[2]["tags"].update(rq=-1.0, np=1)
    recs[2]["seq"] = pool[holes[recs[2]["tags"]["zm"]]].subreads[0]
    recs[2]["qual"] = np.full(len(recs[2]["seq"]), 10, np.uint8)
    recs.append(dict(recs[3]))
    n = len(holes)
    report = {"ZMWs input": n, "ZMWs pass filters": n - 1,
              "ZMWs fail filters": 1, "ZMWs shortcut filters": 0}
    g = {"min_rq": 0.99, "min_passes": 3, "top_passes": 60,
         "mode_all": False}
    return recs, report, n, holes, pool, g


def test_default_numbers_as_before_the_kinetics_checks():
    """A configuration that states neither kinetics nor --all gets the six
    numbers it always had, with the same values."""
    numbers, _facts = reference.judge(*_default_outputs())
    assert numbers == DEFAULT_NUMBERS


def _kinetics_outputs():
    """Each polished member of a kinetics pool written as its true insert
    (on alternating strands) with the program's own average of its
    passes' kinetics, the one-pass members as their subread (rq -1)."""
    from ccs_tpu_torch.pipeline.kinetics import KineticsEntry, \
        average_kinetics
    pool = generator.make_pool(tiny.KIN_TRAFFIC, 21)
    holes = {bamio.HOLE_BASE + i: i for i in range(len(pool))}
    recs = []
    for h, m in holes.items():
        z = pool[m]
        if len(z.subreads) == 1:
            recs.append({"name": f"m/{h}/ccs", "seq": z.subreads[0],
                         "qual": np.full(len(z.subreads[0]), 10, np.uint8),
                         "tags": {"zm": h, "rq": -1.0, "np": 1}})
            continue
        flip = m % 2
        seq = reference.revcomp_codes(z.insert) if flip else z.insert
        k = average_kinetics(seq, [
            KineticsEntry(read=r, ipd=ip, pw=pw, strand=s ^ flip)
            for r, ip, pw, s in zip(z.subreads, z.ipds, z.pws, z.strands)])
        tags = {"zm": h, "rq": 0.999, "np": len(z.subreads), "fi": k.fi,
                "fp": k.fp, "fn": k.fn, "ri": k.ri, "rp": k.rp, "rn": k.rn}
        recs.append({"name": f"m/{h}/ccs", "seq": seq,
                     "qual": np.full(len(seq), 30, np.uint8), "tags": tags})
    n = len(holes)
    short = sum(len(z.subreads) == 1 for z in pool)
    report = {"ZMWs input": n, "ZMWs pass filters": n - short,
              "ZMWs fail filters": 0, "ZMWs shortcut filters": short}
    return recs, report, n, holes, pool, dict(tiny.KIN_GUARANTEES)


def test_kinetics_checks_on_made_up_records():
    """The program's average on the true insert reads as the reference's;
    each broken structure is a breach; shifted or swapped codes raise the
    mismatch share; a record under rq 0.99 is held by the low-rq number."""
    recs, report, n, holes, pool, g = _kinetics_outputs()
    sound, facts = reference.judge(recs, report, n, holes, pool, g)
    assert sound["breaches"] == 0, facts["breach_examples"]
    assert facts["kinetics_records"] == n - report["ZMWs shortcut filters"]
    assert sound["kinetics_mismatch_share"] < 0.01
    assert sound["lowq_err_over_claim"] == 0.0

    polished = [r for r in recs if r["tags"]["rq"] > 0]
    a, b, c = polished[:3]
    a["tags"]["fp"] = a["tags"]["fp"][:-1]                  # wrong length
    del b["tags"]["rn"]                                     # a tag missing
    c["tags"]["fn"] = 99                                    # too many
    next(r for r in recs if r["tags"]["rq"] < 0)["tags"].update(
        fi=np.zeros(0, np.uint8))                           # on a shortcut
    broken, facts = reference.judge(recs, report, n, holes, pool, g)
    assert broken["breaches"] == 4, facts["breach_examples"]

    recs, *_ = _kinetics_outputs()
    for r in recs:
        t = r["tags"]
        if "fi" in t:
            t["fi"], t["ri"] = t["ri"], t["fi"]
    swapped, _f = reference.judge(recs, report, n, holes, pool, g)
    assert swapped["breaches"] == 0
    assert swapped["kinetics_mismatch_share"] > 0.3

    recs, *_ = _kinetics_outputs()
    for r in recs:
        for t in ("fi", "fp", "ri", "rp"):
            if t in r["tags"]:
                r["tags"][t] = r["tags"][t] + 2
    shifted, _f = reference.judge(recs, report, n, holes, pool, g)
    assert shifted["kinetics_mismatch_share"] > 0.95

    recs, *_ = _kinetics_outputs()
    low = next(r for r in recs if "fi" in r["tags"])
    for t in reference.KINETICS_TAGS:
        del low["tags"][t]
    low["tags"]["rq"] = 0.98
    low["seq"] = low["seq"][:-3]
    lowq, facts = reference.judge(recs, report, n, holes, pool, g)
    assert lowq["breaches"] == 0, facts["breach_examples"]
    assert facts["lowq_records"] == 1
    assert lowq["lowq_err_over_claim"] == pytest.approx(
        3 / (0.02 * len(low["seq"])))


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("ccsbench")))


@pytest.fixture(scope="module")
def kin_sound(bench, tmp_path_factory):
    return harness.run_cell(bench, "tiny_kin", 2 ** 33 + 7, 2.0, False,
                            str(tmp_path_factory.mktemp("kin")),
                            devices=["cpu"], log=lambda m: None)


def test_kinetics_sound_run(kin_sound):
    """Every number of a sound --all --hifi-kinetics run is within its
    limit but ``breaches``, and its breaches are exactly the records under
    rq 0.99 that the program writes with averaged kinetics, which
    --hifi-kinetics gives to HiFi reads alone (a fault of the program)."""
    numbers, facts = kin_sound["numbers"], kin_sound["facts"]
    assert facts["kinetics_records"] > 0 and facts["lowq_records"] > 0
    assert all(numbers[k] <= kin_sound["limits"][k] for k in numbers
               if k != "breaches"), numbers
    assert numbers["breaches"] == facts["kinetics_breaches"] == \
        facts["sub_hifi_records_with_kinetics"]
    assert kin_sound["correct"] == (numbers["breaches"] == 0)
    assert kin_sound["failed"] == 0


@pytest.mark.parametrize("plant,fails", [
    ("kinetics_one_pass", "kinetics_mismatch_share"),
    ("kinetics_strands_swapped", "kinetics_mismatch_share"),
    ("unchanged", "lowq_err_over_claim"),
])
def test_kinetics_controls_fail_their_number(plant, fails, bench,
                                             tmp_path_factory):
    res = control.run_planted(bench, "tiny_kin", 2 ** 33 + 7, 2.0, plant,
                              str(tmp_path_factory.mktemp(plant)),
                              devices=["cpu"])
    assert not res["correct"]
    assert res["numbers"][fails] > res["limits"][fails], res["numbers"]
