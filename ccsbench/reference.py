"""The plain reference that decides ``correct``: the simulated truth.

The benchmark simulates every ZMW it feeds the program, so it knows each
molecule's true insert and its number of full passes. This module holds
what the program wrote (the HiFi BAM and ``ccs_report.txt``) against that
truth and against the guarantees the configuration states. It is NumPy and
plain Python, and imports nothing of the program.

Numbers compared (each with its limit, ``ccsbench/limits/``):

- ``breaches``: guarantees broken, counted exactly (limit 0). Every input
  ZMW counted once in the report; pass + fail + shortcut = input; BAM
  records = pass + shortcut; each record's hole is an input hole, written
  once; outside ``--all``, every record has ``rq >= --min-rq`` and ``np >=
  --min-passes``; a record's ``np`` (the passes it used) is at most its
  ZMW's full passes and ``--top-passes``; a low-pass shortcut record (``rq``
  -1, one pass) is one of its ZMW's subreads.
- ``hifi_shortfall``: the share of input ZMWs that gave no HiFi record
  (``rq >= 0.99``): ZMWs the program failed, dropped or under-rated.
- ``hifi_err_per_kb``: edit distance of every HiFi record to its true
  insert, summed, per 1000 true bases.
- ``hifi_worst_err_per_kb``: the same for the worst HiFi record.
- ``hifi_err_over_claim``: the errors found over the errors the records'
  ``rq`` claims, ``sum(edits) / sum((1 - rq) * length)``.
- ``qv_worst_bin_err_over_claim``: the per-base QVs against the truth.
  Each edit of a HiFi record's alignment to its insert is charged to one
  base of the record: a substitution to its base; an insertion or a
  deletion, which can sit anywhere along the homopolymer runs it touches,
  to the lowest-QV base of those runs and the base beyond each end. The
  written QV values are grouped from the highest down, each group closed
  once its bases claim ``QV_MIN_CLAIM`` errors, ``sum(10 ** (-QV / 10))``
  (a short remainder joins the group above it); per group, the errors
  charged to its bases over the errors they claim; the worst group's
  ratio.

Where the configuration's ``guarantees`` state them, two more:

- with ``"kinetics": "hifi"`` (``--hifi-kinetics``: averaged kinetics on
  every HiFi read and on no other, kinetics.md:8-18), ``breaches`` also
  counts each HiFi record that lacks one of ``fi fp fn ri rp rn``, each
  record under rq 0.99 that carries one, ``fi``/``fp`` (``ri``/``rp``) of
  neither the record's length nor empty with ``fn`` (``rn``) 0, and an
  ``fn`` (``rn``) above the ZMW's full passes on that strand; and
  ``kinetics_mismatch_share`` is, over each distinct record with kinetics
  and both strands, the share of positions at which a written
  ``fi fp ri rp`` code lies more than one codec-V1 step from the
  reference's own average. The reference aligns each pass of the strand to
  the record (``ri``/``rp``: to its reverse complement, in whose
  orientation they are written), decodes the frames of the bases the path
  pairs, averages, rounds and re-encodes them; positions no pass covers
  are left out;
- with ``"mode_all": true`` (``--all``), ``lowq_err_over_claim``: over
  each distinct polished record under rq 0.99 (``0 <= rq < 0.99``), the
  edits to its true insert over the errors its ``rq`` claims.
"""

from __future__ import annotations

import numpy as np

HIFI_RQ = 0.99
QV_MIN_CLAIM = 10.0
# half-width of the alignment band, in diagonals; the band is widened for a
# pair whose lengths differ by more than BAND - 16
BAND = 96
# direction bytes held at once by the banded alignment
BLOCK_CELLS = 60_000_000
_INF = 1 << 28
SUB, INS, DEL = 0, 1, 2
KINETICS_TAGS = ("fi", "fp", "fn", "ri", "rp", "rn")


def edit_distance(a: np.ndarray, b: np.ndarray) -> int:
    """Global edit distance (unit costs) of two int8 base sequences, by
    Myers' bit-vector recurrence over Python integers (Hyyro's form):
    one column of the DP per base of ``b``, ``len(a)`` bits wide."""
    m = len(a)
    if m == 0:
        return len(b)
    mask = (1 << m) - 1
    high = 1 << (m - 1)
    peq = [0, 0, 0, 0]
    bits = np.packbits(np.stack([np.asarray(a) == c for c in range(4)]),
                       axis=1, bitorder="little")
    for c in range(4):
        peq[c] = int.from_bytes(bits[c].tobytes(), "little")
    pv, mv, score = mask, 0, m
    for c in np.asarray(b).tolist():
        eq = peq[c] if 0 <= c < 4 else 0
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = mv | (~(xh | pv) & mask)
        mh = pv & xh
        if ph & high:
            score += 1
        elif mh & high:
            score -= 1
        ph = ((ph << 1) | 1) & mask
        mh = (mh << 1) & mask
        pv = mh | (~(xv | ph) & mask)
        mv = ph & xv
    return score


def _band_block(seqs: list, truths: list, band: int,
                rescaled: bool = False) -> list:
    """Banded global alignment of each seqs[r] (rows) to truths[r]
    (columns), all pairs of the block in lockstep, row by row: cell (i, j)
    at offset k = j - c(i) + band about the band's centre c(i), which is i
    (the main diagonal) or, ``rescaled``, round(i * n / m) (the diagonal
    scaled to the pair's lengths m and n, for reads whose length drifts
    from the truth's). Returns per pair (edits, events, matched), from the
    traceback of the band's best path: an event is (kind, i), a
    substitution (SUB) or insertion (INS) at base i of seq, or a deletion
    (DEL) in the gap before base i; ``matched`` holds the (seq, truth)
    positions the path pairs, as two arrays."""
    R, K = len(seqs), 2 * band + 1
    ms = [len(s) for s in seqs]
    ns = [len(t) for t in truths]
    M, N = max(ms), max(ns)
    A = np.full((R, M), -1, np.int8)
    Bp = np.full((R, M + N + K + 1), -2, np.int8)
    rows = np.arange(M + 1)
    centre = np.empty((R, M + 1), np.int64)
    for r in range(R):
        A[r, :ms[r]] = seqs[r]
        Bp[r, band + 1:band + 1 + ns[r]] = truths[r]
        c = rows.copy()
        if rescaled and ms[r]:
            c[:ms[r] + 1] = np.rint(rows[:ms[r] + 1] * (ns[r] / ms[r]))
            c[ms[r] + 1:] = ns[r] + rows[1:M + 1 - ms[r]]
        centre[r] = c
    shift = np.diff(centre, axis=1)             # c(i) - c(i - 1), >= 0
    ar = np.arange(K, dtype=np.int32)
    prev = np.where(ar >= band, ar - band, _INF).astype(np.int32)
    prev = np.broadcast_to(prev, (R, K)).copy()
    # the previous row with _INF on both sides: cell (i, j)'s diagonal
    # parent sits at k + shift of it, its parent above at k + shift + 1
    padded = np.full((R, K + 2 + int(shift.max(initial=1))), _INF, np.int32)
    dirs = np.empty((M + 1, R, K), np.uint8)
    dirs[0] = 2
    end = [ns[r] - int(centre[r, ms[r]]) + band for r in range(R)]
    finish: dict = {}
    for r in range(R):
        finish.setdefault(ms[r], []).append(r)
    final = [0] * R
    for r in finish.get(0, ()):
        final[r] = int(prev[r, end[r]])
    up = np.empty((R, K), np.int32)
    for i in range(1, M + 1):
        if rescaled:
            padded[:, 1:K + 1] = prev
            at = ar + shift[:, i - 1, None]
            diag = np.take_along_axis(padded, at, axis=1)
            up = np.take_along_axis(padded, at + 1, axis=1)
            up += 1
            truth = np.take_along_axis(Bp, centre[:, i, None] + ar, axis=1)
        else:                   # shift 1 and centre i: plain slices
            diag = prev.copy()
            up[:, :-1] = prev[:, 1:] + 1
            up[:, -1] = _INF
            truth = Bp[:, i:i + K]
        diag += A[:, i - 1, None] != truth
        cur = np.minimum(diag, up)
        cur -= ar
        np.minimum.accumulate(cur, axis=1, out=cur)
        cur += ar
        not_diag = cur != diag
        dirs[i] = not_diag
        dirs[i] += not_diag & (cur != up)
        prev = cur
        for r in finish.get(i, ()):
            final[r] = int(cur[r, end[r]])
    out = []
    for r in range(R):
        d = np.ascontiguousarray(dirs[:ms[r] + 1, r, :]).tobytes()
        a, b = A[r, :ms[r]].tobytes(), truths[r].tobytes()
        c, sh = centre[r].tolist(), shift[r].tolist()
        i, k, ev, mi, mj = ms[r], end[r], [], [], []
        while i > 0 or k != band:
            t = d[i * K + k]
            if t == 0:
                j = c[i] - band + k - 1
                if a[i - 1] != b[j]:
                    ev.append((SUB, i - 1))
                mi.append(i - 1)
                mj.append(j)
                i -= 1
                k += sh[i] - 1
            elif t == 1:
                ev.append((INS, i - 1))
                i -= 1
                k += sh[i]
            else:
                ev.append((DEL, i))
                k -= 1
        if len(ev) != final[r]:
            raise AssertionError("banded traceback disagrees with its DP")
        out.append((final[r], ev, (np.array(mi[::-1], np.int64),
                                   np.array(mj[::-1], np.int64))))
    return out


def charged_bases(seq: np.ndarray, qual: np.ndarray, events: list) -> list:
    """The base of ``seq`` that each edit is charged to: a substitution's
    own; for an indel, the lowest-QV base of the homopolymer runs on either
    side of it and the base beyond each run (the indel may sit anywhere
    along them)."""
    m = len(seq)
    s = seq.tolist()
    q = qual.tolist()
    out = []
    for kind, i in events:
        if kind == SUB:
            out.append(i)
            continue
        lo, hi = (i, i) if kind == INS else (max(i - 1, 0), min(i, m - 1))
        while lo > 0 and s[lo - 1] == s[lo]:
            lo -= 1
        while hi < m - 1 and s[hi + 1] == s[hi]:
            hi += 1
        lo, hi = max(lo - 1, 0), min(hi + 1, m - 1)
        span = q[lo:hi + 1]
        out.append(lo + span.index(min(span)))
    return out


def _in_blocks(seqs: list, truths: list, rescaled: bool):
    """The pairs in blocks of about BLOCK_CELLS cells, shortest seq first:
    yields (indices of the block's pairs, band, ``_band_block``'s result).
    On the main diagonal the band is widened to each pair's length
    difference + 16; a rescaled band ends where it starts and stays at
    BAND."""
    order = sorted(range(len(seqs)), key=lambda r: len(seqs[r]))

    def need(r):
        return BAND if rescaled else max(
            BAND, abs(len(truths[r]) - len(seqs[r])) + 16)
    at = 0
    while at < len(order):
        blk = [order[at]]
        band = need(order[at])
        while at + len(blk) < len(order):
            r = order[at + len(blk)]
            b2 = max(band, need(r))
            if (len(blk) + 1) * (len(seqs[r]) + 1) * (2 * b2 + 1) \
                    > BLOCK_CELLS:
                break
            blk.append(r)
            band = b2
        yield blk, band, _band_block([seqs[r] for r in blk],
                                     [truths[r] for r in blk], band,
                                     rescaled)
        at += len(blk)


def aligned_errors(seqs: list, truths: list) -> list:
    """Per pair (seq, truth): (edit distance, the edits as events of
    ``_band_block``). The band's path is an optimal alignment wherever its
    cost is under 2 * band + 2 - |len(truth) - len(seq)|, since any path
    that leaves the band costs at least that; elsewhere the distance is
    Myers' exact one and the events are those of the band's (costlier)
    path."""
    out: list = [None] * len(seqs)
    for blk, band, got in _in_blocks(seqs, truths, False):
        for r, (e, ev, _m) in zip(blk, got):
            slack = 2 * band + 2 - abs(len(truths[r]) - len(seqs[r]))
            if e >= slack:
                e = edit_distance(seqs[r], truths[r])
            out[r] = (e, ev)
    return out


def aligned_pairs(seqs: list, truths: list) -> list:
    """Per pair (read, target): the (read, target) positions that the
    band's best path about the rescaled diagonal pairs, matches and
    substitutions both: an alignment of a subread to a consensus, whose
    lengths differ by some per cent."""
    out: list = [None] * len(seqs)
    for blk, _band, got in _in_blocks(seqs, truths, True):
        for r, (_e, _ev, matched) in zip(blk, got):
            out[r] = matched
    return out


def _kmers(seq: np.ndarray, k: int = 12) -> set:
    s = np.asarray(seq, np.int64)
    if len(s) < k:
        return set()
    w = np.lib.stride_tricks.sliding_window_view(s, k)
    return set((w * (4 ** np.arange(k))).sum(axis=1).tolist())


def truth_strand(seq: np.ndarray, insert: np.ndarray,
                 insert_rc: np.ndarray) -> np.ndarray:
    """The strand of the insert whose 12-mers the consensus's first 500
    bases share most."""
    head = _kmers(seq[:500])
    fwd = len(head & _kmers(insert[:600]))
    rev = len(head & _kmers(insert_rc[:600]))
    return insert if fwd >= rev else insert_rc


def codec_v1_decode(codes: np.ndarray) -> np.ndarray:
    """Frames of PacBio's lossy 8-bit kinetics codes (codec V1, the BAM
    spec's ``ip``/``pw``/``fi``... tags): 0-63 as they are, then steps of
    2, 4 and 8 frames."""
    c = np.asarray(codes, np.int64)
    return np.select([c < 64, c < 128, c < 192],
                     [c, 64 + 2 * (c - 64), 192 + 4 * (c - 128)],
                     448 + 8 * (c - 192))


def codec_v1_encode(frames: np.ndarray) -> np.ndarray:
    f = np.asarray(frames, np.int64)
    return np.select([f < 64, f < 192, f < 448],
                     [f, 64 + (f - 64) // 2, 128 + (f - 192) // 4],
                     np.minimum(192 + (f - 448) // 8, 255))


def _kinetics_breaches(rec: dict, rq: float, fwd_passes: int,
                       rev_passes: int) -> list:
    """The structure of a record's averaged kinetics under ``"kinetics":
    "hifi"``; ``fwd_passes``/``rev_passes``: the ZMW's full passes on the
    record's strand and on the other."""
    tags, hole = rec["tags"], rec["tags"].get("zm")
    has = [t for t in KINETICS_TAGS if t in tags]
    if rq < HIFI_RQ:
        return [f"hole {hole}: rq {rq} carries {has}"] if has else []
    if len(has) < len(KINETICS_TAGS):
        return [f"hole {hole}: HiFi record with kinetics tags {has}"]
    out = []
    for ip, pw, n, full in (("fi", "fp", "fn", fwd_passes),
                            ("ri", "rp", "rn", rev_passes)):
        lens = {len(tags[ip]), len(tags[pw])}
        if lens != {len(rec["seq"])} and not (lens == {0} and tags[n] == 0):
            out.append(f"hole {hole}: {ip}/{pw} of lengths {sorted(lens)} "
                       f"for {len(rec['seq'])} bases, {n} {tags[n]}")
        if tags[n] > full:
            out.append(f"hole {hole}: {n} {tags[n]} > {full} passes")
    return out


def kinetics_mismatch(kin_records: list, members: list) -> tuple[int, int]:
    """(positions mismatched, positions compared) over ``kin_records``,
    each (member, record, the member's strand that reads as the record):
    each written ``fi fp ri rp`` against the reference's own average of
    the passes on that strand (see the module's docstring)."""
    reads, targets, jobs = [], [], []
    for n, (m, rec, fwd) in enumerate(kin_records):
        z = members[m]
        rc = revcomp_codes(rec["seq"])
        for p, strand in enumerate(z.strands):
            own = strand == fwd
            reads.append(z.subreads[p])
            targets.append(rec["seq"] if own else rc)
            jobs.append((n, own, p))
    sums: dict = {}
    for (n, own, p), (ri, tj) in zip(jobs, aligned_pairs(reads, targets)):
        z = members[kin_records[n][0]]
        acc = sums.setdefault((n, own),
                              np.zeros((3, len(kin_records[n][1]["seq"]))))
        acc[0, tj] += codec_v1_decode(z.ipds[p])[ri]
        acc[1, tj] += codec_v1_decode(z.pws[p])[ri]
        acc[2, tj] += 1
    bad = compared = 0
    for (n, own), (ip_sum, pw_sum, cov) in sums.items():
        tags, length = kin_records[n][1]["tags"], len(kin_records[n][1]["seq"])
        at = cov > 0
        for tag, total in zip(("fi", "fp") if own else ("ri", "rp"),
                              (ip_sum, pw_sum)):
            want = codec_v1_encode(np.round(total[at] / cov[at]))
            compared += len(want)
            got = np.asarray(tags[tag], np.int64)
            bad += int((np.abs(got[at] - want) > 1).sum()) \
                if len(got) == length else len(want)
    return bad, compared


def judge(records: list[dict], report: dict, n_input: int,
          hole_member: dict, members: list,
          guarantees: dict) -> tuple[dict, dict]:
    """(numbers, facts): the numbers compared and what they were read
    from. ``members[i]`` is the i-th simulated ZMW of the pool (``insert``,
    ``subreads``); ``hole_member`` maps each input hole to its member.
    Each distinct record (member, sequence, QVs) is aligned once."""
    breaches = []
    n_pass = report.get("ZMWs pass filters", -1)
    n_fail = report.get("ZMWs fail filters", -1)
    n_short = report.get("ZMWs shortcut filters", -1)
    if report.get("ZMWs input") != n_input:
        breaches.append(f"report input {report.get('ZMWs input')} != "
                        f"{n_input}")
    if n_pass + n_fail + n_short != n_input:
        breaches.append(f"pass {n_pass} + fail {n_fail} + shortcut "
                        f"{n_short} != input {n_input}")
    if len(records) != n_pass + n_short:
        breaches.append(f"{len(records)} BAM records != pass {n_pass} + "
                        f"shortcut {n_short}")
    mode_all = bool(guarantees.get("mode_all"))
    kinetics = guarantees.get("kinetics")
    if kinetics not in (None, "hifi"):
        raise ValueError(f"unknown kinetics guarantee {kinetics!r}")
    kin_records: dict = {}      # distinct records with averaged kinetics
    kin_breaches = sub_hifi_kin = 0
    lowq: dict = {}             # distinct polished records under rq 0.99
    min_rq = float(guarantees["min_rq"])
    min_passes = int(guarantees["min_passes"])
    top = int(guarantees["top_passes"]) or 10 ** 9
    seen = set()
    hifi = []           # (key, rq, record) of every HiFi record
    distinct: dict = {}
    for rec in records:
        tags = rec["tags"]
        hole = int(tags.get("zm", -1))
        if hole not in hole_member:
            breaches.append(f"record {rec['name']}: hole {hole} not input")
            continue
        if hole in seen:
            breaches.append(f"hole {hole} written twice")
            continue
        seen.add(hole)
        z = members[hole_member[hole]]
        rq = float(tags.get("rq", -1.0))
        npass = int(tags.get("np", -1))
        n_sim = len(z.subreads)
        if kinetics is not None:
            ins = z.insert
            fwd = 0 if truth_strand(rec["seq"], ins, revcomp_codes(ins)) \
                is ins else 1
            n_fwd = sum(s == fwd for s in z.strands)
            found = _kinetics_breaches(rec, rq, n_fwd, n_sim - n_fwd)
            breaches += found
            kin_breaches += len(found)
            sub_hifi_kin += rq < HIFI_RQ and bool(found)
            if all(t in tags for t in KINETICS_TAGS):
                kin_records.setdefault(
                    (hole_member[hole], rec["seq"].tobytes(),
                     *(tags[t].tobytes() for t in ("fi", "fp", "ri", "rp"))),
                    (hole_member[hole], rec, fwd))
        if not mode_all and (rq < min_rq or npass < min_passes):
            breaches.append(f"hole {hole}: rq {rq} np {npass} below the "
                            f"filters")
        if rq < 0:
            if npass < 2 and not any(
                    len(s) == len(rec["seq"]) and np.array_equal(
                        s, rec["seq"]) for s in z.subreads):
                breaches.append(f"hole {hole}: shortcut record is none of "
                                f"its subreads")
            if npass > n_sim:
                breaches.append(f"hole {hole}: np {npass} > {n_sim}")
            continue
        if npass > min(n_sim, top):
            breaches.append(f"hole {hole}: np {npass} > {min(n_sim, top)}")
        key = (hole_member[hole], rec["seq"].tobytes(), rec["qual"].tobytes())
        if rq < HIFI_RQ:
            if mode_all:
                lowq.setdefault(key, (rq, rec))
            continue
        distinct.setdefault(key, rec)
        hifi.append((key, rq, rec))

    keys = list(distinct)
    truths = []
    for m, _s, _q in keys:
        ins = members[m].insert
        truths.append(truth_strand(distinct[(m, _s, _q)]["seq"], ins,
                                   revcomp_codes(ins)))
    aligned = dict(zip(keys, aligned_errors(
        [distinct[k]["seq"] for k in keys], truths)))
    qv_values = np.arange(256)
    p_claim = np.power(10.0, -qv_values / 10.0)
    found_qv = np.zeros(256)
    claim_qv = np.zeros(256)
    per_key = {}
    for k in keys:
        qual = distinct[k]["qual"].astype(np.int64)
        pos = charged_bases(distinct[k]["seq"], qual, aligned[k][1])
        per_key[k] = (np.bincount(qual[pos], minlength=256),
                      np.bincount(qual, minlength=256) * p_claim)
    edits = true_bases = claimed = 0.0
    worst = 0.0
    for key, rq, rec in hifi:
        e = aligned[key][0]
        n_true = len(members[key[0]].insert)
        edits += e
        true_bases += n_true
        claimed += (1.0 - rq) * len(rec["seq"])
        worst = max(worst, 1000.0 * e / max(n_true, 1))
        found_qv += per_key[key][0]
        claim_qv += per_key[key][1]
    groups, f, c = [], 0.0, 0.0
    for q in np.nonzero(claim_qv)[0][::-1]:
        f, c = f + found_qv[q], c + claim_qv[q]
        if c >= QV_MIN_CLAIM:
            groups.append([f, c])
            f, c = 0.0, 0.0
    if c > 0:
        if groups:
            groups[-1][0] += f
            groups[-1][1] += c
        else:
            groups.append([f, c])
    ratios = [g_f / g_c for g_f, g_c in groups]
    numbers = {
        "breaches": float(len(breaches)),
        "hifi_shortfall": 1.0 - len(hifi) / max(n_input, 1),
        "hifi_err_per_kb": 1000.0 * edits / max(true_bases, 1.0),
        "hifi_worst_err_per_kb": worst,
        "hifi_err_over_claim": edits / max(claimed, 1e-9),
        "qv_worst_bin_err_over_claim": float(max(ratios, default=0.0)),
    }
    if kinetics is not None:
        bad, compared = kinetics_mismatch(list(kin_records.values()), members)
        numbers["kinetics_mismatch_share"] = bad / max(compared, 1)
    if mode_all:
        lq = list(lowq)
        got = aligned_errors(
            [lowq[k][1]["seq"] for k in lq],
            [truth_strand(lowq[k][1]["seq"], members[k[0]].insert,
                          revcomp_codes(members[k[0]].insert)) for k in lq])
        numbers["lowq_err_over_claim"] = sum(e for e, _ev in got) / max(
            sum((1.0 - lowq[k][0]) * len(lowq[k][1]["seq"]) for k in lq),
            1e-9)
    facts = {"records": len(records), "hifi_records": len(hifi),
             "distinct_sequences": len(keys), "edits": int(edits),
             "claimed_errors": claimed,
             "qv_bins": {int(q): [int(found_qv[q]), round(claim_qv[q], 3)]
                         for q in np.nonzero(claim_qv)[0]},
             "kinetics_records": len(kin_records),
             "kinetics_breaches": kin_breaches,
             "sub_hifi_records_with_kinetics": sub_hifi_kin,
             "lowq_records": len(lowq),
             "breach_examples": breaches[:5]}
    return numbers, facts


_COMP = np.array([3, 2, 1, 0], np.int8)


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return _COMP[np.asarray(codes, np.int64)][::-1].copy()
