"""Per-ZMW pipeline (L3): filter → draft → align → window → polish → finalize.

Stage structure mirrors the documented processZmw flow (SURVEY.md §3.2;
reference docs, how-does-ccs-work.md:17-113). Failures are data: each
ZMW terminates in exactly one ZmwStatus; a failed ZMW never aborts a batch.

Split into three phases so the device work batches across many ZMWs:
  1. ``prepare_zmw``  (host): filters, draft, window batch construction
  2. ``polish_windows_fused`` (device, ccs_tpu_torch.pipeline.polish_fused):
     batched over the concatenated windows of many ZMWs
  3. ``finalize_zmw`` (host): stitch cores, rq gate, tags/metrics
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ccs_tpu_torch.config import CcsConfig
from ccs_tpu_torch.ops import dna
from ccs_tpu_torch.ops.align import anchor_chain, interp_read_pos
from ccs_tpu_torch.ops.sdust import has_long_tandem_repeat
from ccs_tpu_torch.pipeline.draft import generate_draft
from ccs_tpu_torch.pipeline.heteroduplex import (detect_heteroduplex,
                                                 detect_heteroduplex_pileup)
from ccs_tpu_torch.pipeline.adapters import (AdapterInfo, adapter_counts,
                                             classify_adapter_artifacts,
                                             FF_ADAPTER_CONCAT,
                                             FF_ADAPTER_PALINDROME,
                                             FF_ADAPTER_RESIDUE,
                                             FF_BELOW_Q20,
                                             FF_MEDIAN_SUBREAD, FF_SINGLE_STRAND)
from ccs_tpu_torch.pipeline.kinetics import KineticsEntry, KineticsResult
from ccs_tpu_torch.pipeline.windows import WindowBatch, build_window_batch
from ccs_tpu_torch.statuses import ZmwStatus

CX_ADAPTER_BEFORE = 1
CX_ADAPTER_AFTER = 2


@dataclasses.dataclass
class Subread:
    seq: np.ndarray          # int8 codes
    cx: int = 3              # local context flags
    qs: int = 0
    qe: int = 0
    ipd: Optional[np.ndarray] = None   # kinetics (uint8 codec V1 frames)
    pw: Optional[np.ndarray] = None

    @property
    def full_length(self) -> bool:
        return (self.cx & (CX_ADAPTER_BEFORE | CX_ADAPTER_AFTER)) == \
            (CX_ADAPTER_BEFORE | CX_ADAPTER_AFTER)


@dataclasses.dataclass
class ZmwInput:
    hole: int
    movie: str
    subreads: list[Subread]
    snr: np.ndarray          # per-channel SNR (A, C, G, T)


@dataclasses.dataclass
class ConsensusResult:
    hole: int
    movie: str
    status: ZmwStatus
    seq: Optional[np.ndarray] = None      # int8 codes
    qv: Optional[np.ndarray] = None       # float per-base QV (pre-binning)
    rq: float = -1.0
    num_passes: int = 0                   # np tag
    effective_coverage: float = 0.0       # ec tag
    insert_size: int = 0
    polymerase_length: int = 0
    has_tandem_repeat: bool = False
    snr: Optional[np.ndarray] = None
    strand: str = ""                      # "" double-strand, "fwd"/"rev" by-strand
    wall_start: int = 0
    wall_end: int = 0
    n_windows: int = 0
    converged: bool = True
    kinetics: Optional[KineticsResult] = None       # fi/fp/fn/ri/rp/rn (C14)
    sub_kinetics: Optional[tuple] = None            # (ip, pw) for subread reps
    adapter_info: Optional[AdapterInfo] = None      # ma/ac tags (C15)
    ff: int = 0                                     # fail-flag bitmask (fail-reads.md:12-21)
    is_control: bool = False                        # spike-in control ZMW
    fail_rep: Optional[np.ndarray] = None           # fail_reads.bam representative
                                                    # when no consensus exists


@dataclasses.dataclass
class ZmwWorkItem:
    """Host state carried between prepare and finalize around the device step."""
    zmw: ZmwInput
    result: ConsensusResult               # pre-filled metadata / terminal status
    batch: Optional[WindowBatch] = None   # None => terminal before polish
    snr_bin: int = 0
    kin_entries: Optional[list] = None    # KineticsEntry list (C14), if requested

    @property
    def terminal(self) -> bool:
        return self.batch is None



def _median_val(vals) -> float:
    """np.median semantics (mean of middle two for even n) without the
    ~85 us/call numpy list-conversion overhead — prepare calls this ~9x
    per ZMW on lists of ~10 lengths."""
    sv = sorted(vals)
    n = len(sv)
    if n == 0:
        return 0.0
    mid = n // 2
    if n % 2:
        return float(sv[mid])
    return (sv[mid - 1] + sv[mid]) / 2.0


def split_by_strand(zmw: ZmwInput) -> tuple[ZmwInput, ZmwInput]:
    """--by-strand (mode-by-strand.md:16-23): orient subreads against the
    median-length read, bucket into fwd/rev, each strand runs the full
    pipeline independently."""
    from ccs_tpu_torch.pipeline.draft import infer_orientation

    subs = zmw.subreads
    if not subs:
        return (ZmwInput(zmw.hole, zmw.movie, [], zmw.snr),
                ZmwInput(zmw.hole, zmw.movie, [], zmw.snr))
    lengths = np.asarray([len(s.seq) for s in subs])
    ref = subs[int(np.argsort(lengths, kind="stable")[len(subs) // 2])].seq
    fwd, rev = [], []
    for s in subs:
        strand, _ = infer_orientation(s.seq, ref)
        (fwd if strand == 0 else rev).append(s)
    return (ZmwInput(zmw.hole, zmw.movie, fwd, zmw.snr),
            ZmwInput(zmw.hole, zmw.movie, rev, zmw.snr))


def median_length_filter(subreads: list[Subread]) -> list[int]:
    """Keep subreads within 50%..200% of the median subread length
    (how-does-ccs-work.md:24,27-32)."""
    lengths = [len(s.seq) for s in subreads]
    med = _median_val(lengths)
    return [i for i, ln in enumerate(lengths)
            if 0.5 * med <= ln <= 2.0 * med]


def cap_top_passes(subreads: list[Subread], top: int) -> list[int]:
    """Cap used passes at --top-passes, preferring lengths closest to the
    median (accuracy-vs-passes.md:49-52)."""
    if top <= 0 or len(subreads) <= top:
        return list(range(len(subreads)))
    lengths = np.asarray([len(s.seq) for s in subreads], dtype=np.float64)
    med = _median_val([len(s.seq) for s in subreads])
    order = np.argsort(np.abs(lengths - med), kind="stable")[:top]
    return sorted(int(i) for i in order)


def _median_fl_subread(subs: list[Subread]) -> Optional[Subread]:
    """Median-length full-length subread (the fail_reads.bam representative
    for ZMWs without a consensus; fail-reads.md 0x8)."""
    fl = [s for s in subs if s.full_length]
    if not fl:
        return None
    lengths = np.asarray([len(s.seq) for s in fl])
    return fl[int(np.argsort(lengths, kind="stable")[len(fl) // 2])]


def is_control_read(seq: np.ndarray, control: np.ndarray,
                    k: int = 13, min_anchors: int = 5) -> bool:
    """Spike-in control classification: a read maps to the control reference
    if enough unique k-mers chain monotonically (either orientation)."""
    if len(seq) < k or len(control) < k:
        return False
    for probe in (seq, dna.revcomp(seq)):
        if len(anchor_chain(probe, control, k)) >= min_anchors:
            return True
    return False


def prepare_zmw(zmw: ZmwInput, cfg: CcsConfig,
                params_snr_edges: np.ndarray,
                control: Optional[np.ndarray] = None,
                params=None) -> ZmwWorkItem:
    """Host phase 1: filters + draft + window batch. Never raises on bad
    data — errors become EXCEPTION_THROWN by the caller. ``control`` is the
    spike-in control reference sequence, if the run has one
    (fail-reads.md 0x2; classification happens before filtering so control
    ZMWs are reported as CONTROL_* whatever else happens to them)."""
    res = ConsensusResult(hole=zmw.hole, movie=zmw.movie,
                          status=ZmwStatus.SUCCESS, snr=zmw.snr)
    subs = zmw.subreads
    if subs:
        res.polymerase_length = max(s.qe for s in subs) - min(s.qs for s in subs)
        res.wall_start = min(s.qs for s in subs)
        res.wall_end = max(s.qe for s in subs)
        if control is not None:
            lengths = np.asarray([len(s.seq) for s in subs])
            probe = subs[int(np.argsort(lengths, kind="stable")[len(subs) // 2])]
            res.is_control = is_control_read(probe.seq, control)

    def fail(status: ZmwStatus) -> ZmwWorkItem:
        res.status = status
        rep = _median_fl_subread(subs)
        if rep is not None:
            res.fail_rep = rep.seq.copy()
            res.ff |= FF_MEDIAN_SUBREAD
        return ZmwWorkItem(zmw, res, None)

    # 1. SNR filter (how-does-ccs-work.md:21)
    if len(zmw.snr) and float(np.min(zmw.snr)) < cfg.min_snr:
        return fail(ZmwStatus.POOR_SNR)
    if not subs:
        return fail(ZmwStatus.NO_SUBREADS)

    # median-length filter
    keep = median_length_filter(subs)
    if not keep:
        return fail(ZmwStatus.NO_SUBREADS)
    subs = [subs[i] for i in keep]
    med_len = int(_median_val([len(s.seq) for s in subs]))
    res.insert_size = med_len  # until draft/polish overrides

    # full-length pass count (how-does-ccs-work.md:25)
    n_fl = sum(1 for s in subs if s.full_length)
    if cfg.mode_all and n_fl < 2:
        # --all exception 1 (mode-all.md:19-24): emit the median-length
        # subread unpolished, no polishing
        lengths = np.asarray([len(s.seq) for s in subs])
        rep = subs[int(np.argsort(lengths, kind="stable")[len(subs) // 2])]
        res.status = ZmwStatus.LOW_PASS_SHORTCUT
        res.seq = rep.seq.copy()
        res.qv = np.full(len(rep.seq), 10.0, np.float32)  # '+' = QV10
        res.rq = -1.0
        res.num_passes = n_fl
        res.insert_size = len(rep.seq)
        if (cfg.hifi_kinetics or cfg.all_kinetics) and rep.ipd is not None:
            res.sub_kinetics = (rep.ipd, rep.pw)
        return ZmwWorkItem(zmw, res, None)
    if n_fl < max(cfg.min_passes, 1 if not cfg.mode_all else 0):
        return fail(ZmwStatus.TOO_FEW_PASSES)

    # 1b. --top-passes cap
    subs = [subs[i] for i in cap_top_passes(subs, cfg.top_passes)]

    # 2. draft generation
    dr = generate_draft([s.seq for s in subs], [s.full_length for s in subs])
    if dr.draft is None:
        if cfg.mode_all and n_fl >= 1:
            # Revio semantics (fail-reads.md 0x8 / reports-aux-files.md): a
            # molecule with at least one full pass but no consensus is
            # reported as the median full-length subread in fail_reads.bam
            return fail(ZmwStatus.FULL_LENGTH_SUBREAD)
        return fail(ZmwStatus.DRAFT_FAILURE)
    draft = dr.draft
    res.insert_size = len(draft)

    # 0. tandem-repeat test on the draft (low-complexity.md:12-18); flagged
    # ZMWs implicitly run with heuristics disabled
    if has_long_tandem_repeat(draft, cfg.min_tandem_repeat_length):
        res.has_tandem_repeat = True

    # ma/ac adapter evidence (missing-adapters.md:7-28)
    res.adapter_info = adapter_counts([s.cx for s in subs], dr.strands)
    if cfg.max_length > 0 and len(draft) > cfg.max_length:
        return fail(ZmwStatus.TOO_LONG)
    if len(draft) < cfg.min_length:
        return fail(ZmwStatus.TOO_SHORT)

    fl_mapped = sum(1 for s, m in zip(subs, dr.mapped) if m and s.full_length)
    if cfg.mode_all and fl_mapped < 2:
        # --all exception 2/3 (mode-all.md:26-37): emit the unpolished draft
        # (or a representative subread with --subread-fallback) with rq=-1
        # and QV10 bases
        if cfg.subread_fallback:
            lengths = np.asarray([len(s.seq) for s in subs])
            rep = subs[int(np.argsort(lengths, kind="stable")[len(subs) // 2])]
            rep_seq = rep.seq.copy()
            if (cfg.hifi_kinetics or cfg.all_kinetics) and rep.ipd is not None:
                res.sub_kinetics = (rep.ipd, rep.pw)
        else:
            rep_seq = draft.copy()
        res.status = ZmwStatus.SUCCESS
        res.seq = rep_seq
        res.qv = np.full(len(rep_seq), 10.0, np.float32)
        res.rq = -1.0
        res.num_passes = n_fl
        res.insert_size = len(rep_seq)
        return ZmwWorkItem(zmw, res, None)

    # draft acceptance: >50% of subreads must align back
    # (accuracy-vs-passes.md:31-39)
    if dr.n_mapped * 2 <= len(subs):
        return fail(ZmwStatus.DRAFT_FAILURE)
    if fl_mapped < max(cfg.min_passes, 1):
        return fail(ZmwStatus.TOO_FEW_PASSES_AFTER_DRAFT_ALIGNMENT)

    # 3. align subreads to draft. The draft pileup's final vote round
    # already computed real affine alignments of the vote-set reads — its
    # traceback coordinates (dr.rpos) give exact window boundaries for
    # free. Reads without one (beyond-cap, orientation-rescued) fall back
    # to anchor chains + interpolation.
    T = len(draft)
    rpos_list: list[Optional[np.ndarray]] = []
    spans = 0
    from ccs_tpu_torch.ops.align import chain_batch
    need_chain = [i for i, (s, m) in enumerate(zip(subs, dr.mapped))
                  if m and (dr.rpos is None or i >= len(dr.rpos)
                            or dr.rpos[i] is None)]
    chains = {}
    if need_chain:
        oriented_nc = [dna.revcomp(subs[i].seq) if dr.strands[i]
                       else subs[i].seq for i in need_chain]
        for i, ch in zip(need_chain, chain_batch(oriented_nc, draft)):
            chains[i] = ch
    for i, (s, strand, mapped) in enumerate(zip(subs, dr.strands,
                                                dr.mapped)):
        if not mapped:
            rpos_list.append(None)
            continue
        read = dna.revcomp(s.seq) if strand else s.seq
        native_rpos = (dr.rpos[i] if dr.rpos is not None
                       and i < len(dr.rpos) else None)
        if native_rpos is not None:
            rpos = native_rpos.copy()
            spanning = 0.7 * T <= len(read) <= 1.6 * T
        else:
            chain = chains.get(i)
            if chain is None or len(chain) < 2:
                rpos_list.append(None)
                continue
            rpos = interp_read_pos(chain, np.arange(T + 1), len(read), T)
            # end-to-end span: anchors reach near both draft ends (margin
            # is fractional but at least a k-mer-placement-limited 60 bp).
            # At marginal SNR (~85% read accuracy) exact 13-mer anchors
            # thin out and genuinely spanning reads can miss the end
            # margins, so a mapped read whose LENGTH is compatible with
            # the draft also counts — the reference aligns full reads and
            # has no anchor-density dependence (how-does-ccs-work.md:53-55)
            margin = max(0.05 * T, 60.0)
            spanning = (chain[0, 1] < margin
                        and chain[-1, 1] > T - margin) or \
                (0.7 * T <= len(read) <= 1.6 * T)
        # pull the slice boundaries at the template ends outward a few
        # bases: the window slice otherwise cuts off exactly the unaligned
        # read prefix/suffix that holds the evidence for bases the draft
        # is missing at its ends (the HMM absorbs true overhangs as
        # insertions)
        rpos[0] = max(0, int(rpos[0]) - 6)
        rpos[T] = min(len(read), int(rpos[T]) + 6)
        rpos_list.append(rpos)
        spans += bool(spanning)
    if spans < max(cfg.min_passes, 1):
        return fail(ZmwStatus.INSUFFICIENT_SPANS)

    # 5. heteroduplex scan (how-does-ccs-work.md:65-72): >20bp single-strand
    # difference fails the ZMW (default mode); --hd-finder additionally runs
    # the pileup + Fisher substitution detector and the engine splits the
    # flagged ZMW into the by-strand path instead of failing it
    if not cfg.by_strand:
        hd = detect_heteroduplex(rpos_list, dr.strands, T,
                                 cfg.heteroduplex_min_len)
        if not hd and cfg.hd_finder:
            oriented_probe = [dna.revcomp(s.seq) if strand else s.seq
                              for s, strand in zip(subs, dr.strands)]
            hd = detect_heteroduplex_pileup(draft, oriented_probe, dr.strands)
        if hd:
            return fail(ZmwStatus.HETERODUPLEXES)

    oriented = [dna.revcomp(s.seq) if strand else s.seq
                for s, strand in zip(subs, dr.strands)]

    # pulse-width conditioning (how-does-ccs-work.md:88-95): when subreads
    # carry pw kinetics, pack per-base pw bins into the read codes so the
    # polisher's emissions see the kinetics evidence (codes base + 4*pw;
    # chemistry.pack_read_pw). Draft/anchor work above stays base-only.
    polish_reads = oriented
    if cfg.tpu_use_pw and params is not None and \
            any(s.pw is not None for s in subs):
        from ccs_tpu_torch.models.chemistry import pack_read_pw
        polish_reads = []
        for s, strand, rd in zip(subs, dr.strands, oriented):
            if s.pw is None:
                polish_reads.append(rd)
                continue
            pw = s.pw[::-1] if strand else s.pw
            bins = params.pw_bin(pw).astype(np.int8)
            polish_reads.append(pack_read_pw(rd, bins))

    # 4. windows + slices. Candidate priorities (C7) come from the draft
    # pileup's real per-position vote evidence when available; the
    # rpos-interpolation heuristic is only the fallback.
    pri_draft = None
    if dr.pos_stats is not None and len(dr.pos_stats) == len(draft):
        from ccs_tpu_torch.pipeline.windows import candidate_priority_from_stats
        pri_draft = candidate_priority_from_stats(draft, dr.pos_stats)
    batch = build_window_batch(
        draft, rpos_list, polish_reads, [s.full_length for s in subs],
        t_cap=cfg.tpu_window_tpl_cap, r_cap=cfg.tpu_window_read_cap,
        c_cap=cfg.tpu_window_coverage_cap,
        size=cfg.window_size, overlap=cfg.window_overlap,
        max_insertion_size=cfg.max_insertion_size, pri_draft=pri_draft)
    if len(batch.windows) == 0:
        return fail(ZmwStatus.DRAFT_FAILURE)

    # empty window / coverage-drop checks (how-does-ccs-work.md:COVERAGE_DROPS)
    cov = batch.coverage
    if (cov == 0).any():
        return fail(ZmwStatus.EMPTY_WINDOW_DURING_POLISHING)
    med_cov = float(np.median(cov))
    if med_cov >= 4 and float(cov.min()) < 0.3 * med_cov:
        return fail(ZmwStatus.COVERAGE_DROPS)

    # too many subreads dropped (large-insertion trim / coverage cap) while
    # building the polish input -> TOO_MANY_UNUSABLE (reports-aux-files.md)
    mean_cov = float((batch.rlens >= 0).sum(axis=1).mean())
    if dr.n_mapped >= 4 and mean_cov < 0.5 * dr.n_mapped:
        return fail(ZmwStatus.TOO_MANY_UNUSABLE)

    # np / ec per documented semantics (accuracy-vs-passes.md:15-29)
    fl_cov = (batch.full_len & (batch.rlens >= 0)).sum(axis=1)
    vals, counts = np.unique(fl_cov, return_counts=True)
    res.num_passes = int(vals[np.argmax(counts)])          # mode over windows
    res.effective_coverage = float((batch.rlens >= 0).sum(axis=1).mean())
    res.n_windows = len(batch.windows)

    snr_bin = int(np.searchsorted(params_snr_edges, float(np.mean(zmw.snr))))
    item = ZmwWorkItem(zmw, res, batch, snr_bin)
    if cfg.hifi_kinetics or cfg.all_kinetics:
        item.kin_entries = [
            KineticsEntry(read=s.seq, ipd=s.ipd, pw=s.pw, strand=strand,
                          full_length=s.full_length)
            for s, strand, m in zip(subs, dr.strands, dr.mapped) if m]
    return item


def finalize_zmw(item: ZmwWorkItem, tpl: np.ndarray, tlen: np.ndarray,
                 core_start: np.ndarray, core_end: np.ndarray,
                 qv: np.ndarray, converged: np.ndarray,
                 cfg: CcsConfig,
                 qv_rq: Optional[np.ndarray] = None) -> ConsensusResult:
    """Host phase 3: stitch polished window cores, compute rq, gate on
    --min-rq (how-does-ccs-work.md:108-112). ``qv_rq``, when given, is a
    parallel per-base QV stream used ONLY for rq (the Revio DC rule:
    rq averages the model QVs on processed windows while the written
    per-base QVs are Arrow re-scores — revio.md:41-51)."""
    res = item.result
    if not np.all(converged):
        res.status = ZmwStatus.NON_CONVERGENT
        return res
    pieces, qv_pieces, rq_pieces = [], [], []
    for w in range(len(tlen)):
        a, b = int(core_start[w]), int(core_end[w])
        a = max(0, min(a, int(tlen[w])))
        b = max(a, min(b, int(tlen[w])))
        pieces.append(np.asarray(tpl[w, a:b], dtype=np.int8))
        qv_pieces.append(np.asarray(qv[w, a:b], dtype=np.float32))
        if qv_rq is not None:
            rq_pieces.append(np.asarray(qv_rq[w, a:b], dtype=np.float32))
    seq = np.concatenate(pieces) if pieces else np.empty(0, np.int8)
    qvs = np.concatenate(qv_pieces) if qv_pieces else np.empty(0, np.float32)
    if len(seq) == 0:
        res.status = ZmwStatus.DRAFT_FAILURE
        return res
    rq_stream = np.concatenate(rq_pieces) if rq_pieces else qvs
    p_err = np.power(10.0, -rq_stream / 10.0)
    rq = float(1.0 - p_err.mean())
    res.seq = seq
    res.qv = qvs
    res.rq = rq
    res.insert_size = len(seq)
    if res.strand:
        res.ff |= FF_SINGLE_STRAND      # SS CCS reads (fail-reads.md 0x4)
    if rq < 0.99:
        res.ff |= FF_BELOW_Q20          # below HiFi Q20 (fail-reads.md 0x1)
    # adapter artifact classes fail the read (fail-reads.md, C15)
    art = classify_adapter_artifacts(seq)
    res.ff |= art
    if art & FF_ADAPTER_CONCAT:
        res.status = ZmwStatus.ADAPTER_CONCATENATION
        return res
    if art & FF_ADAPTER_PALINDROME:
        res.status = ZmwStatus.ADAPTER_PALINDROME
        return res
    if art & FF_ADAPTER_RESIDUE:
        res.status = ZmwStatus.ADAPTER_RESIDUE
        return res
    if rq < cfg.min_rq:
        res.status = ZmwStatus.POOR_QUALITY
        # reference still reports insert_size etc. for failed ZMWs
        return res
    res.status = ZmwStatus.SUCCESS
    if item.kin_entries:
        from ccs_tpu_torch.pipeline.kinetics import average_kinetics
        res.kinetics = average_kinetics(seq, item.kin_entries)
    return res
