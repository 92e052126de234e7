"""Draft consensus generation (component C2, SURVEY.md §2.1).

Sparc-style backbone-anchored graph consensus
(reference docs, how-does-ccs-work.md:34-51): pick a backbone subread,
align the other subreads to it (orientation inferred per subread, edlib-style
banded edit alignment), accumulate weighted votes per backbone position for
substitutions/deletions/insertions, and emit the weighted-majority sequence.
Run as a cascade (accuracy-vs-passes.md:41-46): round 1 drafts against the
backbone, round 2 re-aligns against the round-1 draft (slower, more robust).

Output accuracy target is ~99% (how-does-ccs-work.md:46-47) — the Arrow
polisher fixes the rest.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Optional

import numpy as np

from ccs_tpu_torch.ops import dna
from ccs_tpu_torch.ops.align import anchor_chain, guided_align


@dataclasses.dataclass
class DraftResult:
    draft: Optional[np.ndarray]      # int8 codes, or None on failure
    strands: list[int]               # per-subread inferred strand (0 fwd / 1 rev)
    mapped: list[bool]               # per-subread: aligned to backbone/draft?
    n_mapped: int = 0
    # per-draft-position pileup evidence [len(draft), 3] f32 (cov, agree,
    # indel) from the FINAL vote round — the candidate filter's input (C7,
    # reference docs, faq/performance.md:90-93)
    pos_stats: Optional[np.ndarray] = None
    # per-read REAL alignment coordinates [len(draft)+1] i64 (vote-round
    # traceback remapped onto draft coordinates; None rows = derive from
    # anchor chains instead). Replaces interpolation for window slicing.
    rpos: Optional[list] = None


def infer_orientation(read: np.ndarray, backbone: np.ndarray,
                      k: int = 13) -> tuple[int, int]:
    """Infer strand by anchor count: returns (strand, n_anchors)."""
    fwd = len(anchor_chain(read, backbone, k))
    rev = len(anchor_chain(dna.revcomp(read), backbone, k))
    return (0, fwd) if fwd >= rev else (1, rev)


def _pileup_consensus(tpl: np.ndarray, aligned_reads: list[np.ndarray],
                      min_identity: float = 0.60, band: int = 24,
                      want_stats: bool = False, want_rpos: bool = False
                      ) -> tuple[Optional[np.ndarray], list[bool],
                                 np.ndarray, float, Optional[np.ndarray],
                                 Optional[list]]:
    """Align reads to tpl, vote, and emit the weighted-majority sequence.

    Returns (draft, mapped, identities, weak_frac, stats): identities are
    per-read global alignment identities (0 where unaligned); weak_frac is
    the fraction of template positions whose pileup majority fails to clear
    half the local coverage — a chimeric backbone scatters votes over its
    junk half, so the cascade uses this to reject it. ``stats`` (only when
    ``want_stats``) is [len(draft), 3] f32 (cov, agree, indel) per emitted
    position — the candidate filter's evidence (C7). ``rpos`` (only when
    ``want_rpos``, native path) is a per-read list of [len(draft)+1] i64
    read coordinates at every emitted draft position — the REAL alignment
    paths from the vote round's traceback, replacing the anchor-chain
    interpolation the window slicer otherwise needs (None rows for
    unmapped reads; None entirely on the NumPy fallback, where the caller
    falls back to chains). Dispatches to the
    native C++ kernel (ccs_pileup_draft: anchor chain + affine DP + vote
    walk + consensus emit in one call — the round-2 host bottleneck was
    this loop in Python); the code below is the oracle/fallback
    (CCS_TPU_NO_NATIVE=1)."""
    from ccs_tpu_torch import native
    lib = native.load()
    if lib is not None and hasattr(lib, "ccs_pileup_draft") and len(tpl):
        import ctypes
        tpl_c = np.ascontiguousarray(tpl, dtype=np.int8)
        T = len(tpl_c)
        n_reads = len(aligned_reads)
        offs = np.zeros(n_reads + 1, dtype=np.int64)
        for i, r in enumerate(aligned_reads):
            offs[i + 1] = offs[i] + len(r)
        flat = np.empty(int(offs[-1]), dtype=np.int8)
        for i, r in enumerate(aligned_reads):
            flat[offs[i]:offs[i + 1]] = r
        cap = 2 * T + int(offs[-1] // max(n_reads, 1)) + 4096
        out = np.empty(cap, dtype=np.int8)
        out_len = np.zeros(1, dtype=np.int64)
        out_mapped = np.zeros(n_reads, dtype=np.uint8)
        out_ident = np.zeros(n_reads, dtype=np.float64)
        out_weak = np.ones(1, dtype=np.float64)
        stats = np.zeros((cap, 3), dtype=np.float32) if want_stats else None
        rp = (np.zeros((n_reads, T + 1), dtype=np.int64)
              if want_rpos else None)
        src = np.zeros(cap, dtype=np.int32) if want_rpos else None

        def ptr(a):
            return a.ctypes.data_as(ctypes.c_void_p) if a is not None \
                else None

        # band 24 default: measured identical draft accuracy to 48 at
        # SNR 8 x 10 passes and ~1.4x faster — anchors keep the DP
        # centered, and guided_affine retries at 2x band on escape
        n_mapped = lib.ccs_pileup_draft(
            tpl_c.ctypes.data_as(ctypes.c_void_p), T,
            flat.ctypes.data_as(ctypes.c_void_p),
            offs.ctypes.data_as(ctypes.c_void_p), n_reads,
            13, band, 6, 2, 2, float(min_identity),
            out.ctypes.data_as(ctypes.c_void_p), cap,
            out_len.ctypes.data_as(ctypes.c_void_p),
            out_mapped.ctypes.data_as(ctypes.c_void_p),
            out_ident.ctypes.data_as(ctypes.c_void_p),
            out_weak.ctypes.data_as(ctypes.c_void_p),
            ptr(stats), ptr(rp), ptr(src))
        if n_mapped >= 0:  # -2 = buffer overflow -> fall through to NumPy
            mapped = [bool(m) for m in out_mapped]
            if n_mapped == 0:
                return None, mapped, out_ident, 1.0, None, None
            nl = int(out_len[0])
            rlist = None
            if want_rpos:
                # remap each read's per-ROUND-template rpos onto the
                # EMITTED draft coordinates via the per-base source map
                srcn = src[:nl].astype(np.int64)
                rlist = []
                for i in range(n_reads):
                    if not out_mapped[i]:
                        rlist.append(None)
                        continue
                    rf = np.empty(nl + 1, np.int64)
                    rf[:nl] = rp[i][srcn]
                    rf[nl] = rp[i][T]
                    rlist.append(rf)
            return (out[:nl].copy(), mapped, out_ident, float(out_weak[0]),
                    stats[:nl].copy() if stats is not None else None, rlist)
    T = len(tpl)
    sub_votes = np.zeros((T, 4), dtype=np.float64)
    del_votes = np.zeros(T, dtype=np.float64)
    cov = np.zeros(T, dtype=np.float64)
    ins_votes: list[Counter] = [Counter() for _ in range(T + 1)]
    mapped = []
    idents = np.zeros(len(aligned_reads), dtype=np.float64)
    n_mapped = 0
    for ri, read in enumerate(aligned_reads):
        # affine KSW2-style costs (how-does-ccs-work.md:53-55): sub > 1-gap
        # (SMRT errors are indel-dominated) and long indels collapse into one
        # run, concentrating pileup votes at a single template position
        aln = guided_align(read, tpl, sub_cost=6, gap_cost=2, gap_open=2)
        if aln is not None:
            idents[ri] = aln.identity()
        if aln is None or aln.identity() < min_identity:
            mapped.append(False)
            continue
        mapped.append(True)
        n_mapped += 1
        # walk the cigar accumulating votes
        i = j = 0
        pending_ins: list[int] = []
        for length, op in aln.cigar:
            if op == "M":
                if pending_ins:
                    ins_votes[j][tuple(pending_ins)] += 1
                    pending_ins = []
                idx = np.arange(length)
                sub_votes[j + idx, read[i + idx]] += 1.0
                cov[j:j + length] += 1.0
                i += length
                j += length
            elif op == "D":
                if pending_ins:
                    ins_votes[j][tuple(pending_ins)] += 1
                    pending_ins = []
                del_votes[j:j + length] += 1.0
                cov[j:j + length] += 1.0
                j += length
            else:  # I
                pending_ins.extend(int(b) for b in read[i:i + length])
                i += length
        if pending_ins:
            ins_votes[j][tuple(pending_ins)] += 1
    if n_mapped == 0:
        return None, mapped, idents, 1.0, None, None

    out: list[int] = []
    st: list[tuple] = []
    half = np.maximum(cov / 2.0, 0.5)
    best_base = np.argmax(sub_votes, axis=1)
    best_count = sub_votes[np.arange(T), best_base]
    weak_frac = float(((cov <= 0) | (2.0 * best_count <= cov)).mean()) \
        if T else 1.0

    def ins_mass(j):
        return float(sum(ins_votes[j].values())) if 0 <= j <= T else 0.0

    for j in range(T):
        # insertions before position j kept if a single variant clears half cov
        if ins_votes[j]:
            seq, cnt = ins_votes[j].most_common(1)[0]
            covj = cov[j] if j < T else cov[-1]
            if cnt > max(covj, 1) / 2.0:
                out.extend(seq)
                st.extend([(covj, cnt, covj - cnt)] * len(seq))
        if del_votes[j] > best_count[j]:
            continue  # deleted
        indel = del_votes[j] + ins_mass(j) + ins_mass(j + 1)
        if cov[j] > 0:
            out.append(int(best_base[j]))
            st.append((cov[j], best_count[j], indel))
        else:
            out.append(int(tpl[j]))  # uncovered: keep backbone base
            st.append((0.0, 0.0, indel))
    if ins_votes[T]:
        seq, cnt = ins_votes[T].most_common(1)[0]
        covj = cov[-1] if T else 1
        if cnt > max(covj, 1) / 2.0:
            out.extend(seq)
            st.extend([(covj, cnt, covj - cnt)] * len(seq))
    stats = (np.asarray(st, dtype=np.float32).reshape(-1, 3)
             if want_stats else None)
    return (np.asarray(out, dtype=np.int8), mapped, idents, weak_frac,
            stats, None)


def _try_backbone(subreads, full_length, backbone_i: int,
                  max_draft_coverage: int, rounds: int,
                  min_identity: float) -> tuple[DraftResult, float]:
    """One cascade stage: orient against ``backbone_i``, run the pileup
    rounds, map everything back. Returns (result, mean mapped identity,
    weak_frac) — a chimeric backbone shows up as a LOW mean identity and a
    HIGH weak-pileup fraction even when global alignments squeak past the
    mapping gate."""
    n = len(subreads)
    backbone = subreads[backbone_i]
    # batched orientation: one shared backbone k-mer index for all reads
    # (ops.align.orient_chain_batch; same fwd-wins-ties rule as
    # infer_orientation)
    from ccs_tpu_torch.ops.align import orient_chain_batch
    others = [i for i in range(n) if i != backbone_i]
    # k=11 for orientation: both sequences here are RAW subreads, so 13-mer
    # survival is ~(1-2e)^13 — at ~14% per-base error that is ~4 expected
    # anchors per 300 bp and misorientation becomes likely; 11-mers triple
    # the anchor count while 4^11 still dwarfs any insert's k-mer set
    ostr, _chains = orient_chain_batch([subreads[i] for i in others],
                                       backbone, k=11)
    strands = [0] * n
    oriented = list(subreads)
    for i, s in zip(others, ostr):
        strands[i] = s
        if s:
            oriented[i] = dna.revcomp(subreads[i])

    # draft votes from up to max_draft_coverage subreads (backbone included).
    # Early cascade rounds ("very fast and unstable",
    # accuracy-vs-passes.md:41-46) vote from a small subset — their only job
    # is a cleaner template for the final round's alignments, and 6 reads
    # already put draft accuracy in the high-90s (measured: round-1 votes
    # of 6 vs 8 are within noise at SNR 8 x 10 passes); the FINAL round
    # votes (and maps) with the full set.
    vote_idx = list(range(n))[:max_draft_coverage]
    tpl = backbone
    mapped_last = [True] * n
    idents = np.zeros(n)
    weak = 1.0
    pos_stats = None
    rpos_vote = None
    for r in range(rounds):
        ridx = vote_idx if r == rounds - 1 else vote_idx[:6]
        final = r == rounds - 1
        # early rounds are "fast and unstable" by design: a narrower band
        # suffices because their draft only seeds the final round. Bands
        # 12/16 measured accuracy-identical to 16/24 (35.9 vs 36.0 draft
        # err/kb, 20x 2kb/10-pass SNR-9 ZMWs) — anchors center the band
        # and guided_affine retries at 2x on escape.
        draft, mapped, idents_v, weak, stats, rlist = _pileup_consensus(
            tpl, [oriented[i] for i in ridx], min_identity=min_identity,
            band=12 if not final else 16, want_stats=final,
            want_rpos=final)
        if draft is None or len(draft) == 0:
            return DraftResult(None, strands, [False] * n, 0), 0.0, 1.0
        tpl = draft
        if final:
            mapped_last = mapped
            idents[:len(idents_v)] = idents_v
            pos_stats = stats
            rpos_vote = rlist
    # final mapped flags for ALL subreads vs the final draft
    mapped_all = []
    for i in range(n):
        if i < len(vote_idx):
            mapped_all.append(mapped_last[i])
        else:
            aln = guided_align(oriented[i], tpl)
            ok = aln is not None and aln.identity() >= min_identity
            if aln is not None:
                idents[i] = aln.identity()
            mapped_all.append(ok)
    # orientation rescue: a misoriented read (sparse anchor chains on noisy
    # backbones make the orientation vote flip a coin) maps terribly against
    # the final draft; if its reverse complement clears the gate, flip it
    # back in — each rescued pass is real polishing evidence (ec semantics,
    # accuracy-vs-passes.md:15-29)
    for i in range(n):
        if mapped_all[i]:
            continue
        rc = dna.revcomp(oriented[i])
        aln = guided_align(rc, tpl, sub_cost=6, gap_cost=2, gap_open=2)
        if aln is not None and aln.identity() >= min_identity and \
                aln.identity() > idents[i]:
            strands[i] ^= 1
            oriented[i] = rc
            idents[i] = aln.identity()
            mapped_all[i] = True
    m = np.asarray(mapped_all, bool)
    mean_ident = float(idents[m].mean()) if m.any() else 0.0
    rpos_all = None
    if rpos_vote is not None:
        # vote_idx rows carry real alignment paths; everything else (rare:
        # beyond-cap reads, rescued flips) falls back to anchor chains
        rpos_all = [None] * n
        for pos_i, i in enumerate(vote_idx):
            if pos_i < len(rpos_vote):
                rpos_all[i] = rpos_vote[pos_i]
    return (DraftResult(tpl, strands, mapped_all, sum(mapped_all),
                        pos_stats=pos_stats, rpos=rpos_all),
            mean_ident, weak)


def generate_draft(subreads: list[np.ndarray],
                   full_length: list[bool],
                   max_draft_coverage: int = 16,
                   rounds: int = 2) -> DraftResult:
    """Backbone pick + cascade pileup consensus.

    The cascade runs "from very fast and unstable to slow and robust" with
    fallback (reference docs, faq/accuracy-vs-passes.md:41-46):

    1. fast path — backbone = median-length full-length subread, two pileup
       rounds at identity >= 0.60;
    2. if fewer than half the subreads map back (a chimeric / junk
       backbone poisons every alignment), retry with the next backbone
       candidates around the median length;
    3. last resort — best candidate re-run with the identity gate relaxed
       to 0.50 (low-SNR molecules whose true identity hovers near 0.6).

    ``strands`` are relative to the chosen backbone's orientation.
    """
    n = len(subreads)
    if n == 0:
        return DraftResult(None, [], [], 0)
    fl_idx = [i for i in range(n) if full_length[i]] or list(range(n))
    lengths = np.asarray([len(subreads[i]) for i in fl_idx])
    order = np.argsort(lengths, kind="stable")
    mid = len(order) // 2
    # backbone candidates: median, then nearest neighbors by length rank
    cand_ranks = [mid] + [r for off in (1, 2)
                          for r in (mid - off, mid + off)
                          if 0 <= r < len(order)]
    candidates = []
    for r in cand_ranks[:3]:
        i = fl_idx[int(order[r])]
        if i not in candidates:
            candidates.append(i)

    # Cascade stages ("fast and unstable -> slow and robust",
    # accuracy-vs-passes.md:41-46): round 1 votes from a small subset
    # against the backbone, the final round votes and maps the full set
    # against the round-1 draft (_try_backbone). A single-round draft was
    # measured ~15% relatively worse (41 vs 35 err/kb at SNR 9 x 10 passes)
    # — below the documented C2 accuracy band (how-does-ccs-work.md:46-47),
    # so two rounds stay the floor.
    best: Optional[DraftResult] = None
    best_key = (-1, 0.0)
    for backbone_i in candidates:
        res, ident, weak = _try_backbone(subreads, full_length, backbone_i,
                                         max_draft_coverage, rounds, 0.60)
        if (res.n_mapped, ident) > best_key:
            best, best_key = res, (res.n_mapped, ident)
        # fast accept: majority maps, pileup agrees, and the mean mapped
        # identity is in the healthy band (a chimeric backbone drags it to
        # ~0.75 even when every global alignment clears the 0.6 gate;
        # clean molecules sit at ~0.80+ across the SNR range)
        if res.draft is not None and 2 * res.n_mapped > n \
                and weak < 0.12 and ident >= 0.78:
            return res
    if best is not None and best.draft is not None and \
            2 * best.n_mapped > n:
        return best             # all candidates marginal; take the best
    # robust last resort: relaxed identity on the best candidate so far
    res, ident, weak = _try_backbone(subreads, full_length, candidates[0],
                                     max_draft_coverage, rounds, 0.50)
    if (res.n_mapped, ident) > best_key:
        best = res
    return best
