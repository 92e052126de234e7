"""Chemistry model store: Arrow-style pair-HMM parameter tables.

The reference keys transition/emission parameters by dinucleotide template
context, pulse width, and ZMW SNR, loaded per chemistry from bundled
``model.json`` files, with out-of-band injection via the
``SMRT_CHEMISTRY_BUNDLE_DIR`` env var (reference docs, how-does-ccs-work.md:88-95,
docs/faq/chemistry.md:27-56). PacBio's fitted tables are not public, so we ship
a default model with the same *structure* (16 dinucleotide contexts × SNR bins)
whose values are set to plausible SMRT error rates and can be re-fitted from
data (SURVEY.md §7 hard-part 6).

Generative model (our own design, TPU-first; structurally the documented
left-right Arrow HMM):

At template position ``j`` with dinucleotide context ``ctx = 4*t[j-1] + t[j]``
the process repeatedly chooses one of:

- **Match**  (prob ``trans[ctx,0]``): emit a base from ``emit_match[ctx]``,
  advance to ``j+1``.
- **Branch** (prob ``trans[ctx,1]``): emit a copy of the template base ``t[j]``
  (pulse-merging artifact), stay at ``j``.
- **Stick**  (prob ``trans[ctx,2]``): emit a non-template base from
  ``emit_stick[ctx]``, stay at ``j``.
- **Delete** (prob ``trans[ctx,3]``): emit nothing, advance to ``j+1``.

The read likelihood marginalizes over all alignments (forward algorithm).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Optional

import numpy as np

logger = logging.getLogger("ccs_tpu")

N_CTX = 16       # dinucleotide contexts (prev base × current base)
N_SNR_BINS = 8   # ZMW SNR bins
N_PW_BINS = 4    # pulse-width bins: 0 = unknown/no-kinetics, 1..3 = short/
                 # mid/long pulses (how-does-ccs-work.md:88-95 keys the model
                 # on dinuc ctx + PW + SNR)


def pack_read_pw(bases: np.ndarray, pw_bins: np.ndarray) -> np.ndarray:
    """Pack per-base pulse-width bins into read codes: code = base + 4*pw.

    Keeps every device array int8 and every kernel signature unchanged —
    kernels decode base = code % 4, pw = code // 4. Codes 0..3 are plain
    bases (pw bin 0 = unknown, factor fixed at 1), pad stays -1.
    """
    bases = np.asarray(bases, dtype=np.int8)
    out = bases + 4 * np.asarray(pw_bins, dtype=np.int8)
    return np.where(bases < 0, np.int8(-1), out).astype(np.int8)


@dataclasses.dataclass
class ArrowParams:
    """Parameter tables for one chemistry.

    All arrays are indexed ``[snr_bin, ctx, ...]`` so a ZMW picks its bin once
    and the per-position tables become simple gathers on device.
    """
    name: str
    snr_edges: np.ndarray     # [N_SNR_BINS-1] ascending bin edges over mean SNR
    trans: np.ndarray         # [N_SNR_BINS, N_CTX, 4] (match, branch, stick, delete)
    emit_match: np.ndarray    # [N_SNR_BINS, N_CTX, 4] p(read base | Match, ctx)
    emit_stick: np.ndarray    # [N_SNR_BINS, N_CTX, 4] p(read base | Stick, ctx);
                              #   entry at the template base is 0
    # pulse-width conditioning (how-does-ccs-work.md:88-95): per-read-base
    # likelihood-ratio factors vs the marginal pulse-width distribution.
    # pw_match[s, w] multiplies Match emissions of a base in pw bin w,
    # pw_ins[s, w] multiplies Branch/Stick emissions. Bin 0 = unknown pw
    # (factor pinned to 1.0, used when the input carries no kinetics).
    # Only the ratio pw_ins/pw_match matters for consensus/QV (a common
    # per-base scale is a per-read constant); the fitted gauge is
    # E_w~prior[pw_match] = 1.
    pw_edges: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([10.0, 24.0], dtype=np.float32))
    pw_match: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones((N_SNR_BINS, N_PW_BINS), np.float32))
    pw_ins: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones((N_SNR_BINS, N_PW_BINS), np.float32))

    def snr_bin(self, snr: float | np.ndarray) -> np.ndarray:
        return np.searchsorted(self.snr_edges, np.asarray(snr))

    def pw_bin(self, pw_frames: np.ndarray) -> np.ndarray:
        """Map instrument pulse widths (frames, `pw` tag) to bins 1..3."""
        return 1 + np.searchsorted(self.pw_edges, np.asarray(pw_frames))

    def validate(self) -> None:
        assert self.trans.shape == (N_SNR_BINS, N_CTX, 4)
        assert self.emit_match.shape == (N_SNR_BINS, N_CTX, 4)
        assert self.emit_stick.shape == (N_SNR_BINS, N_CTX, 4)
        np.testing.assert_allclose(self.trans.sum(-1), 1.0, atol=1e-5)
        np.testing.assert_allclose(self.emit_match.sum(-1), 1.0, atol=1e-5)
        np.testing.assert_allclose(self.emit_stick.sum(-1), 1.0, atol=1e-5)
        for ctx in range(N_CTX):
            cur_base = ctx % 4
            assert np.all(self.emit_stick[:, ctx, cur_base] == 0.0), (
                "Stick must not emit the template base")
        assert self.pw_edges.shape == (N_PW_BINS - 2,)
        assert self.pw_match.shape == (N_SNR_BINS, N_PW_BINS)
        assert self.pw_ins.shape == (N_SNR_BINS, N_PW_BINS)
        assert np.all(self.pw_match > 0) and np.all(self.pw_ins > 0)
        np.testing.assert_allclose(self.pw_match[:, 0], 1.0, atol=1e-6)
        np.testing.assert_allclose(self.pw_ins[:, 0], 1.0, atol=1e-6)

    # --- serialization (model.json bundle format) ---
    def to_json(self) -> str:
        return json.dumps({
            "name": self.name,
            "snr_edges": self.snr_edges.tolist(),
            "trans": self.trans.tolist(),
            "emit_match": self.emit_match.tolist(),
            "emit_stick": self.emit_stick.tolist(),
            "pw_edges": self.pw_edges.tolist(),
            "pw_match": self.pw_match.tolist(),
            "pw_ins": self.pw_ins.tolist(),
        })

    @staticmethod
    def from_json(text: str) -> "ArrowParams":
        d = json.loads(text)
        p = ArrowParams(
            name=d["name"],
            snr_edges=np.asarray(d["snr_edges"], dtype=np.float32),
            trans=np.asarray(d["trans"], dtype=np.float32),
            emit_match=np.asarray(d["emit_match"], dtype=np.float32),
            emit_stick=np.asarray(d["emit_stick"], dtype=np.float32),
        )
        # pw tables are optional in older bundles (factor 1 = pw-agnostic)
        if "pw_match" in d:
            p.pw_edges = np.asarray(d["pw_edges"], dtype=np.float32)
            p.pw_match = np.asarray(d["pw_match"], dtype=np.float32)
            p.pw_ins = np.asarray(d["pw_ins"], dtype=np.float32)
        p.validate()
        return p


def default_params(name: str = "default") -> ArrowParams:
    """Default fitted-by-construction model: ~90% subread accuracy
    (how-does-ccs-work.md:46 'subreads have accuracy of around 90%'), with
    mild SNR and homopolymer-context modulation."""
    rng_snr = np.linspace(3.0, 14.0, N_SNR_BINS)
    snr_edges = 0.5 * (rng_snr[:-1] + rng_snr[1:])

    trans = np.zeros((N_SNR_BINS, N_CTX, 4), dtype=np.float64)
    emit_match = np.zeros((N_SNR_BINS, N_CTX, 4), dtype=np.float64)
    emit_stick = np.zeros((N_SNR_BINS, N_CTX, 4), dtype=np.float64)

    for b in range(N_SNR_BINS):
        # Higher SNR -> fewer errors. Error scale from 1.4x (low SNR) to 0.7x.
        scale = 1.4 - 0.7 * b / (N_SNR_BINS - 1)
        for ctx in range(N_CTX):
            prev, cur = ctx // 4, ctx % 4
            homo = 1.5 if prev == cur else 1.0  # homopolymers are error-prone
            p_branch = min(0.045 * scale * homo, 0.25)
            p_stick = min(0.025 * scale, 0.25)
            p_del = min(0.045 * scale * homo, 0.25)
            p_match = 1.0 - p_branch - p_stick - p_del
            trans[b, ctx] = (p_match, p_branch, p_stick, p_del)

            p_mis = min(0.015 * scale, 0.2)
            em = np.full(4, p_mis / 3)
            em[cur] = 1.0 - p_mis
            emit_match[b, ctx] = em

            es = np.full(4, 1.0 / 3.0)
            es[cur] = 0.0
            emit_stick[b, ctx] = es

    p = ArrowParams(
        name=name,
        snr_edges=snr_edges.astype(np.float32),
        trans=trans.astype(np.float32),
        emit_match=emit_match.astype(np.float32),
        emit_stick=emit_stick.astype(np.float32),
    )
    p.validate()
    return p


# Chemistries we recognize out of the box, keyed by BINDINGKIT part code.
# Values are paths (relative to models/data/) of fitted model.json bundles
# produced by models/fit.py — PacBio's own tables are not public
# (docs/faq/chemistry.md), so these are fitted from sampled training reads
# and are re-fittable from real subreads via fit.fit_from_zmws.
_BUILTIN_CHEMISTRIES = {
    "101-894-200": "arrow_101-894-200.json",   # Sequel II SP3-C3-style kit
}
_loaded_builtins: dict[str, "ArrowParams"] = {}


def _builtin(key: str) -> Optional["ArrowParams"]:
    if key not in _BUILTIN_CHEMISTRIES:
        return None
    if key not in _loaded_builtins:
        path = os.path.join(os.path.dirname(__file__), "data",
                            _BUILTIN_CHEMISTRIES[key])
        with open(path) as fh:
            _loaded_builtins[key] = ArrowParams.from_json(fh.read())
        logger.info("Loaded built-in chemistry model for %s (%s)", key,
                    _loaded_builtins[key].name)
    return _loaded_builtins[key]


def load_model(chemistry: Optional[dict[str, str]],
               bundle_dir: Optional[str] = None) -> ArrowParams:
    """Resolve the Arrow model for a BAM's chemistry triple.

    Mirrors the documented resolution order (chemistry.md:27-56): an injected
    ``SMRT_CHEMISTRY_BUNDLE_DIR`` bundle (INFO-logged) wins over built-ins.
    """
    bundle_dir = bundle_dir or os.environ.get("SMRT_CHEMISTRY_BUNDLE_DIR")
    if bundle_dir:
        model_path = os.path.join(bundle_dir, "arrow", "model.json")
        if os.path.exists(model_path):
            logger.info("Loaded chemistry bundle from %s", model_path)
            with open(model_path) as fh:
                return ArrowParams.from_json(fh.read())
    if chemistry:
        key = chemistry.get("BINDINGKIT", "")
        builtin = _builtin(key)
        if builtin is not None:
            return builtin
    return default_params()
