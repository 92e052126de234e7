"""Arrow parameter tables as torch tensors.

Counterpart of ``ccs_tpu.ops.hmm_jax``'s ``params_to_device``,
``decode_reads`` and ``position_tables``. Tables are float32:
``trans``/``emit_match``/``emit_stick`` [8, 16, 4] (snr bin x dinucleotide
context x 4), ``pw_match``/``pw_ins`` [8, 4] (snr bin x pulse-width bin),
``snr_edges`` [7], and ``clean_perr`` [8, 41] (snr bin x coverage), the
calibrated error rate of an unpolished position in candidate-sparse mode.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

import ccs_tpu
from ccs_tpu.models.chemistry import ArrowParams

PARAM_KEYS = ("trans", "emit_match", "emit_stick", "snr_edges", "pw_match",
              "pw_ins")
CLEAN_PERR_PATH = os.path.join(os.path.dirname(ccs_tpu.__file__), "models",
                               "data", "clean_perr_v0.npy")


def load_clean_perr() -> np.ndarray:
    """The shipped clean-position error table (fit by tools/fit_clean_qv.py)."""
    return np.load(CLEAN_PERR_PATH).astype(np.float32)


def tables_from_numpy(d: dict, device) -> dict[str, torch.Tensor]:
    """float32 tensors on ``device`` from a dict of array-likes — the way
    weights carried across from the JAX package's tables come in."""
    return {k: torch.as_tensor(np.array(v, dtype=np.float32),
                               device=device)
            for k, v in d.items()}


def params_to_torch(params: ArrowParams, device) -> dict[str, torch.Tensor]:
    """Device copies of the parameter tables plus the clean-position table."""
    d = {k: getattr(params, k) for k in PARAM_KEYS}
    d["clean_perr"] = load_clean_perr()
    return tables_from_numpy(d, device)


def decode_reads(reads: torch.Tensor):
    """Split packed read codes (base + 4*pw, chemistry.pack_read_pw) into
    base codes and pw bins; pads (< 0) keep base/pw 0 — callers mask by
    rlens."""
    c = reads.long().clamp(0, 15)
    return c % 4, c // 4


def position_tables(tpl: torch.Tensor, snr_bin: torch.Tensor, tables: dict):
    """Per-position probability tables.

    tpl [..., T] int8, snr_bin [...] int (broadcast over positions)
    -> match_emit [..., T, 4], ins_emit [..., T, 4], del_p [..., T];
    zero at padded positions (tpl < 0).
    """
    t = tpl.long().clamp(0, 3)
    prev = torch.cat([t[..., :1], t[..., :-1]], dim=-1)
    ctx = 4 * prev + t
    b = snr_bin.long()[..., None]
    trans = tables["trans"][b, ctx]            # [..., T, 4]
    em = tables["emit_match"][b, ctx]
    es = tables["emit_stick"][b, ctx]
    onehot = F.one_hot(t, 4).to(trans.dtype)
    match_emit = trans[..., 0:1] * em
    ins_emit = trans[..., 1:2] * onehot + trans[..., 2:3] * es
    del_p = trans[..., 3]
    valid = (tpl >= 0)[..., None]
    return (torch.where(valid, match_emit, 0.0),
            torch.where(valid, ins_emit, 0.0),
            torch.where(valid[..., 0], del_p, 0.0))
