"""QV binning compressor (component C12).

Exact 7-bin table from reference docs, faq/qv-binning.md:23-31; binning
is applied to per-base QVs after ``rq`` has been computed and yields up to
40% BAM size reduction.
"""

from __future__ import annotations

import numpy as np

# (low, high, mean_qv) — inclusive ranges over integer QV
QV_BINS = [
    (0, 6, 3),
    (7, 13, 10),
    (14, 19, 17),
    (20, 24, 22),
    (25, 29, 27),
    (30, 39, 35),
    (40, 93, 40),
]

_LUT = np.zeros(94, dtype=np.uint8)
for lo, hi, mean in QV_BINS:
    _LUT[lo:hi + 1] = mean


def bin_qvs(qv: np.ndarray) -> np.ndarray:
    """Float or integer per-base QVs -> binned integer QVs (uint8)."""
    q = np.clip(np.floor(np.asarray(qv)), 0, 93).astype(np.int64)
    return _LUT[q]


def qv_to_ascii(qv: np.ndarray) -> bytes:
    """Phred+33 ASCII encoding."""
    return (np.asarray(qv, dtype=np.uint8) + 33).tobytes()
