"""ccs_tpu_torch — the ccs_tpu circular consensus engine on PyTorch and CUDA.

A second, self-contained package beside ``ccs_tpu``: it imports nothing of
``ccs_tpu``. The host side (I/O, filters, draft, windowing, reports, the
native C++ aligner, the simulator) is this package's own copy of the
framework-free ``ccs_tpu`` modules, under the same relative paths and names.
The device side runs on PyTorch tensors, with hand-written CUDA kernels for
an NVIDIA Hopper card: the Arrow pair-HMM mutation scorer
(``csrc/hmm_score.cu``) under the polish loop, and the banded edit distance
(``csrc/edit_banded.cu``).

This module imports nothing heavy: the spawned host-prepare worker
processes import the package and must load neither torch nor CUDA.
"""

__version__ = "0.1.0"

from ccs_tpu_torch.statuses import ZmwStatus  # noqa: E402,F401
from ccs_tpu_torch.config import CcsConfig  # noqa: E402,F401
