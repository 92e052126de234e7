"""ccs_tpu_torch — the ccs_tpu circular consensus engine on PyTorch and CUDA.

A second package beside ``ccs_tpu``: the host side (I/O, filters, draft,
windowing, reports) is imported from ``ccs_tpu`` unchanged, and the device
polish path (the Arrow pair-HMM mutation scorer and the polish loop around
it) runs on PyTorch tensors, with a hand-written CUDA kernel for the scorer
on an NVIDIA Hopper card (``csrc/hmm_score.cu``).

This module imports nothing heavy: the spawned host-prepare worker
processes import the package and must load neither torch nor CUDA.
"""

__version__ = "0.1.0"
