"""Seconds of chunk staging per 1000 ZMWs: packing the bucket arrays
(``pack``) and pinning and enqueueing their copies to the card (``h2d``),
from the CLI's 'wall split' line, whole run."""


def read(obs):
    try:
        from ccs_tpu_torch.telemetry import WALL_SPLIT_FIELDS
    except ImportError:             # a program without the spans
        return None
    split = obs.get("wall_split")
    if not split or len(split) != len(WALL_SPLIT_FIELDS):
        return None
    f = dict(zip(WALL_SPLIT_FIELDS, split))
    return 1000.0 * (f[("pack", "s")] + f[("h2d", "s")]) / obs["run_zmws"]
