"""Seconds the host blocks on the card inside the device step per 1000
ZMWs: ``sync`` (the polish loop's reads) plus ``pull`` (the results' copy
back), the 'wall split' line's ``device_wait``, whole run."""


def read(obs):
    try:
        from ccs_tpu_torch.telemetry import WALL_SPLIT_FIELDS
    except ImportError:             # a program without the spans
        return None
    split = obs.get("wall_split")
    if not split or len(split) != len(WALL_SPLIT_FIELDS):
        return None
    f = dict(zip(WALL_SPLIT_FIELDS, split))
    return 1000.0 * (f[("device_wait", "s")]) / obs["run_zmws"]
