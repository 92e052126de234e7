"""Host reads that wait on the card inside the device step (``sync``
spans: the polish loop's condition, compaction, the DC stage's check) per
1000 ZMWs, from the CLI's 'wall split' line, whole run."""


def read(obs):
    try:
        from ccs_tpu_torch.telemetry import WALL_SPLIT_FIELDS
    except ImportError:             # a program without the spans
        return None
    split = obs.get("wall_split")
    if not split or len(split) != len(WALL_SPLIT_FIELDS):
        return None
    f = dict(zip(WALL_SPLIT_FIELDS, split))
    return 1000.0 * (f[("sync", "calls")]) / obs["run_zmws"]
