"""Seconds the device-issuing thread waits for room in the writer's queue
per 1000 ZMWs: the ``handoff_wait`` span's total from the CLI's 'wall
split' line, whole run."""


def read(obs):
    try:
        from ccs_tpu_torch.telemetry import WALL_SPLIT_FIELDS
    except ImportError:             # a program without the spans
        return None
    split = obs.get("wall_split")
    if not split or len(split) != len(WALL_SPLIT_FIELDS):
        return None
    f = dict(zip(WALL_SPLIT_FIELDS, split))
    return 1000.0 * (f[("handoff_wait", "s")]) / obs["run_zmws"]
