"""Seconds the device-issuing thread waits for prepared batches per 1000
ZMWs: the ``prepare_wait`` span's total (the main thread's wait on the
prepare queue and the pool's futures) from the CLI's 'wall split' line,
whole run."""


def read(obs):
    try:
        from ccs_tpu_torch.telemetry import WALL_SPLIT_FIELDS
    except ImportError:             # a program without the spans
        return None
    split = obs.get("wall_split")
    if not split or len(split) != len(WALL_SPLIT_FIELDS):
        return None
    f = dict(zip(WALL_SPLIT_FIELDS, split))
    return 1000.0 * (f[("prepare_wait", "s")]) / obs["run_zmws"]
