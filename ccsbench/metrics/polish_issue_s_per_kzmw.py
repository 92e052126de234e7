"""Seconds the host spends issuing the polish loop per 1000 ZMWs: the
device step's self time, ``device_step`` less its ``h2d``, ``sync`` and
``pull`` children, from the CLI's 'wall split' line, whole run."""


def read(obs):
    try:
        from ccs_tpu_torch.telemetry import WALL_SPLIT_FIELDS
    except ImportError:             # a program without the spans
        return None
    split = obs.get("wall_split")
    if not split or len(split) != len(WALL_SPLIT_FIELDS):
        return None
    f = dict(zip(WALL_SPLIT_FIELDS, split))
    issue = (f[("device_step", "s")] - f[("h2d", "s")] - f[("sync", "s")]
             - f[("pull", "s")])
    return 1000.0 * issue / obs["run_zmws"]
