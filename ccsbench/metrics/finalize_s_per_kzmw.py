"""Seconds of host stitch and finalize per 1000 ZMWs: t_finalize from the
CLI's 'wall split' line, whole run."""


def read(obs):
    split = obs.get("wall_split")
    if not split:
        return None
    return 1000.0 * split[3] / obs["run_zmws"]
