"""Seconds the engine spends in the polish step (a chunk in flight) per
1000 ZMWs: t_device from the CLI's 'wall split' line, whole run."""


def read(obs):
    split = obs.get("wall_split")
    if not split:
        return None
    return 1000.0 * split[1] / obs["run_zmws"]
