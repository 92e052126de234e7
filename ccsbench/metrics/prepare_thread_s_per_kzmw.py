"""Host prepare (filters, draft, windows) in worker thread-seconds per
1000 ZMWs: the engine's t_prepare from the CLI's 'wall split' line, over
the whole measured run (fill and drain included)."""


def read(obs):
    split = obs.get("wall_split")
    if not split:
        return None
    return 1000.0 * split[0] / obs["run_zmws"]
