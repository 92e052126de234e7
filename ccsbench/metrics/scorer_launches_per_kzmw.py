"""Scorer kernel launches (sparse + dense, the program's launch counters)
per 1000 ZMWs over the whole measured run."""


def read(obs):
    n = obs["launches"]["sparse"] + obs["launches"]["dense"]
    return 1000.0 * n / obs["run_zmws"] if n else None
