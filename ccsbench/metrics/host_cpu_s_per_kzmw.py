"""Host CPU seconds (user + system, this process and its prepare workers,
from /proc) spent over the window, per 1000 ZMWs written in it."""


def read(obs):
    w = obs["window"]
    return 1000.0 * (w["cpu1"] - w["cpu0"]) / (w["z1"] - w["z0"])
