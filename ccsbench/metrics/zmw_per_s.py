"""ZMWs written per second over the window: the ZMW count between the
progress lines that open and close it, over the time between them."""


def read(obs):
    w = obs["window"]
    return (w["z1"] - w["z0"]) / (w["t1"] - w["t0"])
