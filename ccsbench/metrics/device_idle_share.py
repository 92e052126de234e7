"""Share of the traced sub-window in which no device activity ran, in
percent: 1 - (union of device activity intervals) / span, averaged over
the cards used."""


def read(obs):
    p = obs.get("profile")
    if not p or not p["busy_s"] or p["window_s"] <= 0:
        return None
    n = obs.get("n_devices") or len(p["busy_s"])
    busy = sum(p["busy_s"].values()) / n
    return 100.0 * (1.0 - busy / p["window_s"])
