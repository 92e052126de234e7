"""The sparse scorer kernel's share of its roofline: the bound (operations
over the float32 peak, or bytes over HBM bandwidth, ccsbench/frozen/
scorer_batch.py) over the kernel's device time per launch on the frozen
production batch (ccsbench/roofline.py), in percent."""


def read(obs):
    r = obs.get("roofline")
    if not r or not r["ms"]:
        return None
    return 100.0 * r["bound_ms"] / r["ms"]
