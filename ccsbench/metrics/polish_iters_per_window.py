"""Polish loop iterations per window polished: the engine's
``polish_iterations`` counter (each window's iterations, summed) over its
``windows_polished``, from the CLI's 'wall split' line, whole run."""


def read(obs):
    try:
        from ccs_tpu_torch.telemetry import WALL_SPLIT_FIELDS
    except ImportError:             # a program without the spans
        return None
    split = obs.get("wall_split")
    if not split or len(split) != len(WALL_SPLIT_FIELDS):
        return None
    f = dict(zip(WALL_SPLIT_FIELDS, split))
    n = f[("windows_polished", "windows")]
    return f[("polish_iterations", "iterations")] / n if n else None
