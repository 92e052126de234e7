"""The one traffic generator: a traffic file's parameters and a seed in, a
pool of simulated ZMWs and subreads BAMs that repeat it out.

A traffic file (``ccsbench/traffic/<name>.json``) holds:

- ``insert_len``: bases of each insert;
- ``passes``: full passes; the pool's members take the values of this list
  in turn, so every seed gets the same multiset, in another order;
- ``snr``: the ZMWs' mean SNR;
- ``kinetics`` (absent: false): every subread carries ``pw`` (pulse widths
  the simulator draws with its read) and ``ip`` (IPD codes drawn uniform
  in 4-59, as the port's ``write_subreads_bam`` draws them, from a stream
  of the seed of their own, so that without kinetics nothing else moves);
- ``pool_zmws``: distinct ZMWs simulated per run (the BAM repeats them
  under fresh hole numbers; the program keeps no state across ZMWs);
- ``batch_zmws``: the run's ``--batch-size``;
- ``fill_batches``: batches written before the window opens;
- ``warmup_batches``: batches of the warm-up run that sizes the file;
- ``trace_seconds``: length of the device trace in a ``--trace 1`` run.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ccsbench import bamio
from ccsbench.frozen import sim

SEED_MOD = 1 << 64


def load(root: str, name: str) -> dict:
    with open(os.path.join(root, "ccsbench", "traffic", name + ".json")) as fh:
        return json.load(fh)


def _rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng([seed % SEED_MOD, *key])


def make_pool(traffic: dict, seed: int) -> list:
    """The pool's simulated ZMWs (``sim.SimZmw``), member i from its own
    stream of the seed."""
    n = int(traffic["pool_zmws"])
    passes = [int(p) for p in traffic["passes"]]
    cycle = np.array([passes[i % len(passes)] for i in range(n)])
    order = _rng(seed, 0).permutation(n)
    params = sim.default_params()
    kinetics = bool(traffic.get("kinetics", False))
    pool = [sim.simulate_zmw(i, int(traffic["insert_len"]),
                             int(cycle[order[i]]), params=params,
                             rng=_rng(seed, 1, i), snr=float(traffic["snr"]),
                             with_pw=kinetics)
            for i in range(n)]
    if kinetics:
        for i, z in enumerate(pool):
            rng = _rng(seed, 2, i)
            z.ipds = [rng.integers(4, 60, len(r)).astype(np.uint8)
                      for r in z.subreads]
    return pool


def pool_parts(pool: list) -> list:
    return [bamio.zmw_record_parts(z) for z in pool]


def write_bam(path: str, parts: list, n_zmws: int,
              first: int = 0) -> tuple[dict, list[int]]:
    """A subreads BAM (+ .pbi) of ``n_zmws`` ZMWs, the pool's members in
    turn from member ``first % len(pool)``; returns ({hole: member} in
    file order, the file offset at which each ZMW ends)."""
    holes = {bamio.HOLE_BASE + k: (first + k) % len(parts)
             for k in range(n_zmws)}
    ends = bamio.write_subreads(path, parts, holes.items())
    return holes, ends
