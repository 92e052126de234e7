"""Helpers of the CLI twins (tests/test_torch_cli_*.py): the JAX package's
CLI and the port's (``cli.run(..., device="cpu")``) on the same input, and
the comparison of everything a run writes.

Each package runs in a directory of its own with the same relative
arguments, so both write the same @PG command line. Both run with 64-window
chunks in place of the default 256 (a window's result does not depend on
its chunk, in either package): the CPU polishes the padding rows too. Bars (the engine's):
records equal in name, sequence, binned QVs and every tag, floats (rq, ec)
within 1e-3; text reports equal; JSON reports and per-ZMW metrics equal up
to 1e-3 on floats; .pbi equal apart from the BGZF offsets (a record's
compressed bytes follow its rq bits) and rq within 1e-3; dataset XML equal
apart from its time stamps and random ids."""

from __future__ import annotations

import contextlib
import dataclasses
import gzip
import json
import os
import re
from unittest import mock

import numpy as np

import ccs_tpu.cli as jax_cli
from ccs_tpu_torch import cli
from ccs_tpu_torch.io.bam import BamReader
from ccs_tpu_torch.io.pbi import read_pbi

TOL = 1e-3
CLIS = {"jax": jax_cli, "port": cli}
CHUNK_WINDOWS = (64,)


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def run_in(root, pkg: str, argv) -> str:
    """One CLI run of ``pkg`` ("jax" or "port") inside root/pkg, where
    ``argv`` names its files relative to that directory (the input as
    ../../in.subreads.bam for an input beside root); returns the
    directory."""
    d = os.path.join(str(root), pkg)
    os.makedirs(d, exist_ok=True)
    mod = CLIS[pkg]
    config_from_args = mod.config_from_args

    def small_chunks(args):
        return dataclasses.replace(config_from_args(args),
                                   tpu_window_buckets=CHUNK_WINDOWS)

    with _cwd(d), mock.patch.object(mod, "config_from_args", small_chunks):
        rc = (mod.run(list(argv)) if pkg == "jax"
              else mod.run(list(argv), device="cpu"))
    assert rc == 0, (pkg, argv)
    return d


def run_both(root, argv) -> tuple[str, str]:
    return run_in(root, "jax", argv), run_in(root, "port", argv)


def _plain(v):
    if isinstance(v, (bytes, bytearray)):
        return bytes(v)
    if isinstance(v, (np.ndarray, np.generic)):
        return v.tolist()
    return v


def bam_rows(path: str) -> list[dict]:
    """Every record as {name, seq, qual, tag: value}, in file order."""
    with BamReader(path) as r:
        return [dict(name=rec.name, seq=rec.seq.tobytes(),
                     qual=None if rec.qual is None else rec.qual.tobytes(),
                     **{k: _plain(tv.value) for k, tv in rec.tags.items()})
                for rec in r]


def assert_close(a, b, where: str):
    """Equal, floats within TOL, recursively."""
    if isinstance(a, float) or isinstance(b, float):
        assert abs(float(a) - float(b)) <= TOL, (where, a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), (where, sorted(a), sorted(b))
        for k in a:
            assert_close(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (where, len(a), len(b))
        for i, (u, v) in enumerate(zip(a, b)):
            assert_close(u, v, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


def assert_bams_match(path_j: str, path_t: str) -> list[dict]:
    rows_j, rows_t = bam_rows(path_j), bam_rows(path_t)
    assert [r["name"] for r in rows_j] == [r["name"] for r in rows_t]
    for a, b in zip(rows_j, rows_t):
        assert_close(a, b, a["name"])
    return rows_t


def assert_pbis_match(path_j: str, path_t: str):
    a, b = read_pbi(path_j), read_pbi(path_t)
    for f in ("rg_id", "q_start", "q_end", "hole_number", "ctxt_flag"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    np.testing.assert_allclose(a.read_qual, b.read_qual, atol=TOL)
    assert len(a.file_offset) == len(b.file_offset)


def metrics(path: str) -> dict:
    with gzip.open(path, "rt") as fh:
        return json.load(fh)


def xml_text(path: str) -> str:
    with open(path) as fh:
        text = fh.read()
    text = re.sub(r'(CreatedAt|UniqueId)="[^"]*"', r'\1=""', text)
    return re.sub(r'TimeStampedName="[^"]*"', 'TimeStampedName=""', text)


def read(path: str) -> str:
    with open(path) as fh:
        return fh.read()


def assert_outputs_match(dj: str, dt: str, prefix: str):
    """The BAM, .pbi, fail_reads.bam, ccs_report.txt and
    zmw_metrics.json.gz a run with output ``prefix``.bam writes, wherever
    the JAX run wrote them; returns the port's records."""
    rows = assert_bams_match(os.path.join(dj, prefix + ".bam"),
                             os.path.join(dt, prefix + ".bam"))
    assert_pbis_match(os.path.join(dj, prefix + ".bam.pbi"),
                      os.path.join(dt, prefix + ".bam.pbi"))
    fail = prefix + ".fail_reads.bam"
    assert os.path.exists(os.path.join(dt, fail))
    assert_bams_match(os.path.join(dj, fail), os.path.join(dt, fail))
    compare_reports(dj, dt, prefix)
    return rows


def compare_reports(dj: str, dt: str, prefix: str):
    """ccs_report.txt and zmw_metrics.json.gz, where the JAX run wrote
    them (and then the port must have too)."""
    rep = prefix + ".ccs_report.txt"
    if os.path.exists(os.path.join(dj, rep)):
        assert read(os.path.join(dj, rep)) == read(os.path.join(dt, rep))
    met = prefix + ".zmw_metrics.json.gz"
    if os.path.exists(os.path.join(dj, met)):
        assert_close(metrics(os.path.join(dj, met)),
                     metrics(os.path.join(dt, met)), met)
