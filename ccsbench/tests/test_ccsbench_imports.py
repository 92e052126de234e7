"""No module that a run loads is JAX, jaxlib, flax or the JAX package,
compared by whole top-level name (ccs_tpu_torch starts with ccs_tpu)."""

from __future__ import annotations

import os
import subprocess
import sys

from ccsbench import run
from ccsbench.tests import tiny


def test_whole_name_comparison(monkeypatch):
    fake = {"ccs_tpu_torch": 1, "ccs_tpu_torch.cli": 1, "jaxtyping": 1,
            "ccs_tpux": 1}
    monkeypatch.setattr(sys, "modules", fake)
    assert run.forbidden_modules() == []
    fake.update({"jax.numpy": 1, "ccs_tpu.pipeline": 1, "flax": 1,
                 "jaxlib": 1})
    assert run.forbidden_modules() == ["ccs_tpu.pipeline", "flax", "jax.numpy",
                                       "jaxlib"]


_MEASURED = r"""
import sys, tempfile
sys.path.insert(0, {repo!r})
from ccsbench import harness, run
from ccsbench.tests import tiny

if __name__ == "__main__":
    bench = tiny.make_root(tempfile.mkdtemp())
    res = harness.run_cell(bench, "tiny", 8, 1.0, False, tempfile.mkdtemp(),
                           devices=["cpu"], log=lambda m: None)
    harness.metrics_of(bench, "tiny", False, res["obs"])
    harness.metrics_of(bench, "tiny", True, res["obs"])
    print("FORBIDDEN", run.forbidden_modules(), res["correct"])
"""


def test_a_measured_process_loads_no_jax(tmp_path):
    """A whole run of the harness, in a fresh interpreter, leaves no JAX
    module behind."""
    script = tmp_path / "measured.py"
    script.write_text(_MEASURED.format(repo=tiny.REPO))
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, cwd=str(tmp_path), timeout=600,
                       env=dict(os.environ, PYTHONPATH=tiny.REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "FORBIDDEN [] True" in r.stdout
