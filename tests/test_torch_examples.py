"""The port's four examples (``examples/torch_*.py``) run on the CPU at
small sizes, each in a subprocess, and print their own check."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(script: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                          "--device", "cpu", *args], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


@pytest.mark.parametrize("script,args,check", [
    ("torch_quickstart.py", ("--n", "65536"), "quickstart check: OK"),
    ("torch_serve_batch.py", ("--requests", "3", "--max-new", "4"),
     "serve_batch check: OK"),
    ("torch_serve_batch.py", ("--arch", "mamba2-1.3b", "--scheduler", "wave",
                              "--requests", "3", "--max-new", "4",
                              "--arrival-rate", "50"),
     "serve_batch check: OK"),
    ("torch_ssd_long_context.py", ("--seq", "4096"),
     "ssd_long_context check: OK")])
def test_example_runs_on_cpu(script, args, check):
    assert check in _run(script, *args)


def test_train_lm_checkpoints_and_resumes(tmp_path):
    """Four steps and a checkpoint, then a second run resumes from it."""
    common = ("--config", "smoke", "--batch", "2", "--seq", "32",
              "--ckpt-every", "2", "--ckpt-dir", str(tmp_path))
    first = _run("torch_train_lm.py", "--steps", "4", *common)
    assert "train_lm check: OK" in first and "resumed" not in first
    second = _run("torch_train_lm.py", "--steps", "6", *common)
    assert "resumed from step 4" in second
    assert "train_lm check: OK (losses finite, checkpoint at step 6)" in \
        second
