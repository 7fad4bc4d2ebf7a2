"""chip_smoke.py, the on-card proof: it refuses to run without a GPU, and
its golden and exactness phases run as a card test."""

import importlib.util
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def test_chip_smoke_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "platform 'cpu'" in out.stderr
    assert '"ok"' not in out.stdout


@pytest.mark.card
def test_golden_and_exact_phases_on_card():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.phase_goldens()
    smoke.phase_exact()
