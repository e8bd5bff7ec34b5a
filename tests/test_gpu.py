"""GPU tier: the device path on a real NVIDIA GPU.

Marked `gpu` and skipped where no GPU is present. On a machine with a
card, run it with

    python -m pytest -m gpu tests/test_gpu.py

which drives chip_smoke.py (kernel parity at real widths, the golden
CLI run and a reduced flagship run) in a subprocess that keeps the
machine's GPU platform.
"""
import json
import os
import shutil
import subprocess
import sys

import pytest

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def gpu_env():
    """Environment of a child process that may use the GPU; skips the
    test when the machine has none."""
    if shutil.which("nvidia-smi") is None or subprocess.run(
            ["nvidia-smi", "-L"], capture_output=True).returncode != 0:
        pytest.skip("no NVIDIA GPU on this machine")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)          # undo the conftest CPU pin
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "host_platform_device_count" not in f)
    return env


def test_chip_smoke_passes(gpu_env):
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py"),
                        "--copies", "40"], env=gpu_env, capture_output=True,
                       text=True, timeout=1500, cwd=REPO)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
