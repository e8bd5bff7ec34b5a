import os
import tarfile

# Force a virtual 8-device CPU mesh for all tests (device-independent
# CI) — must happen before jax import anywhere.
os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pytest  # noqa: E402

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = "/root/reference/examples"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped on the CPU. "
        "`python chip_smoke.py` runs the same checks on the card")


@pytest.fixture(scope="session")
def golden(tmp_path_factory):
    """Unpack the reference-produced golden run (tests/golden_run.tar.gz).

    Layout: <dir>/run/{result.tsv, targets*, query*, tmp/...} as produced
    by util/run_regression.sh of the reference.
    """
    tar = os.path.join(TESTS_DIR, "golden_run.tar.gz")
    if not os.path.exists(tar):
        pytest.skip("golden_run.tar.gz not present")
    dest = tmp_path_factory.mktemp("golden")
    with tarfile.open(tar) as tf:
        tf.extractall(dest)
    return os.path.join(dest, "run")


@pytest.fixture(scope="session")
def examples_dir():
    if not os.path.isdir(EXAMPLES):
        pytest.skip("reference examples not available")
    return EXAMPLES
