import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_multidev(code: str, n_devices: int = 8) -> str:
    """Run `code` in a subprocess with n host devices (keeps this process at 1)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise AssertionError(f"subprocess failed:\nSTDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}")
    return r.stdout


@pytest.fixture
def multidev():
    return run_multidev


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (and nvcc to build the port's "
                   "kernels); skipped without one")
