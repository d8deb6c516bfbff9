import os
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration tests")
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def run_multi_rank():
    """Run a Python script in a subprocess with N virtual CPU devices.

    The repo convention for multi-rank CPU tests (since the PR-1
    ``publish_and_fill`` equivalence test): the main pytest process stays
    single-device, and anything needing a mesh forces
    ``XLA_FLAGS=--xla_force_host_platform_device_count=N`` in a fresh
    interpreter BEFORE jax is imported (the flag is read once at backend
    initialisation). The fixture injects the flag and ``PYTHONPATH=src``,
    asserts a zero exit status (stdout+stderr on failure), and returns the
    script's stdout so callers can assert on printed markers.
    """

    def run(script: str, num_devices: int = 2, timeout: int = 600) -> str:
        env = dict(
            os.environ,
            PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
            XLA_FLAGS=(
                f"--xla_force_host_platform_device_count={num_devices}"
            ),
        )
        proc = subprocess.run(
            [sys.executable, "-c", script],
            capture_output=True,
            text=True,
            env=env,
            timeout=timeout,
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
        return proc.stdout

    return run
