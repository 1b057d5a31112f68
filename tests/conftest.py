"""Test configuration: run on a simulated 8-device CPU mesh.

Multi-device sharding is validated without accelerators by forcing the host
platform to expose 8 virtual devices (the JAX analogue of a fake backend;
see SURVEY.md section 4, item 4). Must run before jax is imported.
"""

import os

# Force CPU: unit tests run on the virtual 8-device CPU mesh, whatever
# accelerator the machine has.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Installed pytest plugins (jaxtyping) import jax BEFORE this conftest runs, so
# the env var alone is too late; the config update below still takes effect
# because no backend has been initialized yet at collection time.
import jax

jax.config.update("jax_platforms", "cpu")


import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import pytest  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def gpu():
    """For tests marked ``gpu``: skip unless an NVIDIA GPU is visible, else
    return ``run(code)``, which runs Python code in a child process on the
    GPU (this process's JAX stays on the CPU) and fails the test on a
    nonzero exit. Decided here, at run time, never at import."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True,
                                     timeout=60).returncode != 0:
        pytest.skip("needs an NVIDIA GPU")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}

    def run(code: str) -> str:
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=1200)
        assert out.returncode == 0, out.stdout + out.stderr
        return out.stdout

    return run
