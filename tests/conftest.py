"""Test environment: force the CPU backend with 8 virtual devices so
sharding tests run without several cards (SURVEY.md §4.4).

Tests marked ``gpu`` need a card. They start their own process, which
leaves the CPU setting below behind, and skip where ``nvidia-smi`` finds
no card or under xdist: one process per card, since each JAX process
reserves most of the card's memory. On the card, run them alone:
``python -m pytest tests/ -m gpu``."""

import os
import shutil
import subprocess

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

# Set the config as well as the environment: it wins over any platform
# list set before this file ran (backends initialize on first use).
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")


def _gpu_skip_reason() -> str | None:
    if os.environ.get("PYTEST_XDIST_WORKER"):
        return "gpu tests never run under xdist (one process per card)"
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "no GPU: nvidia-smi not found"
    try:
        out = subprocess.run([smi, "-L"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"no GPU: nvidia-smi failed ({e})"
    if out.returncode != 0 or "GPU" not in out.stdout:
        return "no GPU: nvidia-smi lists no card"
    return None


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip a `gpu`-marked test where it cannot have a card to itself.
    Decided per test, never at import or collection, so that every xdist
    worker collects the same tests."""
    if request.node.get_closest_marker("gpu"):
        reason = _gpu_skip_reason()
        if reason:
            pytest.skip(reason)
