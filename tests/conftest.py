"""Test configuration: run on a virtual 8-device CPU mesh.

Mirrors the reference's strategy of testing distributed logic without a
cluster (SURVEY.md §4): a single code path that runs identically on CPU
(jit on 1 device) and on a sharded mesh, exercised here via
`--xla_force_host_platform_device_count=8`.

Note: pytest plugins may import jax before this file runs, so the platform
is forced through `jax.config` (still honored until the backend
initializes) in addition to the env vars.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# Force CPU: the ambient environment may point JAX at a TPU platform, but
# the test suite is designed for a deterministic virtual 8-device CPU mesh.
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "tpu: needs the real TPU chip (runs subprocesses that claim it); "
        "skipped unless RTPU_TPU_TESTS=1",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skips when torch.cuda.is_available() "
        "is false",
    )


def pytest_collection_modifyitems(config, items):
    if os.environ.get("RTPU_TPU_TESTS") == "1":
        return
    skip = pytest.mark.skip(
        reason="TPU-hardware test; set RTPU_TPU_TESTS=1 to run "
        "(tools/release_test.sh does when a chip is reachable)"
    )
    for item in items:
        if "tpu" in item.keywords:
            item.add_marker(skip)
