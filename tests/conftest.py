"""Test config: JAX on a virtual 8-device CPU platform.

The suite is hermetic on the CPU, so sharding logic runs on the
--xla_force_host_platform_device_count mesh.  Tests marked `gpu` need a
card and skip without one; run them on a machine with a GPU with
EASYAV1_TEST_PLATFORM=gpu python -m pytest tests -m gpu
"""

import os

# the JAX platform the tests run on ("cpu" unless EASYAV1_TEST_PLATFORM
# names another, e.g. "gpu" on a machine with a card)
_PLATFORM = os.environ.get("EASYAV1_TEST_PLATFORM", "cpu")

os.environ["JAX_PLATFORMS"] = _PLATFORM
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# device-kernel tests are dominated by XLA compiles; the persistent
# cache makes repeat runs pay only for the compute
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.1")

import sys

sys.path.insert(0, _repo)

import jax  # noqa: E402

from easyav1.utils import compile_cache  # noqa: E402

# a platform already set in jax's config (at its import) gives way to
# the one chosen above
jax.config.update("jax_platforms", _PLATFORM)
compile_cache.enable()

import pytest  # noqa: E402

# Device-kernel tests are marked slow (first run pays XLA
# compiles).  The default selection skips them for a fast signal;
# `pytest -m ""` (or -m slow) runs everything — see pyproject addopts.
SLOW_FILES = {
    "test_cdef_jax.py", "test_fg_jax.py",
    "test_lf_jax.py", "test_lr_jax.py",
    "test_device_bridge.py", "test_device_trace.py",
    "test_graft_entry.py",
}
# compile-heaviest device files: a second tier so `-m slow` stays a
# <5 min slice on this host (measured: itx_jax ~11 min, mc_jax ~6 min,
# multistream ~2 min with a warm .jax_cache)
XSLOW_FILES = {
    "test_itx_jax.py", "test_mc_jax.py", "test_multistream.py",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        base = os.path.basename(str(item.fspath))
        if base in SLOW_FILES:
            item.add_marker(pytest.mark.slow)
        elif base in XSLOW_FILES:
            item.add_marker(pytest.mark.slow)
            item.add_marker(pytest.mark.xslow)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Tests marked `gpu` run only where JAX's first device is a GPU;
    decided here, per test, so every worker collects the same tests."""
    if request.node.get_closest_marker("gpu") is not None:
        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs a GPU (run with EASYAV1_TEST_PLATFORM=gpu "
                        "on a machine with a card)")
