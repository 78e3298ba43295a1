"""Test configuration.

Runs the whole suite on the CPU with 8 virtual devices, so the multi-device
sharding logic is testable without GPUs (SURVEY §4 distributed-testing
note), and enables x64 so fp64 — the reference's primary precision — is
exact.  Must run before the first ``import jax`` anywhere in the tests.

Tests that need an NVIDIA GPU take the ``gpu`` fixture and carry the
``gpu`` marker; they skip here and run on a card with
``python -m pytest tests/ -m gpu -p no:cacheprovider`` (with
``SPGPU_TEST_PLATFORM=gpu``, which leaves the platform to JAX).
"""

import os

if os.environ.get("SPGPU_TEST_PLATFORM") != "gpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


# Heavy tests (>~6 s each, measured full-suite durations r4) — the full
# suite runs ~17 min; `pytest -m "not slow"` keeps a ~5-minute core
# loop (VERDICT r3 weak #8).  Parametrized variants share the base id.
_SLOW = {
    "test_bench_harness.py::test_run_suite_small",
    "test_overlap.py::test_weak_scaling_rows",
    "test_io.py::test_bench_mtx_pipeline",
    "test_io.py::test_bench_mtx_complex",
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: heavy test (full suite only; deselect with "
        "-m 'not slow' for the ~5-minute core loop)")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere; see the "
        "module docstring)")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX platform is "
                    f"{devs[0].platform!r})")
    return devs[0]


def pytest_collection_modifyitems(config, items):
    for it in items:
        base = it.nodeid.split("/")[-1].split("[")[0]
        if base in _SLOW:
            it.add_marker(pytest.mark.slow)


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    """Drop compiled executables between test modules.

    A full one-process suite run accumulates hundreds of live XLA:CPU
    executables; past ~200 compilations the CPU backend has segfaulted
    INSIDE a later compile (observed repeatedly at different tests in
    jax 0.x backend_compile_and_load — every affected module passes in
    isolation).  Releasing the jit caches per module keeps the live-
    executable population small; costs a few re-compiles of shared
    helpers."""
    yield
    jax.clear_caches()
