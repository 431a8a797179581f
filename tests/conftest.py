import os

# The unit tests run on a virtual 8-device CPU mesh: sharding tests need
# several devices, and a test run must never reserve an accelerator's memory.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# NB: jax_enable_x64 stays OFF so tests exercise the same f32/bf16 numerics as
# production; the NumPy reference implementations use float64 independently.


import pytest  # noqa: E402


# Quick tier (`pytest -m quick`, target <5 min): a green signal for reviewers
# without the full compile-bound suite. Whole modules that are cheap, plus one
# interpret-mode parity test for the Pallas kernel.
_QUICK_MODULES = {
    "test_sampling.py",
    "test_vocoder.py",
    "test_talker.py",
    "test_io.py",
    "test_goldens.py",
}
_QUICK_TESTS = {
    ("test_pallas_attention.py", "test_matches_xla_reference"),
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        fname = os.path.basename(str(item.fspath))
        base = item.name.split("[")[0]
        if fname in _QUICK_MODULES or (fname, base) in _QUICK_TESTS:
            item.add_marker(pytest.mark.quick)


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_programs_between_modules():
    """Free compiled executables after each test module.

    The full suite compiles several hundred XLA:CPU programs in one process;
    around program ~120 the compiler segfaults deterministically
    (backend_compile_and_load, LLVM JIT) unless earlier executables are
    released. Each module recompiles what it needs; shapes differ across
    modules anyway, so the lost cache hits are minimal."""
    yield
    jax.clear_caches()
