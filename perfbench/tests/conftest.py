"""The benchmark's own tests: `python -m pytest perfbench/tests -q` from the repository root.

Tests that need a CUDA card carry the `cuda` marker and decide inside the
test whether there is one."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")
