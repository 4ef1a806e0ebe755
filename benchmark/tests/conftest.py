"""CPU tests of the benchmark: ``python -m pytest benchmark/tests -q``.

Tests that need an NVIDIA card are marked ``cuda`` and decide inside the
test whether there is one; here on the CPU they skip."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skipped without one")
