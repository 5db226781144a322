"""The benchmark's own tests (`python -m pytest rxbench/tests -q`): CPU
runs of the harness at a small mode, and tests of its parts.  They import
neither JAX nor the JAX package."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
