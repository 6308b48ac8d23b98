"""Shared pytest settings: registers the ``cuda`` marker."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card with the CUDA toolkit; the "
        "test skips itself where there is none")
