"""Registers the marker of the tests that need the card; each such test
decides inside itself whether there is one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")
