def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips inside the test without one)"
    )
