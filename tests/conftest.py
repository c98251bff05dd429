def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running integration tests (subprocess runs)"
    )
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips inside the test without one)"
    )
