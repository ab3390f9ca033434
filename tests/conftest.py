def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the PyTorch port's kernel tests); skips without one")
