def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (CUDA kernels of the PyTorch port); skips "
        "without one")
