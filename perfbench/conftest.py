"""The marker of the benchmark's tests that need a card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips where "
        "torch.cuda.is_available() is False)")
