"""The ``gpu`` marker for the benchmark's tests that need a CUDA card
(each decides inside itself whether one is present)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; the test skips itself when "
        "torch.cuda.is_available() is False")
