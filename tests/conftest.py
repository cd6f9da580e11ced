"""Registers the marker of tests that need an NVIDIA card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card with the CUDA toolkit (skips without one); "
        "run with `PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py`",
    )
