def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card; skips where torch sees none "
        "(run on the card: python -m pytest -q -m cuda tests/test_torch_*.py)",
    )
