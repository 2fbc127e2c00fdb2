"""Shared fixtures. NOTE: no XLA_FLAGS / device-count manipulation here —
the dry-run launcher is the only place that forces 512 host devices; tests
run on the default single device (multi-device behaviour is exercised via
subprocess tests in test_distributed.py).
"""
import numpy as np
import pytest


@pytest.fixture(scope="session")
def wisconsin_small():
    from repro.data import wisconsin

    t = wisconsin.generate(10_000, seed=1)
    raw = {k: np.asarray(v) for k, v in t.columns.items()}
    return t, raw


@pytest.fixture(scope="session")
def session_with_data(wisconsin_small):
    from repro.engine.session import Session

    t, raw = wisconsin_small
    sess = Session()
    sess.create_dataset("Data", t, dataverse="demo",
                        indexes=["onePercent", "unique1"], primary="unique2")
    return sess, raw


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips elsewhere "
        "(run on the card with -m cuda)")
