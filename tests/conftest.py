import numpy as np
import pytest

# NOTE: tests must see the real single CPU device — never set
# xla_force_host_platform_device_count here (multi-device tests use
# subprocesses; see test_ft.py / test_distributed.py).


@pytest.fixture(scope="session")
def lif_dataset():
    from repro.core.dataset import TestbenchConfig, build_dataset
    return build_dataset("lif", TestbenchConfig(n_runs=150, n_steps=80, seed=1))


@pytest.fixture(scope="session")
def crossbar_dataset():
    from repro.core.dataset import TestbenchConfig, build_dataset
    return build_dataset("crossbar",
                         TestbenchConfig(n_runs=80, n_steps=80, seed=2))


@pytest.fixture(scope="session")
def lif_bank(lif_dataset):
    """Cheap bank (mean+linear) — enough for wrapper-semantics tests."""
    from repro.core.predictors import PredictorBank
    return PredictorBank("lif", families=("mean", "linear")).fit(lif_dataset)


@pytest.fixture(scope="session")
def lif_bank_mlp(lif_dataset):
    """Quality bank for accuracy-threshold tests."""
    from repro.core.predictors import PredictorBank
    return PredictorBank("lif", families=("linear", "mlp")).fit(lif_dataset)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skipped without one); on the "
        "card `python -m pytest -q -m cuda tests/test_torch_gbdt_walk.py`")
