import pytest
import torch

from portbench.reference import plain


@pytest.fixture(autouse=True)
def cpu_adam(monkeypatch):
    # the program's Adam runs on the CPU here, where torch takes its bias
    # corrections in float64 (the card's capturable Adam, in float32)
    monkeypatch.setattr(plain, "BIAS_CORRECTION_DTYPE", torch.float64)
