"""`setup_device`'s pinning of CUBLAS_WORKSPACE_CONFIG, on the CPU.

cuBLAS reads the variable when it creates its handle, so a pin that
comes after CUDA is initialised may not take. `setup_device` raises then,
unless the variable already holds the pinned value; before CUDA's
initialisation it pins it. `torch.cuda.is_initialized` is monkeypatched:
this host has no card.
"""
from __future__ import annotations

import pytest
import torch

from arbius_tpu_torch.utils import platform


@pytest.fixture
def cuda_initialised(monkeypatch):
    def set_state(initialised: bool) -> None:
        monkeypatch.setattr(torch.cuda, "is_initialized",
                            lambda: initialised)
    return set_state


@pytest.mark.parametrize("value", [None, ":16:8", ""])
def test_late_call_without_the_pinned_value_raises(monkeypatch,
                                                   cuda_initialised, value):
    cuda_initialised(True)
    if value is None:
        monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    else:
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", value)
    with pytest.raises(RuntimeError, match="already initialised"):
        platform.setup_device("cpu")
    assert platform.os.environ.get("CUBLAS_WORKSPACE_CONFIG") == value


def test_late_call_with_the_pinned_value_passes(monkeypatch,
                                                cuda_initialised):
    cuda_initialised(True)
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    assert platform.setup_device("cpu") == torch.device("cpu")
    assert torch.are_deterministic_algorithms_enabled()


@pytest.mark.parametrize("value", [None, ":16:8"])
def test_call_before_cuda_pins_the_value(monkeypatch, cuda_initialised,
                                         value):
    cuda_initialised(False)
    if value is None:
        monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    else:
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", value)
    assert platform.setup_device("cpu") == torch.device("cpu")
    assert platform.os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    assert platform.CUBLAS_WORKSPACE == ":4096:8"


def test_cuda_asked_for_without_a_card_raises(monkeypatch,
                                              cuda_initialised):
    cuda_initialised(False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        platform.setup_device("cuda")
