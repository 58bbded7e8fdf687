"""The benchmark's own tests: CPU checks of its files, its reference and
its import rules, and (marked ``cuda``) short runs of each cell on the
card.  Not collected by the repository's ``pytest tests/``.

Run:  ``python -m pytest portbench/tests -q``  (from the repo root; the
``cuda`` tests skip without a card)
"""

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the CUDA kernels")
    return torch.device("cuda")
