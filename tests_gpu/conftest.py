"""Card-only tests of the PyTorch / CUDA port.

Unlike ``tests/`` (CPU, with jax as the reference), this suite imports no
jax: it holds each CUDA kernel against its plain PyTorch version on the
card.  Every test skips without a CUDA device.

Run:  ``python -m pytest tests_gpu/ -q``  (from the repo root, on the GPU
machine; builds the kernels with nvcc at first use)
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")
