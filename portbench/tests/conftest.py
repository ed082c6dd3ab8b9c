"""The benchmark's own CPU tests: ``python -m pytest portbench/tests -q``
from the root of the repository.  The harness's folder and the root go on
``sys.path`` as ``portbench/run.py`` puts them."""
import os
import sys

import pytest
import torch

# several test workers share the machine's cores
torch.set_num_threads(2)

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return "cuda"
