"""cmpcbench's tests: ``python -m pytest -q cmpcbench/tests`` from the
root of the repository (CPU), and ``python -m pytest -q -m cuda
cmpcbench/tests`` on a machine with a CUDA card."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
