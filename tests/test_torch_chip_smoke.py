"""chip_smoke.py refuses to report a result where it cannot drive the
port on a GPU: without CUDA, and alone without the repository."""
import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _run(script, cwd):
    return subprocess.run([sys.executable, script], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _run(SCRIPT, tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no CUDA device" in res.stderr


def test_fails_alone_without_the_repository(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SCRIPT, alone)
    res = _run(str(alone), tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
