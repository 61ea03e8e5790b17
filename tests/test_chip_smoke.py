"""chip_smoke.py must refuse to report anything without a GPU: a non-zero
exit and no JSON result line, both on a CPU backend and when copied away
from the checkout it belongs to."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("where", ["checkout", "lone_copy"])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    script = os.path.join(ROOT, "chip_smoke.py")
    if where == "lone_copy":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "FAILED" in out.stderr
