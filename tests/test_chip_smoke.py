"""chip_smoke.py never reports success without a GPU: it exits non-zero
and prints no result line, in the checkout and on its own."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_gpu(tmp_path, alone):
    script = REPO / "chip_smoke.py"
    if alone:
        script = pathlib.Path(shutil.copy(script, tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    r = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
