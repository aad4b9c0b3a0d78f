"""Packaging/distribution layer (reference counterpart
colormipsearch-dist/pom.xml:37-44 + Dockerfile:1-28): the repo installs
as a wheel with a `colormipsearch-tpu` console script."""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_console_entry_point_resolves():
    """pyproject's [project.scripts] target must exist and be callable."""
    import tomllib
    cfg = tomllib.loads((REPO / "pyproject.toml").read_text())
    target = cfg["project"]["scripts"]["colormipsearch-tpu"]
    mod, _, attr = target.partition(":")
    import importlib
    fn = getattr(importlib.import_module(mod), attr)
    assert callable(fn)
    # package version single-source check
    import colormipsearch_tpu
    assert cfg["project"]["version"] == colormipsearch_tpu.__version__


def test_cli_help_smoke():
    from colormipsearch_tpu.cmd.main import main
    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0


@pytest.mark.slow
def test_pip_install_smoke(tmp_path):
    """`pip install .` produces an importable install with the console
    script metadata (offline: no build isolation, no deps)."""
    target = tmp_path / "site"
    r = subprocess.run(
        [sys.executable, "-m", "pip", "install", "--no-build-isolation",
         "--no-deps", "--no-index", "--target", str(target), str(REPO)],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    env = dict(os.environ, PYTHONPATH=str(target), JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c",
         "from colormipsearch_tpu.cmd.main import main\n"
         "import colormipsearch_tpu.native, pathlib\n"
         # the native helper SOURCE must ship in the wheel
         "src = pathlib.Path(colormipsearch_tpu.native.__file__).parent\n"
         "assert (src / 'mipops.cpp').exists(), 'mipops.cpp not packaged'\n"
         "try:\n"
         "    main(['--help'])\n"
         "except SystemExit as e:\n"
         "    assert e.code == 0\n"
         "print('ok')"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ok" in r.stdout
    # console-script metadata recorded in the dist-info
    dist_info = next(target.glob("colormipsearch_tpu-*.dist-info"))
    assert "colormipsearch-tpu = colormipsearch_tpu.cmd.main:main" in \
        (dist_info / "entry_points.txt").read_text().replace(" ", " ")
