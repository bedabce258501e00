"""The port's user entry points stand alone, as ``tests/test_torch_imports.py``
checks for the package and the earlier scripts: ``bench_torch.py``,
``train_torch.py``, ``render_torch.py`` and ``metrics_torch.py`` import no
JAX and nothing of ``fourdgs_tpu``, and neither they nor any port module
reaches Pillow, imageio or orbax, which the card's machine does not have
(the port's PNG codec and ``.npz`` checkpoints stand in for them). Each
entry point raises without CUDA unless asked for the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from tests.test_torch_imports import PKG, ROOT, _port_modules

NEW_SCRIPTS = ("bench_torch", "train_torch", "render_torch", "metrics_torch")
PORT_SCRIPTS = NEW_SCRIPTS + ("chip_smoke", "profile_render_torch",
                              "profile_train_torch", "bench_quality_torch")
FORBIDDEN = ("jax", "jaxlib", "fourdgs_tpu", "PIL", "imageio", "orbax")


def test_import_graph_is_standalone():
    code = (
        "import sys, importlib\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {_port_modules() + list(PORT_SCRIPTS)!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules "
        f"if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_ast_scan_is_standalone():
    files = sorted(PKG.rglob("*.py")) + [ROOT / f"{s}.py" for s in PORT_SCRIPTS]
    found = []
    for path in files:
        tree = ast.parse(pathlib.Path(path).read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            found += [f"{path.name}: {n}" for n in names
                      if n.split(".")[0] in FORBIDDEN]
    assert not found, found


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    import bench_torch
    import metrics_torch
    import render_torch
    import train_torch

    for call in (lambda: bench_torch.main([]),
                 lambda: train_torch.main(["-s", str(tmp_path)]),
                 lambda: render_torch.main(["--model_path", str(tmp_path)]),
                 lambda: metrics_torch.main(["--model_path", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
