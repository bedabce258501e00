"""The PyTorch port stands alone: no JAX, nothing of fourdgs_tpu, CUDA by
default.

- every port module and the import graphs of ``chip_smoke.py`` and
  ``profile_render_torch.py`` load in a fresh interpreter without ``jax`` or
  ``fourdgs_tpu`` in ``sys.modules``;
- an AST scan finds no such import in the package or those two scripts;
- with CUDA absent, each entry point raises unless asked for the CPU;
- the port's constants equal the JAX package's.
"""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from fourdgs_tpu.ops import constants as JC
from fourdgs_tpu.ops import pallas_blend as PB

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "fourdgs_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _is_forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "fourdgs_tpu")


def test_import_graph_has_no_jax():
    mods = _port_modules()
    code = (
        "import sys, importlib, runpy\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke, profile_render_torch\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'fourdgs_tpu'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(mods) >= 17


def test_ast_scan_has_no_jax_imports():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "profile_render_torch.py"]
    found = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            found += [f"{path.name}: {n}" for n in names if _is_forbidden(n)]
    assert not found, found


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    from __graft_entry__ import _camera, _tiny_cfg

    from fourdgs_tpu_torch import render as TR
    from fourdgs_tpu_torch.models import gaussians as G
    from fourdgs_tpu_torch.models.deformation import Deformation
    from fourdgs_tpu_torch.train import checkpoint

    cfg = _tiny_cfg()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Deformation(cfg.hidden, 4)
    deform = Deformation(cfg.hidden, 4, device="cpu")
    n = 8
    prim = G.pad_primitives({
        "xyz": torch.zeros(n, 3).numpy(), "f_dc": torch.zeros(n, 3).numpy(),
        "f_rest": torch.zeros(n, 9).numpy(), "scaling": torch.zeros(n, 3).numpy(),
        "rotation": torch.ones(n, 4).numpy(), "opacity": torch.zeros(n, 1).numpy(),
    }, 16)
    alive = prim["xyz"][:, 0] == 0
    aabb = [[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0]]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        G.state_from_numpy(prim, deform, alive, aabb, 1)
    state = G.state_from_numpy(prim, deform, alive, aabb, 1, device="cpu")
    cam = TR.CameraArrays.from_camera(_camera(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TR.CameraArrays.from_camera(_camera())
    bg = torch.zeros(3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TR.render(state.params, state, cam, cfg, 64, 64, "fine", bg, 1)
    out = TR.render(state.params, state, cam, cfg, 64, 64, "fine", bg, 1,
                    device="cpu")
    assert out.color.shape == (3, 64, 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        checkpoint.load_snapshot("/nonexistent", cfg)


def test_constants_match_jax():
    from fourdgs_tpu_torch.ops import constants as TC

    for name in ("TILE_X", "TILE_Y", "NUM_CHANNELS", "NEAR_PLANE_Z",
                 "EWA_CLAMP_FACTOR", "COV2D_DILATION", "ALPHA_CAP",
                 "ALPHA_FLOOR", "T_STOP", "W_EPS", "RADIUS_SIGMA", "DET_FLOOR"):
        assert getattr(TC, name) == getattr(JC, name), name
    for name in ("CHUNK", "ALIGN", "FEAT_ROWS", "OUT5", "N_PIX"):
        assert getattr(TC, name) == getattr(PB, name), name
