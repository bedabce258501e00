"""The PyTorch port stands alone: no JAX, nothing of fourdgs_tpu, no image
library the card's host lacks, CUDA by default.

- every port module and the import graphs of ``chip_smoke.py``,
  ``profile_render_torch.py``, ``profile_train_torch.py``,
  ``bench_quality_torch.py`` and ``bench_quality_dynerf_torch.py`` load in
  a fresh interpreter without ``jax``, ``fourdgs_tpu``, ``PIL``, ``cv2`` or
  ``imageio`` in ``sys.modules``;
- an AST scan finds no such import in the package or those scripts, nor in
  the CLIs (``train_torch.py``, ``render_torch.py``, ``metrics_torch.py``,
  ``export_perframe_3DGS_torch.py``, ``merge_many_4dgs_torch.py``,
  ``full_eval_torch.py``, ``verify_improvements_torch.py``,
  ``convert_torch.py``),
  lazy imports inside functions included (JAX's ``debug_images.py`` and
  ``ImageRef`` import Pillow there, which only the card would find);
- the native libraries build without a JPEG library (no ``-ljpeg``), the
  resampler and the H.264 and MPEG-4 Part 2 decoders with no library at
  all;
- the shell drivers call only the port's entry points and scripts;
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


# JAX and the reference package, and the image and video libraries the
# card's host does not have
FORBIDDEN = ("jax", "jaxlib", "fourdgs_tpu", "PIL", "cv2", "imageio", "av")
PREP_SCRIPTS = ("blender2colmap", "colmap_converter", "hypernerf2colmap", "llff2colmap",
                "preprocess_dynerf",
                "llff_poses_from_colmap", "prepare_multipleview", "downsample_point",
                "database", "read_all_metrics", "analyze_gradients", "plot_events",
                "visualize_timing", "render_oracle_gt")
CLIS = ("train_torch.py", "render_torch.py", "metrics_torch.py",
        "export_perframe_3DGS_torch.py", "merge_many_4dgs_torch.py", "full_eval_torch.py",
        "verify_improvements_torch.py", "convert_torch.py")
# the capture and ablation drivers (shell)
DRIVERS = ("colmap_torch.sh", "multipleviewprogress_torch.sh",
           "fourdgs_tpu_torch/scripts/run_instant4d.sh",
           "fourdgs_tpu_torch/scripts/debug_test.sh")


def _is_forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_import_graph_has_no_jax():
    mods = _port_modules()
    code = (
        "import sys, importlib, runpy\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke, profile_render_torch, profile_train_torch\n"
        "import bench_quality_torch, bench_quality_dynerf_torch\n"
        "import train_torch, render_torch, metrics_torch\n"
        "import export_perframe_3DGS_torch, merge_many_4dgs_torch, full_eval_torch\n"
        "import verify_improvements_torch, convert_torch\n"
        "bad = sorted(m for m in sys.modules "
        f"if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(mods) >= 37
    for m in ("fourdgs_tpu_torch.viewer", "fourdgs_tpu_torch.utils.resample",
              "fourdgs_tpu_torch.utils.lpips", "fourdgs_tpu_torch.utils.gradient_tracker",
              "fourdgs_tpu_torch.ops.reference", "fourdgs_tpu_torch.ops.tiled",
              "fourdgs_tpu_torch.models.grid"):
        assert m in mods
    # the host tools of scripts/ (the AST scan below reads them too)
    for name in PREP_SCRIPTS:
        assert f"fourdgs_tpu_torch.scripts.{name}" in mods, name
    # the sharded trainer and its scripts
    for name in ("mesh", "collectives", "trainer", "multihost", "launch"):
        assert f"fourdgs_tpu_torch.parallel.{name}" in mods, name
    for name in ("multihost_smoke", "measure_scaling", "measure_multihost",
                 "gradient_from_checkpoint"):
        assert f"fourdgs_tpu_torch.scripts.{name}" in mods, name


def test_drivers_call_only_the_port():
    """The shell drivers run the port's entry points and scripts: no JAX
    CLI (``train.py``, ``render.py``, ``metrics.py``) and no ``python
    scripts/<name>.py``; each ``python -m`` names a port module that
    exists."""
    import re

    for rel in DRIVERS:
        text = "\n".join(line for line in (ROOT / rel).read_text().splitlines()
                         if not line.lstrip().startswith("#"))
        calls = re.findall(r"^\s*python3? (\S+)", text, re.M)
        assert calls, rel
        for target in calls:
            assert target in ("-", "-m") or target.endswith("_torch.py"), (rel, target)
        assert "python scripts/" not in text, rel
        for module in re.findall(r"python3? -m (\S+)", text):
            module = module.replace('"${datatype}"', "blender")
            assert (ROOT / (module.replace(".", "/") + ".py")).is_file(), (rel, module)


def test_ast_scan_has_no_jax_imports():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "profile_render_torch.py",
                                         ROOT / "profile_train_torch.py",
                                         ROOT / "bench_quality_torch.py",
                                         ROOT / "bench_quality_dynerf_torch.py",
                                         *(ROOT / c for c in CLIS)]
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


def test_native_builds_link_no_jpeg_library():
    from fourdgs_tpu_torch.data import fastloader
    from fourdgs_tpu_torch.utils import jpeg, native, resample

    for flags in (native.CXX_FLAGS, fastloader.LINK_FLAGS, jpeg.LINK_FLAGS, resample.FLAGS):
        assert not [f for f in flags if "jpeg" in f], flags
    assert not [f for f in resample.FLAGS if f.startswith("-l")]
    src = (PKG / "native" / "jpeg.cpp").read_text()
    assert "#include <jpeglib.h>" not in src and "jpeg_read_header" not in src


def test_video_decoder_links_no_codec_library():
    from fourdgs_tpu_torch.utils import video

    assert not [f for f in video.FLAGS if f.startswith("-l")]
    src = (PKG / "native" / "h264.cpp").read_text()
    assert "#include <libav" not in src and "avcodec_" not in src


def test_mpeg4_decoder_links_no_codec_library():
    """The MPEG-4 Part 2 decoder and the headers the decoders share include
    no codec library; ``utils/video.py`` builds it with the same flags."""
    from fourdgs_tpu_torch.utils import native, video

    assert video.MPEG4_SRC == PKG / "native" / "mpeg4.cpp"
    assert native.local_headers(video.MPEG4_SRC) == [PKG / "native" / "mp4.h",
                                                     PKG / "native" / "yuv420_bgr.h"]
    for name in ("mpeg4.cpp", "mp4.h", "yuv420_bgr.h"):
        src = (PKG / "native" / name).read_text()
        assert "#include <libav" not in src and "avcodec_" not in src, name


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

    from fourdgs_tpu_torch.ops import grid_cost
    from fourdgs_tpu_torch.scripts import exp_gather, exp_grid_cost, exp_kernel_overhead
    from fourdgs_tpu_torch.train.loop import make_train_step
    from fourdgs_tpu_torch.utils.losses import tile_pixel_mask

    cfg.opt.lambda_dssim = 0.0
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(cfg, 64, 64, "fine", 1)

    import bench_quality_torch
    from fourdgs_tpu_torch.ops.knn import mean_sq_dist_3nn
    from fourdgs_tpu_torch.train import adam
    from fourdgs_tpu_torch.train.loop import scene_reconstruction

    pts = torch.rand(n, 3).numpy()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        G.create_from_pcd(cfg, pts, pts, 1.0)
    pcd = G.create_from_pcd(cfg, pts, pts, 1.0, device="cpu")
    assert mean_sq_dist_3nn(pcd.params["xyz"][:n]).shape == (n,)
    cams = [(_camera(size=64), torch.zeros(3, 64, 64).numpy())]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        scene_reconstruction(cfg, pcd, adam.init(pcd.params), cams, "coarse", 1, 1.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_quality_torch.run(size=64, n_train=1, n_test=1)
    import bench_quality_dynerf_torch
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_quality_dynerf_torch.run(scale=0.01)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tile_pixel_mask(56, 72)
    assert tile_pixel_mask(56, 72, device="cpu").shape == (20, 1, 256)
    for run in (exp_gather.run, exp_grid_cost.run, exp_kernel_overhead.run):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()
    import export_perframe_3DGS_torch
    import merge_many_4dgs_torch
    import metrics_torch
    from fourdgs_tpu_torch.utils import gradient_tracker, lpips

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lpips.make_lpips(lpips.random_weights("alex"), "alex")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        metrics_torch.try_lpips()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gradient_tracker.gradient_timeline(cfg, state, _camera(), torch.zeros(3, 64, 64),
                                           "/nonexistent")
    for main in (export_perframe_3DGS_torch.main, merge_many_4dgs_torch.main):
        argv = ["--model_paths", "/nonexistent", "-s", "/nonexistent"] if (
            main is merge_many_4dgs_torch.main) else ["--model_path", "/nonexistent"]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
    from fourdgs_tpu_torch.parallel.mesh import Mesh
    from fourdgs_tpu_torch.parallel.trainer import make_sharded_train_step
    from fourdgs_tpu_torch.scripts import measure_multihost, measure_scaling

    one = Mesh({"data": 1, "model": 1}, 0, 0, None, None, None, (0,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_sharded_train_step(cfg, one, 64, 64, "fine", 1)
    for run in (measure_scaling.run, measure_multihost.run):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()
    import verify_improvements_torch
    from fourdgs_tpu_torch.scripts import gradient_from_checkpoint

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gradient_from_checkpoint.main(["--checkpoint", "/nonexistent/chkpnt_fine_1",
                                       "-s", "/nonexistent"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        verify_improvements_torch.main([])
    for probe in grid_cost.PROBES:
        if probe.fn is grid_cost.while_ones:   # runs where its counts lie
            continue
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            probe.fn(8)
        with pytest.raises(TypeError):         # the plain versions name their device
            probe.plain(8)


def test_constants_match_jax():
    from fourdgs_tpu_torch.ops import constants as TC

    for name in ("TILE_X", "TILE_Y", "NUM_CHANNELS", "NEAR_PLANE_Z",
                 "EWA_CLAMP_FACTOR", "COV2D_DILATION", "ALPHA_CAP",
                 "ALPHA_FLOOR", "T_STOP", "W_EPS", "RADIUS_SIGMA", "DET_FLOOR"):
        assert getattr(TC, name) == getattr(JC, name), name
    for name in ("CHUNK", "ALIGN", "FEAT_ROWS", "OUT5", "N_PIX"):
        assert getattr(TC, name) == getattr(PB, name), name
