"""Chip smoke test of the PyTorch + CUDA port (``fourdgs_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. It imports nothing of JAX or ``fourdgs_tpu``
and fails (exit code != 0, no result line) without CUDA. Phases, each fatal
on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel of ``fourdgs_tpu_torch/csrc`` (nvcc, sm_90a) and print
   the build time and ptxas report;
3. the blend kernel (K1) against its plain PyTorch version on synthetic
   inputs: windows straddling chunk boundaries, a tile longer than 3 chunks,
   a saturated tile, empty tiles, trailing empty tiles at start == K and a
   nonzero tile-row offset/stride;
4. the full-width render of the D-NeRF ``lego`` preset (multires (1, 2),
   net_width 64, 64³×25 K-planes × 32 features, sh degree 3, white
   background) over 60,000 random Gaussians in capacity 65,536, 800×800:
   1 warm-up view and 20 timed views through ``render``; the launch count
   must rise by exactly 21. Then K1 at that view's shapes: time per call
   (CUDA events), the plain version's time, the bound and agreement
   (``profile_render_torch.py`` breaks a view down by stage);
5. a snapshot round trip (save, load, render) that must match bit for bit;
6. one JSON line ``{"kernels": [...]}`` and, last, the result line
   ``{"ok": true, "device": {...}}``.

Agreement bound of K1 with its plain version: atol 1e-4 on color and final
transmittance, except pixels riding T_STOP, where a different association of
the transmittance product may flip one instance (the association contract of
``tests/test_pallas_raster.py``): at most 0.01% of pixels may exceed 1e-4 and
none 1e-2. Depth is held at 1e-4 relative to max(1, |depth|).
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
LEGO = os.path.join(ROOT, "fourdgs_tpu", "configs", "presets", "dnerf", "lego.py")
WIDTH = HEIGHT = 800
N_POINTS, CAPACITY = 60_000, 65_536
N_TIMED = 20
H100_F32_FLOPS = 67e12    # non-tensor-core float32, H100 SXM data sheet
H100_HBM_BYTES = 3.35e12  # bytes/s
OPS_PER_PAIR = 16         # ~15 float32 operations + one exp per (pixel, instance)


def synthetic_blend_inputs(device, seed=0):
    """Blend inputs covering the window edge cases (see module docstring):
    24 tiles on a 4-wide grid, tile rows mapped to 1 + 2j, K = 4096."""
    import torch

    from fourdgs_tpu_torch.ops import constants as C

    rng = np.random.default_rng(seed)
    gx, T, K = 4, 24, 4096
    row_off = (1, 2)
    lens = rng.integers(20, 220, T)
    lens[[2, 5, 11]] = 0          # empty tiles
    lens[3] = 37                  # straddles the first chunk boundary
    lens[6] = 520                 # longer than 3 chunks
    lens[7] = 450                 # saturated (below)
    lens[21:] = 0                 # trailing empty tiles at start == K
    lens[20] = K - lens[:20].sum()  # the last nonempty tile ends at K
    assert lens[20] > 3 * C.CHUNK, lens
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    stops = (starts + lens).astype(np.int32)
    tile = np.repeat(np.arange(T), lens)
    tx = (tile % gx) * 16
    ty = ((tile // gx) * row_off[1] + row_off[0]) * 16
    feat = np.zeros((C.FEAT_ROWS, K), np.float32)
    feat[0] = tx + rng.uniform(-8, 24, K)
    feat[1] = ty + rng.uniform(-8, 24, K)
    feat[2] = rng.uniform(0.01, 0.3, K)
    feat[3] = rng.uniform(-0.05, 0.05, K)
    feat[4] = rng.uniform(0.01, 0.3, K)
    feat[5] = rng.uniform(0.002, 0.9, K)
    feat[6:10] = rng.uniform(0, 1, (4, K))
    sat = tile == 7
    feat[2, sat] = rng.uniform(0.002, 0.02, sat.sum())
    feat[4, sat] = rng.uniform(0.002, 0.02, sat.sum())
    feat[3, sat] = 0.0
    feat[5, sat] = rng.uniform(0.8, 0.99, sat.sum())

    def t(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    return (t(feat, torch.float32), t(starts, torch.int32), t(stops, torch.int32),
            t(row_off, torch.int32), t([0.2, 0.5, 0.9], torch.float32), gx)


def compare_blend(out, ref):
    """Kernel output vs plain output [T, 5, 256] under the association
    contract; returns a dict of counts and errors, raising on violation."""
    import torch

    err = (out - ref).abs()
    ct = err[:, [0, 1, 2, 4]].amax(dim=1)          # per pixel, color + T
    depth_tol = 1e-4 * torch.clamp(ref[:, 3].abs(), min=1.0)
    n_pix = ct.numel()
    res = {
        "pixels": n_pix,
        "over_1e-4": int((ct > 1e-4).sum()),
        "over_1e-2": int((ct > 1e-2).sum()),
        "depth_over_tol": int((err[:, 3] > depth_tol).sum()),
        "max_abs_err": float(err.max()),
        "max_color_err": float(ct.max()),
        "finite": bool(torch.isfinite(out).all()),
    }
    ok = (res["finite"] and res["over_1e-2"] == 0
          and res["over_1e-4"] <= 1e-4 * n_pix
          and res["depth_over_tol"] <= 1e-4 * n_pix)
    if not ok:
        raise AssertionError(f"blend kernel disagrees with its plain version: {res}")
    return res


def cuda_time_ms(fn, reps, warmup=2):
    """Median milliseconds per call of ``fn`` by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def blend_bound(starts, stops, k_pad):
    """Least time for K1's work on this input: the larger of the operations
    on the walked (pixel, instance) pairs at the float32 rate and the bytes
    (40 B per walked instance, 5 output floats per pixel) at HBM rate.
    Walked instances of a tile: from its 8-aligned window start to its stop,
    the masked alignment lanes included."""
    s = starts.cpu().numpy().astype(np.int64)
    e = stops.cpu().numpy().astype(np.int64)
    off0 = np.minimum((s // 8) * 8, k_pad - 8)
    walked = int(np.where(e > s, e - off0, 0).sum())
    pairs = 256 * walked
    ops_s = pairs * OPS_PER_PAIR / H100_F32_FLOPS
    bytes_s = (40 * walked + s.size * 5 * 256 * 4) / H100_HBM_BYTES
    return {"walked": walked, "pairs": pairs, "bound_ms": 1e3 * max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}


def ring_camera(i, n_views):
    """bench.py's camera ring: 800×800, fov π/3, at time i/(n_views−1)."""
    from fourdgs_tpu_torch.utils import graphics

    ang = 0.3 + 0.5 * i
    eye = np.array([3.2 * math.sin(ang), 0.5, -3.2 * math.cos(ang)])
    fwd = -eye / np.linalg.norm(eye)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    R = np.stack([right, up2, fwd], axis=1)
    T = -R.T @ eye
    fov = math.pi / 3
    return graphics.make_camera(R, T, fov, fov, WIDTH, HEIGHT,
                                time=i / max(n_views - 1, 1))


def bench_scene(cfg, seed=0, device="cuda"):
    """bench.py's scene: 60,000 live Gaussians in capacity 65,536, positions
    U(−1.2, 1.2), scales U(0.005, 0.02), opacity 0.1, random colors and
    unit rotations; the lego deformation initialized from the seed (nonzero
    heads)."""
    import torch

    from fourdgs_tpu_torch.models import gaussians as G
    from fourdgs_tpu_torch.models.deformation import Deformation
    from fourdgs_tpu_torch.utils.sh import rgb_to_sh

    rng = np.random.default_rng(seed)
    n = N_POINTS
    pts = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    rot = rng.normal(size=(n, 4))
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    k_sh = G.num_sh_coeffs(cfg.model.sh_degree)
    prim = G.pad_primitives({
        "xyz": pts,
        "f_dc": rgb_to_sh(torch.tensor(cols)).numpy(),
        "f_rest": np.zeros((n, 3 * (k_sh - 1)), np.float32),
        "scaling": np.log(rng.uniform(0.005, 0.02, (n, 3))),
        "rotation": rot,
        "opacity": np.full((n, 1), G.inverse_sigmoid(0.1)),
    }, CAPACITY)
    alive = np.arange(CAPACITY) < n
    aabb = np.stack([pts.max(axis=0), pts.min(axis=0)])
    deform = Deformation(cfg.hidden, k_sh, seed=seed, device=device)
    return G.state_from_numpy(prim, deform, alive, aabb,
                              cfg.model.sh_degree, device=device)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    torch.set_grad_enabled(False)

    from fourdgs_tpu_torch import render as TR
    from fourdgs_tpu_torch.configs.core import load_config
    from fourdgs_tpu_torch.ops import _build, blend
    from fourdgs_tpu_torch.ops import rasterize as R
    from fourdgs_tpu_torch.train import checkpoint

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print("[1] card (nvidia-smi name, power.limit):")
    print(card)
    print(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[2] kernel build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(sorted(libs))})")
    for stem, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"    {stem}: {line.strip()}")

    # -- 3. K1 against its plain version on synthetic edge cases
    feat, starts, stops, row_off, bg, gx = synthetic_blend_inputs(dev)
    out = blend.blend_forward(feat, starts, stops, row_off, bg, gx)
    torch.cuda.synchronize()
    ref = blend.blend_forward_plain(feat, starts, stops, row_off, bg, gx)
    syn = compare_blend(out, ref)
    print(f"[3] K1 vs plain, synthetic edge cases: {syn}")

    # -- 4. full-width render of the lego preset
    cfg = load_config(LEGO)
    cfg.tpu.capacity = CAPACITY
    state = bench_scene(cfg, device=dev)
    bg_img = torch.ones(3, device=dev)    # white background (preset)
    cams = [TR.CameraArrays.from_camera(ring_camera(i, N_TIMED), device=dev)
            for i in range(N_TIMED)]

    def view(cam, st=state):
        return TR.render(st.params, st, cam, cfg, WIDTH, HEIGHT, "fine",
                         bg_img, cfg.model.sh_degree, device=dev)

    blend.blend_forward.launches = 0
    view(cams[0])                         # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [view(cam) for cam in cams]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = blend.blend_forward.launches
    fps = (N_TIMED - 1) / elapsed
    print(f"[4] render {WIDTH}x{HEIGHT} lego fine stage: {N_TIMED} timed views "
          f"in {elapsed * 1e3:.3f} ms, FPS {fps:.3f} ((n-1)/elapsed), "
          f"{elapsed * 1e3 / N_TIMED:.3f} ms/view")
    print(f"    K1 launches over 1 warm-up + {N_TIMED} views: {launches}")
    if launches != N_TIMED + 1:
        raise AssertionError(f"blend kernel launched {launches} times, "
                             f"expected {N_TIMED + 1}")
    for i, o in enumerate(outs):
        if not bool(torch.isfinite(o.color).all() & torch.isfinite(o.depth).all()):
            raise AssertionError(f"view {i}: non-finite output")
        a_min, a_max = float(o.alpha.min()), float(o.alpha.max())
        if not (0.0 <= a_min and a_max <= 1.0):
            raise AssertionError(f"view {i}: alpha outside [0, 1]")
    nr = [int(o.num_rendered) for o in outs]
    mtl = [int(o.max_tile_len) for o in outs]
    print(f"    num_rendered min/median/max {min(nr)}/{int(np.median(nr))}/"
          f"{max(nr)}, max_tile_len max {max(mtl)}, "
          f"K = {-(-cfg.tpu.instance_budget // 128) * 128}, "
          f"mean alpha (view 0) {float(outs[0].alpha.mean()):.4f}")

    # K1 at the shapes of one view of the main path
    k_view = N_TIMED // 2
    cam = cams[k_view]
    xyz, sc, rot, op, shs, _ = TR.activated_gaussians(state.params, state, cam, "fine")
    bi = R.blend_inputs(xyz, sc, rot, op, shs, cam.camera_center, cam.world_view,
                        cam.full_proj, cam.tanfovx, cam.tanfovy, WIDTH, HEIGHT,
                        cfg.model.sh_degree, cfg.tpu.instance_budget,
                        alive=state.alive)
    args = (bi.feat, bi.bins.tile_start, bi.bins.tile_stop, bi.row_off,
            bg_img, bi.grid_x)
    k_out = blend.blend_forward(*args)
    p_out = blend.blend_forward_plain(*args)
    full = compare_blend(k_out, p_out)
    kernel_ms = cuda_time_ms(lambda: blend.blend_forward(*args), reps=20)
    plain_ms = cuda_time_ms(lambda: blend.blend_forward_plain(*args), reps=3,
                            warmup=1)
    bound = blend_bound(bi.bins.tile_start, bi.bins.tile_stop, bi.feat.shape[1])
    print(f"    K1 at view {k_view} ({bi.bins.tile_start.numel()} tiles, "
          f"{int(bi.bins.num_rendered)} instances, {bound['walked']} walked, "
          f"{bound['pairs']} pairs): kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}), kernel/bound "
          f"{kernel_ms / bound['bound_ms']:.2f}")
    print(f"    K1 vs plain at view {k_view}: {full}")

    # -- 5. snapshot round trip
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_snapshot_") as tmp:
        snap = checkpoint.save_snapshot(tmp, state, 1)
        loaded = checkpoint.load_snapshot(snap, cfg, device=dev)
    direct, again = view(cams[0]), view(cams[0], loaded)
    same = all(torch.equal(getattr(direct, f), getattr(again, f))
               for f in ("color", "depth", "alpha", "radii", "num_rendered"))
    print(f"[5] snapshot round trip: bit-identical render = {same}")
    if not same:
        raise AssertionError("snapshot round trip changed the render")

    # -- 6. kernels line, result line
    kernels = [{
        "name": "blend_forward",
        "route": "cuda",
        "source": "fourdgs_tpu_torch/csrc/blend_forward.cu",
        "replaces": "fourdgs_tpu/ops/pallas_blend.py:305",
        "launches": launches,
        "max_abs_err": full["max_abs_err"],
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"],
        "library_ms": None,   # no single PyTorch call computes this blend
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
