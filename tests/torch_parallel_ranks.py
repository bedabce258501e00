"""Rank functions of the sharded trainer's CPU tests.

``fourdgs_tpu_torch.parallel.launch.run_ranks`` runs each in the ranks of
a world of CPU gloo processes; this module imports nothing of JAX or of
the JAX package, so neither does a rank. Inputs and results cross as numpy.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from fourdgs_tpu_torch import interop
from fourdgs_tpu_torch.configs.core import KPlanesConfig, load_config
from fourdgs_tpu_torch.parallel import mesh as pmesh
from fourdgs_tpu_torch.parallel import trainer
from fourdgs_tpu_torch.render import CameraArrays
from fourdgs_tpu_torch.train import adam

# The four modes of the sharded step: (shard_preprocess, shard_primitives)
MODES = {"pre": (True, False), "replicated": (False, False),
         "prim": (False, True), "pre_prim": (True, True)}


def port_cfg(overrides: dict):
    """The port's config with dotted ``overrides``; ``hidden.kplanes_config``
    is given as the dict of its fields."""
    overrides = dict(overrides)
    kp = overrides.pop("hidden.kplanes_config", None)
    cfg = load_config(**overrides)
    if kp is not None:
        cfg.hidden.kplanes_config = KPlanesConfig(**kp)
    return cfg


def state_hash(state, adam_state) -> str:
    """SHA-256 of every tensor of a state and its Adam moments."""
    h = hashlib.sha256()
    for t in (trainer.tensor_leaves(state)
              + trainer.tensor_leaves([adam_state.mu, adam_state.nu])):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _result(state, adam_state, metrics, mesh):
    """Rank 0's state in the JAX layout, and every rank's hash."""
    out = {"hash": state_hash(state, adam_state), "rank": mesh.rank}
    if mesh.rank == 0:
        out["state"] = interop.state_to_numpy(state)
        out["adam"] = interop.adam_to_numpy(adam_state)
        out["metrics"] = {k: float(v) for k, v in metrics.items() if k != "stage"}
    return out


def sharded_step_modes(cfg_overrides: dict, state_np, cams_np: dict, gts_np: np.ndarray,
                       width: int, height: int, stage: str, sh_degree: int,
                       modes: list, n_data: int = 2, n_model: int = 2) -> dict:
    """One sharded step from the same state in each of ``modes`` (names of
    :data:`MODES`, or ``(name, {dotted overrides})``) on a
    ``n_data × n_model`` grid; the global batch ``cams_np`` (CameraArrays
    fields as stacked numpy) and ``gts_np`` [B, 3, H, W] placed by
    ``place_batch``."""
    mesh = pmesh.make_mesh(n_data, n_model)
    out = {}
    for mode in modes:
        name, extra = mode if isinstance(mode, tuple) else (mode, {})
        pre, prim = MODES[name.split("+")[0]]
        cfg = port_cfg({**cfg_overrides, "tpu.shard_preprocess": pre,
                        "tpu.shard_primitives": prim, **extra})
        state = interop.state_from_jax(state_np, cfg, device="cpu")
        opt = adam.init(state.params)
        state = trainer.replicate(mesh, state)
        if prim:
            state = state._replace(params=trainer.shard_primitives(mesh, state.params))
            opt = trainer.shard_adam(mesh, opt)
        cams = CameraArrays(**{k: torch.tensor(v) for k, v in cams_np.items()})
        cams, gts = trainer.place_batch(mesh, cams, torch.tensor(gts_np))
        step = trainer.make_sharded_train_step(cfg, mesh, width, height, stage,
                                               sh_degree, device="cpu")
        with torch.enable_grad():
            params, opt, state, metrics = step(state.params, opt, state, cams, gts, 1)
        state = state._replace(params=params)
        if prim:
            state = state._replace(params=trainer.unshard_primitives(mesh, state.params))
            opt = trainer.unshard_adam(mesh, opt)
        out[name] = _result(state, opt, metrics, mesh)
    return out


def loops_with_mesh(runs: list, state_np, cams_np: list, n_data: int = 2,
                    n_model: int = 2, **kw) -> list:
    """``scene_reconstruction`` of a coarse stage on a ``n_data × n_model``
    grid from ``state_np``, for each ``(cfg_overrides, iterations)`` of
    ``runs``; ``cams_np``: (camera, GT) pairs (a ``utils.graphics.Camera``
    and a float [3, H, W] GT)."""
    from fourdgs_tpu_torch.train.loop import scene_reconstruction

    mesh = pmesh.make_mesh(n_data, n_model)
    out = []
    for overrides, iters in runs:
        cfg = port_cfg(overrides)
        state = interop.state_from_jax(state_np, cfg, device="cpu")
        opt = adam.init(state.params)
        state, opt, log = scene_reconstruction(cfg, state, opt, cams_np, "coarse", iters,
                                               device="cpu", mesh=mesh, **kw)
        res = _result(state, opt, log.iterations[-1], mesh)
        res["log"] = log.iterations
        res["events"] = log.events
        out.append(res)
    return out


def collectives_check() -> dict:
    """``all_gather`` (tiled and stacked, with its backward), ``psum``,
    ``pmax`` and ``pmean`` on the world of this rank, against the values
    every rank can compute."""
    import torch.distributed as dist

    from fourdgs_tpu_torch.parallel import collectives as col

    r, n = dist.get_rank(), dist.get_world_size()
    world = dist.group.WORLD
    x = (torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r).requires_grad_()
    want = torch.cat([torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * k
                      for k in range(n)], dim=1)
    with torch.enable_grad():
        g = col.all_gather(x, world, axis=1)
        coef = torch.arange(g.numel(), dtype=torch.float32).reshape(g.shape)
        (dx,) = torch.autograd.grad((g * coef).sum(), x)
    stacked = col.all_gather(x.detach(), world, axis=0, tiled=False)
    ints = torch.tensor([r, -r], dtype=torch.int64)
    s_f, s_i = col.psum([x.detach(), ints], world)
    return {
        "gather": bool(torch.equal(g.detach(), want)),
        # the transpose: each rank's block of Σ over ranks of the cotangent
        "gather_grad": bool(torch.equal(dx, n * coef[:, 3 * r:3 * r + 3])),
        "stacked": bool(torch.equal(stacked, want.reshape(2, n, 3).permute(1, 0, 2))),
        "psum": bool(torch.equal(s_f, sum(torch.arange(6, dtype=torch.float32).reshape(2, 3)
                                          + 10 * k for k in range(n))))
        and bool(torch.equal(s_i, torch.tensor([n * (n - 1) // 2, -(n * (n - 1) // 2)]))),
        "pmax": bool(torch.equal(col.pmax(ints, world), torch.tensor([n - 1, 0]))),
        "pmean": float(col.pmean(torch.tensor(float(r)), world)) == (n - 1) / 2,
        "counts": dict(col.counts),
    }


def cli_rank(argv: list, target_size: tuple) -> dict:
    """``train_torch.main(argv)`` in this rank (``--distributed`` keeps the
    world's group), with the Blender loader's frame size set to
    ``target_size``."""
    import train_torch
    from fourdgs_tpu_torch.data import scene as tscene

    tscene.TARGET_SIZE = tuple(target_size)
    state, opt = train_torch.main(argv)
    return {"hash": state_hash(state, opt),
            "n_points": int(state.alive.sum()), "capacity": int(state.alive.shape[0])}


def viewer_with_mesh(overrides: dict, state_np, cams_np: list, iters: int,
                     n_data: int = 1, n_model: int = 2, **kw) -> dict:
    """``scene_reconstruction`` of a coarse stage on a ``n_data × n_model``
    grid under ``shard_primitives``, the first rank serving a viewer to
    which a SIBR client (``chip_smoke.sibr_client``, a thread of that rank)
    sends the first camera before iterations 1 to ``iters`` − 1. The first
    rank returns the frames it served and, for each of iterations 1 to
    ``iters`` − 2, the uint8 render of that camera by the whole state
    ``log_fn`` is given after the step (what the next frame shows), made in
    this process without the mesh."""
    import threading

    import chip_smoke as CS
    from fourdgs_tpu_torch.render import render
    from fourdgs_tpu_torch.train.loop import scene_reconstruction
    from fourdgs_tpu_torch.viewer import NetworkGUI

    mesh = pmesh.make_mesh(n_data, n_model)
    cfg = port_cfg({**overrides, "tpu.shard_primitives": True})
    state = interop.state_from_jax(state_np, cfg, device="cpu")
    cam = cams_np[0][0]
    # the centre as the viewer's receive() rebuilds it from the view matrix
    vcam = CameraArrays.from_camera(cam._replace(camera_center=np.linalg.inv(
        np.asarray(cam.world_view, np.float64)).T[:3, 3].astype(np.float32)), device="cpu")
    bg = torch.zeros(3)
    renders = []

    def one_process_render(st) -> np.ndarray:
        with torch.no_grad():
            color = render(st.params, st, vcam, cfg, cam.width, cam.height, "coarse", bg,
                           st.active_sh_degree, device="cpu").color
        return (np.clip(color.numpy(), 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)

    def log_fn(iteration, stage, m, st, opt):
        if mesh.rank == 0:
            renders.append(one_process_render(st))

    gui = client = None
    result: dict = {}
    if mesh.rank == 0:
        gui = NetworkGUI(port=0)
        renders.append(one_process_render(state))            # before iteration 1
        client = threading.Thread(target=CS.sibr_client, daemon=True, args=(
            gui.port, [(cam, False)] * (iters - 1), result, 120.0))
        client.start()
    try:
        state, opt, log = scene_reconstruction(
            cfg, state, adam.init(state.params), cams_np, "coarse", iters, device="cpu",
            mesh=mesh, viewer=gui, log_fn=log_fn, **{**kw, "log_interval": 1})
    finally:
        if gui is not None:
            client.join(timeout=120.0)
            gui.close()
    out = {"rank": mesh.rank, "hash": state_hash(state, opt)}
    if mesh.rank == 0:
        out.update(frames=result.get("frames"), error=result.get("error"),
                   renders=renders[:iters - 1], verify=result.get("verify"))
    return out
