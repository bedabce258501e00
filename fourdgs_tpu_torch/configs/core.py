"""Configuration tree: dataclasses mirroring the reference's four ParamGroups.

Parity target: arguments/__init__.py:47-153 in the reference (ModelParams,
PipelineParams, ModelHiddenParams, OptimizationParams) with the same knob
names, defaults, and semantics, plus the mmengine-style override-file merge
(`_base_` inheritance, utils/params_utils.py:1-9) reimplemented as plain
dataclass updates. TPU additions live in ``TpuParams``.

The port's own copy of ``fourdgs_tpu/configs/core.py`` (the port imports
nothing of the JAX package). Preset files are config data: ``load_config``
executes the file at the path the caller gives. The rasterizer knobs keep
their ``TpuParams`` names so a preset reads the same on both sides.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import pathlib
from dataclasses import dataclass, field
from typing import Any


@dataclass
class ModelParams:
    """Reference arguments/__init__.py:47-69."""

    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = True
    eval: bool = True
    render_process: bool = False
    add_points: bool = False
    extension: str = ".png"
    llffhold: int = 8
    # Instant4D fast-train toggles (arguments/__init__.py:61-63)
    use_grid_pruning: bool = False
    use_isotropic_gaussian: bool = False
    use_simplified_rgb: bool = False


@dataclass
class PipelineParams:
    """Reference arguments/__init__.py:71-76."""

    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


@dataclass
class KPlanesConfig:
    """Reference ModelHiddenParams.kplanes_config (arguments/__init__.py:91-96)."""

    grid_dimensions: int = 2
    input_coordinate_dim: int = 4
    output_coordinate_dim: int = 32
    # [x, y, z, t]; temporal resolution "better to be half length of dynamic
    # frames"; multires multiplies the spatial entries only.
    resolution: tuple[int, int, int, int] = (64, 64, 64, 25)


@dataclass
class ModelHiddenParams:
    """Reference arguments/__init__.py:77-110 (deformation architecture)."""

    net_width: int = 64
    timebase_pe: int = 4
    defor_depth: int = 1
    posebase_pe: int = 10
    scale_rotation_pe: int = 2
    opacity_pe: int = 2
    timenet_width: int = 64
    timenet_output: int = 32
    bounds: float = 1.6
    plane_tv_weight: float = 0.0001
    time_smoothness_weight: float = 0.01
    l1_time_planes: float = 0.0001
    kplanes_config: KPlanesConfig = field(default_factory=KPlanesConfig)
    multires: tuple[int, ...] = (1, 2, 4, 8)
    no_dx: bool = False
    no_grid: bool = False
    no_ds: bool = False
    no_dr: bool = False
    no_do: bool = True
    no_dshs: bool = True
    empty_voxel: bool = False
    grid_pe: int = 0
    static_mlp: bool = False
    apply_rotation: bool = False
    # Zero-init the FINAL layer of each deformation head: the fine stage
    # then starts exactly at the coarse canonical model (all deltas 0)
    # instead of adding Xavier-noise deltas to trained log-scales — the
    # reference's init (deformation.py:218-223) inflates instance demand
    # ~30x for hundreds of steps at fine start. Off by default (init
    # parity); quality benches enable it.
    zero_init_heads: bool = False


@dataclass
class OptimizationParams:
    """Reference arguments/__init__.py:112-153."""

    dataloader: bool = False
    zerostamp_init: bool = False
    custom_sampler: Any = None
    iterations: int = 30_000
    coarse_iterations: int = 3000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 20_000
    deformation_lr_init: float = 0.00016
    deformation_lr_final: float = 0.000016
    deformation_lr_delay_mult: float = 0.01
    grid_lr_init: float = 0.0016
    grid_lr_final: float = 0.00016
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.0
    lambda_lpips: float = 0.0
    weight_constraint_init: float = 1.0
    weight_constraint_after: float = 0.2
    weight_decay_iteration: int = 5000
    opacity_reset_interval: int = 3000
    densification_interval: int = 100
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold_coarse: float = 0.0002
    densify_grad_threshold_fine_init: float = 0.0002
    densify_grad_threshold_after: float = 0.0002
    pruning_from_iter: int = 500
    pruning_interval: int = 100
    opacity_threshold_coarse: float = 0.005
    opacity_threshold_fine_init: float = 0.005
    opacity_threshold_fine_after: float = 0.005
    batch_size: int = 1
    add_point: bool = False


@dataclass
class TpuParams:
    """TPU-native knobs with no reference counterpart (SURVEY.md §7)."""

    # Fixed-capacity primitive budget (alive-mask design). The reference's
    # densify gate caps P at 360k (train.py:357); capacity must exceed it.
    capacity: int = 400_000
    # Initial [P]-array capacity. 0 = auto: the 16384-multiple covering
    # 4× the init cloud, capped by `capacity`; the training loop then
    # doubles it toward `capacity` when densification fills 60% of slots
    # (models.gaussians.grow_capacity) — small scenes never pay big-cap
    # array math. Set equal to `capacity` to pin the old fixed behavior.
    capacity_init: int = 0
    # Static tile-pipeline budgets; grown (with recompile) on overflow.
    instance_budget: int = 1 << 21
    # ABSOLUTE ceiling for budget growth: transient demand spikes (the
    # untrained deformation heads inflate coarse-trained scales at
    # fine-stage start — observed 420k → 13M instances in one step) must
    # not commit the run to a huge-K program; beyond the cap the binning
    # truncates the deepest instances (graceful LOD) until demand
    # normalizes. CUDA reallocates per step and shrinks again
    # (rasterizer_impl.cu:281-286); a grow-only static budget needs this
    # ceiling instead.
    instance_budget_max: int = 4 << 20
    tile_budget: int = 4096
    blend_chunk: int = 256
    # Rasterizer backend: "pallas" (production TPU kernels) | "tile"
    # (pure-JAX tiled fallback) | "reference" (whole-image oracle).
    backend: str = "pallas"
    # Run Pallas kernels under the interpreter (CPU CI / debugging).
    pallas_interpret: bool = False
    # Store the splat payload (screen xy/conic/color/depth) in bfloat16:
    # halves binning-gather + kernel-DMA bytes (~7% step speedup). In-kernel
    # math stays float32. Off by default to keep bit-level reference parity.
    payload_bf16: bool = False
    # PRE-SLOT ellipse-vs-tile culling (ops.binning._rect_cull_mask):
    # output-exact (drops only instances whose every pixel the blend α-floor
    # gate zeroes) and applied BEFORE slot allocation, so dead corner tiles
    # consume no instance budget and every K-length op (sort/gather/blend/
    # scatter) shrinks to true post-cull demand. Cost: a fused 32-cell mask
    # pass over [P] + a 5-step bit-select per slot.
    ellipse_tile_cull: bool = False
    # Fused multi-step dispatch: the single-device training loop runs up to
    # this many train steps as ONE jitted lax.scan program (chunks clamped
    # to the log/densify/SH gate cadences). Amortizes the ~2-3 ms per-call
    # host dispatch latency of the remote-attached TPU. 1 disables.
    scan_steps: int = 10
    # Sanitize the parameter-gradient tree each step (non-finite -> 0 /
    # +-1e12): the reference's answer to gradient blow-ups is a NaN
    # watchdog + process restart (train.py:263-265); ours contains the
    # blast instead - a diverging Gaussian takes a bounded Adam step and
    # recovers (or is culled) rather than poisoning shared parameters.
    sanitize_grads: bool = True
    # Mesh axes for multi-chip training: cameras over 'data', primitive/tile
    # work over 'model' (SURVEY.md §2.7).
    mesh_data: int = 1
    mesh_model: int = 1
    # [P]-sharded fallback (parallel.trainer): params + Adam moments sharded
    # on 'model' with a per-step all-gather (FSDP pattern). Off by default —
    # replication is faster below ~5M primitives on 16 GB chips; turn on
    # when replicated params+moments approach a chip's free HBM.
    shard_primitives: bool = False
    # Shard deformation + preprocess over 'model': each shard computes the
    # [P/N] slice of the per-Gaussian screen attributes and all-gathers the
    # packed 16-column payload table (~4 MB at 65k) — the deform+preprocess
    # compute scales 1/N instead of being replicated per shard (the main
    # N-independent term of the model-axis efficiency curve, SCALING.md).
    # Requires capacity % mesh_model == 0.
    shard_preprocess: bool = True


@dataclass
class Config:
    model: ModelParams = field(default_factory=ModelParams)
    pipe: PipelineParams = field(default_factory=PipelineParams)
    hidden: ModelHiddenParams = field(default_factory=ModelHiddenParams)
    opt: OptimizationParams = field(default_factory=OptimizationParams)
    tpu: TpuParams = field(default_factory=TpuParams)

    # name of the dataset family the overrides came from (dnerf/dynerf/...)
    family: str = ""


_GROUPS = {
    "ModelParams": "model",
    "PipelineParams": "pipe",
    "ModelHiddenParams": "hidden",
    "OptimizationParams": "opt",
    "TpuParams": "tpu",
}


def _apply_overrides(cfg: Config, overrides: dict[str, Any]) -> Config:
    """Merge an mmengine-style dict {GroupName: {knob: value}} into cfg.

    Like the reference merge_hparams (utils/params_utils.py:1-9) the merge is
    effectively flat: a knob listed under the "wrong" group header still
    applies to whichever group owns it (the reference's config files rely on
    this, e.g. render_process inside OptimizationParams in
    arguments/dnerf/dnerf_default.py). A knob that exists on no group raises
    (stricter than the reference's silent skip, which hides typos).
    """
    all_groups = [getattr(cfg, a) for a in _GROUPS.values()]
    for group_name, knobs in overrides.items():
        if group_name == "_base_":
            continue
        attr = _GROUPS.get(group_name)
        if attr is None:
            raise KeyError(f"unknown config group {group_name!r}")
        preferred = getattr(cfg, attr)
        for k, v in knobs.items():
            group = preferred
            if not hasattr(group, k):
                group = next((g for g in all_groups if hasattr(g, k)), None)
            if group is None:
                raise KeyError(f"no config group has knob {k!r}")
            if k == "kplanes_config" and isinstance(v, dict):
                v = KPlanesConfig(
                    **{kk: tuple(vv) if kk == "resolution" else vv
                       for kk, vv in v.items()}
                )
            elif isinstance(getattr(group, k), tuple) and isinstance(v, list):
                v = tuple(v)
            setattr(group, k, v)
    return cfg


def _load_override_module(path: str | pathlib.Path) -> dict[str, Any]:
    """Load a config override file (a Python module of group dicts).

    Equivalent of mmengine.Config.fromfile with `_base_` inheritance
    (reference arguments/dnerf/bouncingballs.py:1-10): the file may define
    ``_base_ = "relative/other.py"`` plus group dicts.
    """
    path = pathlib.Path(path)
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out: dict[str, Any] = {}
    base = getattr(mod, "_base_", None)
    if base is not None:
        out.update(_load_override_module(path.parent / base))
    for name in _GROUPS:
        if hasattr(mod, name):
            merged = dict(out.get(name, {}))
            merged.update(getattr(mod, name))
            out[name] = merged
    return out


def load_config(path: str | pathlib.Path | None = None, **kw) -> Config:
    """Build a Config, optionally merging an override file then kwargs.

    kwargs use dotted keys, e.g. ``load_config(p, **{"opt.iterations": 100})``.
    """
    cfg = Config()
    if path is not None:
        _apply_overrides(cfg, _load_override_module(path))
    for key, value in kw.items():
        group_attr, _, knob = key.partition(".")
        group = getattr(cfg, _GROUPS.get(group_attr, group_attr), None)
        if group is None or not hasattr(group, knob):
            raise KeyError(f"unknown config key {key!r}")
        if knob == "kplanes_config" and isinstance(value, dict):
            value = KPlanesConfig(
                **{kk: tuple(vv) if kk == "resolution" else vv
                   for kk, vv in value.items()}
            )
        elif isinstance(getattr(group, knob), tuple) and isinstance(value, list):
            value = tuple(value)
        setattr(group, knob, value)
    return cfg


def config_to_dict(cfg: Config) -> dict:
    return dataclasses.asdict(cfg)


def config_from_dict(d: dict) -> Config:
    """Rebuild a Config from a ``config_to_dict`` dump (cfg_args.json).

    The inverse of the cfg replay dump train.py writes — lets offline tools
    (scripts/gradient_from_checkpoint.py, render.py) reconstruct the exact
    training configuration of a saved model.
    """
    cfg = Config()
    for attr in set(_GROUPS.values()):
        gdict = d.get(attr)
        if not isinstance(gdict, dict):
            continue
        group = getattr(cfg, attr)
        for k, v in gdict.items():
            if not hasattr(group, k):
                continue
            if k == "kplanes_config" and isinstance(v, dict):
                v = KPlanesConfig(
                    **{kk: tuple(vv) if kk == "resolution" else vv
                       for kk, vv in v.items()}
                )
            elif isinstance(getattr(group, k), tuple) and isinstance(v, list):
                v = tuple(v)
            setattr(group, k, v)
    return cfg
