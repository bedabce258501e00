"""Deformation network: HexPlane features → per-Gaussian deltas, PyTorch.

Counterpart of ``fourdgs_tpu/models/deformation.py:45-183``:

  feature_out = Linear(feat_dim → W) + (D−1) × [ReLU, Linear(W → W)]
  five heads, each  [ReLU, Linear(W → W), ReLU, Linear(W → head_out)]:
      pos → 3, scales → 3, rotations → 4, opacity → 1, shs → K·3

``forward`` applies the deltas to the *raw* parameters (activations come
after, in ``render``); the ``no_d*`` flags leave a parameter unchanged, and
``apply_rotation`` composes the rotation delta as a quaternion product. The
``timenet`` layers are created for checkpoint parity and never run, as on the
JAX side.

Init from a numpy seed: Xavier-uniform weights, torch-default biases
U(±1/√fan_in), and zeroed last head layers under ``zero_init_heads``. The
layers are ``nn.Linear`` (weight [out, in]); ``interop`` transposes to and
from the JAX layout [in, out].
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from fourdgs_tpu_torch import resolve_device
from fourdgs_tpu_torch.models import hexplane
from fourdgs_tpu_torch.utils import quaternion as quat

HEADS = ("pos", "scales", "rotations", "opacity", "shs")


def _linear(rng: np.random.Generator, fan_in: int, fan_out: int, zero=False):
    lin = nn.utils.skip_init(nn.Linear, fan_in, fan_out)
    if zero:
        w = np.zeros((fan_out, fan_in), np.float32)
        b = np.zeros((fan_out,), np.float32)
    else:
        limit_w = math.sqrt(6.0 / (fan_in + fan_out))
        w = rng.uniform(-limit_w, limit_w, (fan_out, fan_in))
        limit_b = 1.0 / math.sqrt(fan_in)
        b = rng.uniform(-limit_b, limit_b, (fan_out,))
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.asarray(w, np.float32)))
        lin.bias.copy_(torch.from_numpy(np.asarray(b, np.float32)))
    return lin


def _mlp(layers, x: torch.Tensor, relu_first: bool) -> torch.Tensor:
    for i, lyr in enumerate(layers):
        if relu_first or i > 0:
            x = torch.relu(x)
        x = lyr(x)
    return x


class Deformation(nn.Module):
    """HexPlane planes + feature MLP + the five delta heads."""

    def __init__(self, hidden, sh_coeffs: int, seed: int = 0,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.hidden = hidden
        rng = np.random.default_rng(seed)
        W = hidden.net_width
        D = hidden.defor_depth
        if hidden.no_grid:
            planes = {}
            in_dim = 4
        else:
            planes = hexplane.init_hexplane(
                rng, hidden.kplanes_config, hidden.multires)
            in_dim = hexplane.feat_dim(hidden.kplanes_config, hidden.multires)
        self.grids = nn.ParameterDict(
            {k: nn.Parameter(torch.from_numpy(v)) for k, v in planes.items()}
        )
        self.feature_out = nn.ModuleList(
            [_linear(rng, in_dim, W)]
            + [_linear(rng, W, W) for _ in range(max(D - 1, 0))]
        )
        head_out = {"pos": 3, "scales": 3, "rotations": 4, "opacity": 1,
                    "shs": sh_coeffs * 3}
        self.heads = nn.ModuleDict({
            h: nn.ModuleList([
                _linear(rng, W, W),
                _linear(rng, W, head_out[h], zero=hidden.zero_init_heads),
            ])
            for h in HEADS
        })
        times_ch = 2 * hidden.timebase_pe + 1
        self.timenet = nn.ModuleList([
            _linear(rng, times_ch, hidden.timenet_width),
            _linear(rng, hidden.timenet_width, hidden.timenet_output),
        ])
        self.to(dev)

    def query_time(self, aabb, xyz, t) -> torch.Tensor:
        """HexPlane features → hidden vector; ``t`` is 0-d or per point."""
        if self.hidden.no_grid:
            t_col = t.reshape(-1, 1).expand(xyz.shape[0], 1)
            h = torch.cat([xyz, t_col], dim=-1)
        else:
            h = hexplane.query_hexplane(
                self.grids, aabb, xyz, t, len(self.hidden.multires))
        # feature_out: the first Linear has no ReLU before it
        return _mlp(self.feature_out, h, relu_first=False)

    def forward(self, aabb, xyz, scales, rotations, opacity, shs, t):
        """Raw (xyz [N,3], log-scales [N,3], quats [N,4], opacity logits
        [N,1], shs [N,K,3]) at time ``t`` → the deformed raw tuple."""
        hidden = self.hidden
        hvec = self.query_time(aabb, xyz, t)

        def head(name):
            return _mlp(self.heads[name], hvec, relu_first=True)

        out_xyz = xyz if hidden.no_dx else xyz + head("pos")
        out_scales = scales if hidden.no_ds else scales + head("scales")
        if hidden.no_dr:
            out_rot = rotations
        elif hidden.apply_rotation:
            out_rot = quat.multiply(rotations, head("rotations"))
        else:
            out_rot = rotations + head("rotations")
        out_op = opacity if hidden.no_do else opacity + head("opacity")
        out_shs = (shs if hidden.no_dshs
                   else shs + head("shs").reshape(shs.shape))
        return out_xyz, out_scales, out_rot, out_op, out_shs
