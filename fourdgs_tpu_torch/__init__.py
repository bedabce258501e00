"""fourdgs_tpu_torch: the PyTorch + CUDA port of fourdgs_tpu for an NVIDIA H100.

The JAX package ``fourdgs_tpu`` stays the reference; this package imports
nothing of it (nor of JAX) and keeps its own copies of the JAX-free modules it
needs. Module names follow the JAX package so each counterpart is easy to find.

Slice 1 ports the serving path: the fine- (and coarse-) stage forward render
(``fourdgs_tpu_torch.render.render``), whose tile blend runs as a hand-written
CUDA kernel (``csrc/blend_forward.cu``, wrapped by ``ops.blend``).

Every entry point takes ``device`` (default ``"cuda"``) and raises when CUDA is
absent unless the caller asks for ``device="cpu"``, where each kernel wrapper
runs its plain PyTorch version.
"""

import torch

# The JAX side runs its float32 products at Precision.HIGHEST
# (models/hexplane.py); TF32 would keep only ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises rather than falling back to
    the CPU when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
