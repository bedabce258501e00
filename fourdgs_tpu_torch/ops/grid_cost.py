"""Grid-cost probes: the CUDA kernels' wrappers, their plain PyTorch versions
and :data:`PROBES`, the one table of their facts.

Counterparts of the TPU kernels of ``scripts/exp_grid_cost.py`` (:44-152),
which write constant blocks over a grid of T tiles of N = 256 pixels to time
the per-grid-step cost of the blend kernels. All run ``csrc/grid_cost.cu``;
the source says how each TPU grid maps to Hopper blocks.

=====  ====================  =======================  ======================
id     JAX kernel (call)     wrapper                  output
=====  ====================  =======================  ======================
K4     ``k1`` parallel :53   :func:`ones_parallel`    ones [T, 256, 1]
K4     ``k1`` arbitrary :53  :func:`ones_sequential`  ones [T, 256, 1]
K5     ``k3`` :67            :func:`ones_three`       ones [T,256,3], [T,256,1] ×2
K6     ``k1`` as c=5 :78     :func:`ones_broadcast5`  ones [T, 256, 5]
K7     ``k5`` :88            :func:`ones5`            ones [T, 256, 5]
K8     ``kp`` :100           :func:`ones5_pairs`      ones [T, 256, 5], T even
K9     ``kw`` :119           :func:`iota_px`          n % 16 [T, 256, 1]
K10    ``kwl`` :146          :func:`while_ones`       ones [T, 256, 1]
=====  ====================  =======================  ======================

K6's JAX kernel stores a (256, 1) value into a (256, 5) block, which its
trace rejects (``ValueError``) when it is traced: the script never calls it,
since it rebinds ``f5`` at :88 first. The port computes its intended
function, the value broadcast over the 5 channels, which is K7's output.

K4's two mappings store a tile's 1 KB as float4, a warp per tile:
``parallel`` at 8 tiles per block of 256 threads (ceil(T / 8) blocks, 313 at
T = 2,500), ``arbitrary`` as one persistent block per SM whose warps stride
over the tiles (:func:`sequential_blocks`); ``csrc/grid_cost.cu`` gives the
layouts they were measured against. K9 takes K4 ``parallel``'s mapping with
each pixel's column n % 16 in place of the ones; of the TPU kernel's
128×128 triangle ``i < j`` only the entry at (0, 0) reaches the output, and
the kernel computes that compare in registers instead of building the
triangle, so it uses no shared memory and no barrier. Their bound is the
2.56 MB output written once, 0.76 µs at 3.35 TB/s: below a launch's own
latency, so the probes measure the launch and its blocks.

K7 and K8 store their tiles' 12.8 MB (bound 3.8 µs at 3.35 TB/s, also
under the launch's latency) as float4, a warp per TPU block: K7 a warp per
tile, 4 tiles per block of 128 threads; K8 a warp per pair of tiles, 2 pairs
per block of 64 threads; ceil(T / 4) blocks each (625 at T = 2,500). Past
the launch, their time follows the bytes the busiest SM stores, so a block
writes 20 KB and an SM holds at most 5 blocks; 8 tiles (or pairs) per block
of 256 threads, 313 (157) blocks, put 120 (160) KB on some SMs and lost
4–6% (17–19%) to it on an H100. ``csrc/grid_cost.cu`` lists the mappings measured
against these, with their times.

Each wrapper takes the tile count T and ``device`` (default ``"cuda"``,
raising without CUDA unless ``device="cpu"``); :func:`while_ones` takes the
per-tile loop counts ``s`` [T] int32 and runs where they lie. On the CPU a
wrapper runs its plain version; on the card it launches its kernel, counts it
in ``<wrapper>.launches``, or raises. The plain versions take the device
with no default.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from fourdgs_tpu_torch import resolve_device
from fourdgs_tpu_torch.ops import _build
from fourdgs_tpu_torch.ops import constants as C

N = C.N_PIX   # pixels per tile
_P, _I = _build.PTR, _build.INT


def _device(num_tiles: int, device) -> torch.device:
    if not isinstance(num_tiles, int) or num_tiles < 0:
        raise ValueError(f"num_tiles must be an int >= 0, got {num_tiles!r}")
    if num_tiles * N * 5 >= 2**31:
        raise ValueError(f"num_tiles = {num_tiles} overflows the kernels' sizes")
    return resolve_device(device)


def _empty(num_tiles: int, channels: int, dev: torch.device) -> torch.Tensor:
    return torch.empty((num_tiles, N, channels), dtype=torch.float32, device=dev)


def _launch(entry: str, argtypes, dev: torch.device, *args) -> None:
    _build.launch("grid_cost", f"fourdgs_{entry}", argtypes, dev, *args)


# -- plain versions ----------------------------------------------------------


def ones_plain(num_tiles: int, device) -> torch.Tensor:
    return torch.ones((num_tiles, N, 1), dtype=torch.float32, device=device)


def ones5_plain(num_tiles: int, device) -> torch.Tensor:
    return torch.ones((num_tiles, N, 5), dtype=torch.float32, device=device)


def ones_three_plain(num_tiles: int, device):
    return tuple(torch.ones((num_tiles, N, c), dtype=torch.float32, device=device)
                 for c in (3, 1, 1))


def ones_broadcast5_plain(num_tiles: int, device) -> torch.Tensor:
    """The (256, 1) value of ``k1`` broadcast over 5 channels."""
    return ones_plain(num_tiles, device).expand(num_tiles, N, 5).contiguous()


def iota_px_plain(num_tiles: int, device) -> torch.Tensor:
    """``out[t, n, 0] = n % 16``: the pixel's column in its tile."""
    px = (torch.arange(N, device=device) % C.TILE_X).to(torch.float32)
    return px[None, :, None].expand(num_tiles, N, 1).contiguous()


def while_ones_plain(s: torch.Tensor) -> torch.Tensor:
    return torch.ones((s.shape[0], N, 1), dtype=torch.float32, device=s.device)


# -- wrappers ----------------------------------------------------------------


def _probe(entry: str, channels: int, plain, doc: str):
    """The wrapper of ``fourdgs_<entry>``, filling one [T, 256, channels]
    output."""

    def wrapper(num_tiles: int, device="cuda") -> torch.Tensor:
        dev = _device(num_tiles, device)
        if dev.type == "cpu":
            return plain(num_tiles, dev)
        out = _empty(num_tiles, channels, dev)
        if num_tiles:
            _launch(entry, [_P, _I, _P], dev, out, num_tiles)
            wrapper.launches += 1
        return out

    wrapper.__name__ = wrapper.__qualname__ = entry
    wrapper.__doc__ = doc
    wrapper.launches = 0
    return wrapper


ones_broadcast5 = _probe("ones_broadcast5", 5, ones_broadcast5_plain,
                         "K6: k1's per-pixel value broadcast over 5 channels, "
                         "each warp storing its pixels' floats as float4.")
ones5 = _probe("ones5", 5, ones5_plain,
               "K7: ones [T, 256, 5], a warp storing each tile's 1280 floats as "
               "float4, 4 tiles per block of 128 threads.")
iota_px = _probe("iota_px", 1, iota_px_plain,
                 "K9: n % 16 [T, 256, 1], a warp storing each tile's 256 "
                 "columns as float4, 8 tiles per block of 256 threads; the "
                 "triangle's one entry that reaches the output is a compare "
                 "in registers.")


def ones_parallel(num_tiles: int, device="cuda") -> torch.Tensor:
    """K4, "parallel": ones [T, 256, 1], a warp per tile storing it as two
    float4 a lane, 8 tiles per block of 256 threads."""
    dev = _device(num_tiles, device)
    if dev.type == "cpu":
        return ones_plain(num_tiles, dev)
    out = _empty(num_tiles, 1, dev)
    if num_tiles:
        _launch("ones_parallel", [_P, _I, _P], dev, out, num_tiles)
        ones_parallel.launches += 1
    return out


def sm_count(dev: torch.device) -> int | None:
    """The card's SM count; None off the card."""
    if dev.type != "cuda":
        return None
    return torch.cuda.get_device_properties(dev).multi_processor_count


def sequential_blocks(num_tiles: int, n_sm: int) -> int:
    """K4 "arbitrary"'s grid: one persistent block per SM, no more than the
    ceil(T / 8) blocks that give each warp a tile."""
    return min(n_sm, -(-num_tiles // TILES_PER_BLOCK["warp"]))


def ones_sequential(num_tiles: int, device="cuda") -> torch.Tensor:
    """K4, "arbitrary": ones [T, 256, 1], one persistent block of 256
    threads per SM (:func:`sequential_blocks`), each warp striding over the
    tiles and storing each as two float4 a lane."""
    dev = _device(num_tiles, device)
    if dev.type == "cpu":
        return ones_plain(num_tiles, dev)
    out = _empty(num_tiles, 1, dev)
    if num_tiles:
        blocks = sequential_blocks(num_tiles, sm_count(dev))
        _launch("ones_sequential", [_P, _I, _I, _P], dev, out, num_tiles, blocks)
        ones_sequential.launches += 1
    return out


def ones_three(num_tiles: int, device="cuda"):
    """K5: ones into three outputs [T, 256, 3], [T, 256, 1], [T, 256, 1]."""
    dev = _device(num_tiles, device)
    if dev.type == "cpu":
        return ones_three_plain(num_tiles, dev)
    outs = tuple(_empty(num_tiles, c, dev) for c in (3, 1, 1))
    if num_tiles:
        _launch("ones_three", [_P, _P, _P, _I, _P], dev, *outs, num_tiles)
        ones_three.launches += 1
    return outs


def ones5_pairs(num_tiles: int, device="cuda") -> torch.Tensor:
    """K8: ones [T, 256, 5], a warp storing each pair of tiles' 2560
    floats as float4, 2 pairs per block of 64 threads; T must be even (the
    JAX grid of T // 2 steps leaves an odd T's last tile unwritten)."""
    if isinstance(num_tiles, int) and num_tiles % 2:
        raise ValueError(f"num_tiles = {num_tiles} must be even")
    dev = _device(num_tiles, device)
    if dev.type == "cpu":
        return ones5_plain(num_tiles, dev)
    out = _empty(num_tiles, 5, dev)
    if num_tiles:
        _launch("ones5_pairs", [_P, _I, _P], dev, out, num_tiles)
        ones5_pairs.launches += 1
    return out


def while_ones(s: torch.Tensor) -> torch.Tensor:
    """K10: ones [T, 256, 1], the warp of tile t storing its ones and then
    running a loop of ``s[t]`` iterations (zeros where the counter ends
    wrong); 8 tiles per block."""
    if s.dtype != torch.int32 or s.dim() != 1 or not s.is_contiguous():
        raise ValueError(f"s must be contiguous int32 [T], got {s.dtype} {tuple(s.shape)}")
    num_tiles = s.shape[0]
    dev = _device(num_tiles, s.device)
    if dev.type == "cpu":
        return while_ones_plain(s)
    out = _empty(num_tiles, 1, dev)
    if num_tiles:
        _launch("while_ones", [_P, _P, _I, _P], dev, s, out, num_tiles)
        while_ones.launches += 1
    return out


for _f in (ones_parallel, ones_sequential, ones_three, ones5_pairs, while_ones):
    _f.launches = 0
del _f


# -- the table ---------------------------------------------------------------


class Probe(NamedTuple):
    """One probe: its kernel's id, wrapper and plain version, and what the
    experiment and the chip check need to know of it."""

    id: str
    fn: Callable       # the wrapper; ``fn.launches`` counts its launches
    plain: Callable    # the plain version, on the wrapper's arguments
    floats: int        # floats written per pixel, all outputs together
    grid: str          # "tile": a block per tile, "warp": one per 8
    #                    tiles, a warp each, "warp4": one per 4 tiles, a
    #                    warp each, "warp_pair": one per 2 pairs of tiles
    #                    (4 tiles), a warp each, "sm": a persistent block
    #                    per SM, its warps striding over the tiles
    site: str          # the JAX ``pallas_call``
    label: str         # the JAX script's printed label
    ones: bool         # ``torch.ones((T, 256, floats))``, the fill of the
    #                    same bytes, is the same output

    def args(self, num_tiles: int, dev: torch.device) -> tuple:
        """The experiment's arguments: K10 gets zero loop counts, as in the
        JAX script; the others the tile count and the device."""
        if self.fn is while_ones:
            return (torch.zeros(num_tiles, dtype=torch.int32, device=dev),)
        return (num_tiles, dev)

    def check_args(self, dev: torch.device) -> list[tuple]:
        """Arguments that hold the kernel to its plain version at the edges
        of its grid: T in :data:`EDGE_TILES` (1, 7 and 2,501 end in a
        part-filled block of 4 or 8 tiles, 16 fills whole blocks of both;
        K8 takes the even T at or above each, whose last block of 2 pairs is
        half full at 2 and 2,502), and K10 with zero, positive (t % 7) and
        mixed negative ((t % 7) − 3) loop counts at each."""
        cases = []
        for t in EDGE_TILES:
            if self.grid == "warp_pair":
                t += t % 2
            if self.fn is while_ones:
                i = torch.arange(t, dtype=torch.int32, device=dev)
                cases += [(torch.zeros_like(i),), (i % 7,), (i % 7 - 3,)]
            else:
                cases.append((t, dev))
        return cases

    def blocks(self, num_tiles: int, dev: torch.device) -> int | None:
        """Blocks of one launch over T tiles (None for "sm" off the card,
        which has no SM count there)."""
        if self.grid == "sm":
            n_sm = sm_count(dev)
            return None if n_sm is None else sequential_blocks(num_tiles, n_sm)
        return -(-num_tiles // TILES_PER_BLOCK[self.grid])


TILES_PER_BLOCK = {"tile": 1, "warp": 8, "warp4": 4, "warp_pair": 4}
EDGE_TILES = (1, 7, 16, 2500, 2501)


_SITE = "scripts/exp_grid_cost.py"
PROBES = (
    Probe("K4", ones_parallel, ones_plain, 1, "warp", f"{_SITE}:53",
          "1 out blk, parallel", True),
    Probe("K4", ones_sequential, ones_plain, 1, "sm", f"{_SITE}:53",
          "1 out blk, arbitrary", True),
    Probe("K5", ones_three, ones_three_plain, 5, "tile", f"{_SITE}:67",
          "3 out blks, arbitrary", False),
    Probe("K6", ones_broadcast5, ones_broadcast5_plain, 5, "tile", f"{_SITE}:78",
          "k1 into blk[5] (K6)", True),
    Probe("K7", ones5, ones5_plain, 5, "warp4", f"{_SITE}:88",
          "1 out blk[5], arbitrary", True),
    Probe("K8", ones5_pairs, ones5_plain, 5, "warp_pair", f"{_SITE}:100",
          "paired grid/2 blk[2,5]", True),
    Probe("K9", iota_px, iota_px_plain, 1, "warp", f"{_SITE}:119",
          "1 blk + tri/px iotas", False),
    Probe("K10", while_ones, while_ones_plain, 1, "warp", f"{_SITE}:146",
          "1 blk + 0-iter while", True),
)
