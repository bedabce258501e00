"""Numerical constants defining rasterizer behaviour.

The port's copy of ``fourdgs_tpu/ops/constants.py`` (values asserted equal by
the tests), plus the blend layout constants of ``fourdgs_tpu/ops/pallas_blend.py``
(``CHUNK``, ``ALIGN``, ``FEAT_ROWS``, ``OUT5``). They pin down the semantics of
the reference CUDA rasterizer (forward.cu:74-354 of the 4DGS rasterizer):
EWA clamp and dilation, α cap and floor, transmittance stop.
"""

TILE_X = 16           # image tile width in pixels
TILE_Y = 16           # image tile height in pixels
NUM_CHANNELS = 3

NEAR_PLANE_Z = 0.2          # cull Gaussians with view-space z <= this
EWA_CLAMP_FACTOR = 1.3      # clamp |x/z| to 1.3*tanfov before the EWA Jacobian
COV2D_DILATION = 0.3        # added to cov2D diagonal (antialias low-pass)
ALPHA_CAP = 0.99            # α = min(0.99, opacity * exp(power))
ALPHA_FLOOR = 1.0 / 255.0   # contributions with α below this are skipped
T_STOP = 1e-4               # blending stops once transmittance would drop below
W_EPS = 1e-7                # homogeneous divide: 1/(w + 1e-7)
RADIUS_SIGMA = 3.0          # screen radius = ceil(3·sqrt(λmax))
DET_FLOOR = 0.1             # floor inside sqrt of eigenvalue discriminant

N_PIX = TILE_X * TILE_Y     # 256 pixels per tile
CHUNK = 128                 # instances per blend window chunk
ALIGN = 8                   # window start alignment, in instances
FEAT_ROWS = 16              # payload rows: x, y, conic a/b/c, opacity, r, g, b, depth, 6 pad
OUT5 = 5                    # packed blend output channels: r, g, b, depth, t_fin
