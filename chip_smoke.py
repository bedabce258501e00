"""Chip smoke test of the PyTorch + CUDA port (``fourdgs_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. It imports nothing of JAX or ``fourdgs_tpu``
and fails (exit code != 0, no result line) without CUDA. Phases, each fatal
on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel of ``fourdgs_tpu_torch/csrc`` (nvcc, sm_90a) and print
   the build time and ptxas report, each kernel's by name; K9's
   ``iota_px_kernel`` must use no shared memory and no barrier;
3. the forward blend kernel (K1) and the backward blend kernel (K2) against
   their plain PyTorch versions on synthetic inputs: windows straddling
   chunk boundaries, a tile longer than 3 chunks, a saturated tile, a tile
   of near-singular conics, empty tiles, trailing empty tiles at start == K
   and a nonzero tile-row offset/stride; K2 with a random cotangent. Each
   kernel with its per-warp cull equals its walk of every in-range instance
   (the ``_cull=False`` test hook) bit for bit, K2 twice gives the same
   bits, and the strip masks the kernels stage equal their plain mirror's
   (``blend.strip_masks``), here, on the cull's edge cases, at view 10 and
   at the last train step; the gated counts come from those masks;
4. the full-width render of the D-NeRF ``lego`` preset (multires (1, 2),
   net_width 64, 64³×25 K-planes × 32 features, sh degree 3, white
   background) over 60,000 random Gaussians in capacity 65,536, 800×800:
   1 warm-up view and 20 timed views through ``render``; the K1 launch count
   must rise by exactly 21. Then K1 at that view's shapes: device time per
   call with and without the cull, the plain version's time, the bound on
   the kept pairs reached before T_STOP, on kept pairs and on all in-range
   pairs, the share of pairs the cull leaves
   to the gates, the tile lengths and agreement (``profile_render_torch.py``
   breaks a view down by stage);
5. a snapshot round trip (save, load, render) that must match bit for bit;
6. the fine-stage train step of the same preset and scene at 800×800,
   batch 1, against a GT rendered by the port from a second seeded scene
   and tiled once: 3 warm-up and 20 timed steps through ``make_train_step``
   (trained pixels/s as ``bench.py`` counts them, ms per step, peak memory);
   exactly one K1 and one K2 launch per step, a finite loss that falls,
   demand within the budget. Then K2 at the last step's shapes and
   cotangent: agreement, time (and, as for K1 in phase 4, without the cull),
   plain time, both bounds, the pair shares and K2's shuffles per live
   warp-instance, and two backward passes (K2 and the per-Gaussian segment
   sum) that must agree bit for bit (``profile_train_torch.py`` breaks a step
   down by stage);
7. the cost experiments of ``fourdgs_tpu_torch/scripts``, each through its
   ``run()`` with the launch counts zeroed just before it and read just
   after: ``exp_gather`` (K3, the column gather, beside the PyTorch gather
   layouts and backwards, at the JAX script's shape and the render's
   2,097,152-slot shape), ``exp_grid_cost`` (the probes K4–K10 over 2500
   tiles) and ``exp_kernel_overhead`` (K1 and K2 on empty, 98- and
   128-per-tile grids: per-tile fixed cost and per-instance cost). Then K3
   bit for bit against ``index_select(1)`` at P in 1, 17, 65,536, 65,537 by
   K in 1, 31, 33, 393,216, 2,097,152, with NaN columns for ids −1 and P and
   nothing launched at K = 0, and at both shapes, with its two passes'
   hooks bit for bit against ``table.T`` and the call, and their times
   (staging, gather) beside ``index_select(1)`` and the render path's
   ``index_select(0).T``; each probe bit for bit against its plain version,
   writing into memory filled with NaN just before (:func:`check_probe`),
   at the experiment's 2,500 tiles and at T = 1, 7, 16, 2,500 and 2,501
   (K8 at the even T at or above each; K10 with zero, positive and mixed
   negative loop counts at each), K1 and K2 on the three grids against
   theirs (the bounds above), each launch counted; the times of the plain
   versions and of the one-call PyTorch yardsticks, and ``torch.ones`` of
   each probe's bytes as ``exp_grid_cost.run()`` read it in turns with the
   probe (``vs_fill``; the library call where it computes the probe's output);
8. one JSON line ``{"kernels": [...]}`` and, last, the result line
   ``{"ok": true, "device": {...}}``; before them phases 9 to 17, the
   seconds of phases 10 to 17 and the script's own time:
9. training from a point cloud (``bench_quality_torch.py``, bf16 payload):
   (a) the bouncingballs preset at ``--gt oracle --scale 0.0075`` (cut from
   0.03 as phases were added, and from 0.01 to pay for phase 18's B-coded
   camera; 50 coarse + 150 fine steps at 800×800 from 2,000 random points,
   the launch counts zeroed
   just before the training and read after the eval): K2 launches equal
   the renders of its steps, K1 launches those plus the 10 eval views, every
   logged loss finite, the last logged train PSNR above the first; the
   held-out PSNR, final points, wall and it/s printed. Then K1 and K2 at
   the shapes of a train step of the trained model (train view 0, the
   grown budget, the step's L1 cotangent against the oracle frame: opaque
   splats, pixels that reach T_STOP) against their plain versions, the
   cull against the walk and the strip masks against their mirror, as in
   phases 4 and 6, with their times and bounds at this shape. (b) A
   256×256 run with GT from K1 whose gates fire early (capacity 2,048,
   densify and prune every 20 from iteration 20, an opacity reset at 60;
   60 coarse + 40 fine iterations): capacity growth and the reset must
   fire. (c) The maintenance (capacity growth, clone, split, prune, opacity
   reset) on one state on the card and on the CPU: alive, table and counts
   equal, the parameters and moments within rtol 1e-6 of their operands
   (:func:`check_maintenance_on_card`);
10. the user's entry points, each with the launch counts zeroed just before
   it and read just after: (a) ``bench_torch.py`` at its full size (K1 once
   for the GT frame and once per step, K2 once per step: 24 and 23), its
   JSON line, it/s and card printed; then K1 and K2 at the bench's last
   step (its camera, GT, bf16 table and 393,216 slots, the state after the
   step, the step's L1 cotangent) against their plain versions, the cull
   against the walk and the strip masks against their mirror, with times
   and bounds (``bench`` in the kernels line); (b) a D-NeRF scene written
   with the port's PNG writer (800×800 RGBA frames that K1 renders from
   ``bench_quality_torch.py``'s ground-truth scene, every row
   Paeth-filtered, 20 train and 4 test views, no ``fused.ply``), whose
   ``load_scene`` time is printed, then ``train_torch.py`` on it with the
   bouncingballs preset at full width and a cut schedule (50 coarse + 150
   fine steps; 100 + 300 until PR 16), ``render_torch.py`` (test split) and ``metrics_torch.py``:
   every output ``tests/test_cli.py::test_outputs_exist`` lists exists, the
   fine checkpoint reloads to the same leaves, the rendered PNGs equal the
   in-process render of the same snapshot within one level of 255,
   ``results.json``'s PSNR is finite and above the blank image's, K2
   launches once per step and K1 once per step, eval view and rendered view
   (:func:`check_entry_points`);
11. the DyNeRF path (:func:`check_dynerf_path`), each run with the launch
   counts zeroed just before it and read just after: (a)
   ``bench_quality_dynerf_torch.py`` at ``--scale 0.0075`` (cut from 0.015
   as phases were added; the dynerf preset at
   full width as users run it, sh 3, anisotropic: 50 coarse + 105 fine
   steps of batch 4 with the FineSampler over 11 ring cameras × 150
   timestamps at 676×507, GT from K1 held in memory, its launches counted
   apart): K2 launches equal the renders of its steps, K1 launches those
   plus the 15 eval views, every logged loss finite, the last logged train
   PSNR above the first, no FineSampler warning; the held-out PSNR, points,
   wall, it/s, the grown budget and capacity printed. Then K1 and K2 at the
   shapes of a train step of the trained model (train view 0, batch 4, the
   padded 43×32 grid, the grown budget, the step's L1 cotangent) against
   their plain versions, the cull against the walk and the strip masks
   against their mirror, with times and bounds (``dynerf`` in the kernels
   line); on the grid's padding pixels K1's colour and T equal the plain
   version's, the step's cotangent is 0 and the L1 does not change when
   they are replaced by noise (:func:`check_padding`). (b) The same bench
   at ``--scale 0.0075 --instant4d`` (0.01 until PR 16): finite losses, a rising train PSNR, SH
   degree 0 and three equal scales for every live Gaussian after the
   broadcast. (c) A DyNeRF scene written with the port's PNG writer
   (:func:`write_dynerf_scene`: ``poses_bounds.npy`` for 4 of the bench's
   ring cameras, 6 frames each at the loader's 1352×1014 rendered by K1,
   every filter type in turn, ``points3D_downsample2.ply``), then
   ``train_torch.py`` on it with the dynerf preset at full width, a cut
   schedule (4 coarse + 12 fine steps, cut from 20 + 60 as phases were added) and the
   FineSampler,
   ``render_torch.py`` (test split: camera 0) and ``metrics_torch.py``: the
   outputs of phase 10 (b), the PSNR above the blank image's, every train
   frame decoded by the native prefetcher (none sent to the ref), K2 once
   per render of a step, K1 also once per eval view and rendered view;
   ``load_scene``'s time and the data-loading ms and share of a step
   (``timing_report.json``) printed.
12. the remaining loaders, each run with the launch counts zeroed just
   before it and read just after: (a) a HyperNeRF scene in the vrig layout
   (:func:`write_hypernerf_scene`: 48 portrait phone frames at 540×960 from
   two cameras in turn on an arc, ``warp_id`` = frame index, GT rendered by
   K1 on the preset's white background, covisible masks 0 over the right
   fifth of the val frames, 4,000 noisy surface points as ``points.npy``), then
   ``train_torch.py --debug_mode`` with the
   hypernerf preset at full width (K-planes [64, 64, 64, 150] × 16, multires
   (1, 2, 4), width 128, depth 1, batch 2, ``render_process`` on) and a cut
   schedule (30 coarse + 100 fine steps, cut from 100 + 300 as phases were
   added),
   ``render_torch.py`` and
   ``metrics_torch.py``: the ``render_process`` frames at exactly
   ``should_save_progress``'s iterations of each stage and the debug panels
   every 100, ``render_torch.py``'s ``masks/`` equal to the sources,
   ``metrics_torch.py``'s masked PSNR equal to the same computed here within
   1e-5 dB and above a blank (white) image's, every frame decoded natively
   by the prefetcher, K2 once per render of a step and K1 also once per eval
   view, ``render_process`` frame, debug panel and rendered view; then K1 and
   K2 at a train step of the trained model on the padded 34×60 grid against
   their plain versions, the cull against the walk, the strip masks and the
   padding (:func:`check_padding`), with times and bounds (``hypernerf`` in
   the kernels line). (b) The JPEG decoder on every committed fixture of
   ``tests/torch_fixtures/jpeg`` against Pillow's decodes
   (``pillow_decode.npz``) within 2 levels, mean 0.02, with its ms per
   160×120 frame; a MultipleView scene of the twelve committed frames (3
   cameras × 4, ``sparse_/0`` by the port's COLMAP writers) through the CLI
   chain with the multipleview preset at full width (12 + 36 steps): finite
   losses, every frame sent by the prefetcher to the ref's JPEG decoder,
   renders equal to the in-process render; Panoptic and COLMAP scenes of the
   same frames through ``load_scene``: the cameras' counts and times, every
   frame within the tolerance of Pillow's decode.
13. eval and tools, on phase 10 (b)'s D-NeRF scene (800×800) with the
   bouncingballs preset at full width, each run with the launch counts
   zeroed just before it and read just after (:func:`check_eval_tools`):
   (a) ``train_torch.py --port <free port> --gradient_tracking`` (10 coarse
   + 30 fine steps; 20 + 60 until PR 16) with ``render_torch.py`` and ``metrics_torch.py`` after
   it, while a client thread connects as SIBR does
   (:func:`sibr_client`) and asks for two frames of test camera 0, one with
   ``keep_alive`` on and one without: both arrive as 800×800×3 bytes, not
   constant, with the source path as the verify string;
   ``gradient_report.json`` holds a record every 10 iterations of each
   stage for every group, all finite, ``gradient_timeline.json`` 10 finite
   records; K1 launches once per step, eval view, served frame and timeline
   render, K2 once per step and timeline pass; whether the plots were
   written (matplotlib) is printed. (b) ``export_perframe_3DGS_torch.py``:
   one PLY per test camera, time 0's read back equal to the in-process
   ``get_state_at_time`` within 1e-6. (c) ``merge_many_4dgs_torch.py`` of the
   model twice over (``--rotation_bias 90,0 --motion_bias 0.5,0,0
   --scale_bias 0.8``): one PNG per video camera (160), K1 once per frame,
   frame 0 within one level of the in-process K1 render of the same merged
   set; frames/s printed. (d) ``full_eval_torch.py --skip_train`` over the
   model copied to ``output/dnerf/<scene>`` under a working directory of its
   own: ``render_torch.py`` and ``metrics_torch.py`` run as subprocesses
   with ``--device cuda``, and ``results.json`` exists. (e) The LPIPS trunks
   with random weights, VGG16 and AlexNet, on the card against the CPU on an
   800×800 render and its GT, within 1e-5, with the card's ms per pair;
   whether pretrained weights were found and which columns are null.
   (f) The resampler on every committed fixture of
   ``tests/torch_fixtures/resample`` against Pillow's output (exactly), one
   2704×2028 → 1352×1014 LANCZOS frame timed on the host, and a DyNeRF
   scene of 2 cameras × 3 frames written at 2704×2028 through
   ``load_scene`` and the prefetcher: every frame sent to the ref
   (``to_ref`` = 6) and equal to ``resize`` of its decode, with the ms a
   frame against the coarse step's 73.7 ms.

14. the remaining single-device options (:func:`check_options`), each run
   with the launch counts zeroed just before it and read just after: (a)
   phase 4's lego view with ``tpu.ellipse_tile_cull`` off and on through
   ``render`` (``num_rendered`` of both, K1 once a view, device and wall ms
   a view); K1's output and K2's per-Gaussian payload gradients (after the
   segment sum, under the step's L1 cotangent against phase 6's GT) with
   the cull against without it, equal to 1e-6 apart from pixels whose
   final T lies within 8 ulps of T_STOP (counted, with the pixels and
   Gaussians equal bit for bit); K1 and K2 at the culled shapes against
   their plain versions, with and without the cull's times and bounds
   (``ellipse_tile_cull`` in the kernels line). (b) Phase 6's step with
   ``opt.lambda_dssim = 0.2``, 3 warm-up and 20 timed steps: one K1 and
   one K2 launch a step, a finite falling loss above the L1, ms a step
   beside phase 6's; ``ssim_tiles`` of the last render on the card within
   1e-5 of the float64 SSIM on the CPU, beside the image-space ``ssim``.
   (c) The ``tile`` backend at the lego view (its tile budget the longest
   list rounded up to the blend chunk) against K1's render under the
   association contract, no K1 launched; the ``reference`` backend
   (``fourdgs_tpu_torch/scripts/render_oracle_gt.py``'s oracle) on the
   first two frames of the committed oracle split at 800×800 against
   ``gt_cache/oracle_gt_800_100_10.npz`` as uint8, at most one level
   apart, with the largest difference and the pixels that differ; each
   one's ms a view. Phase 11 (a) also reads the instance demand of its
   trained model's view 0 with the cull off and on (a read only).
15. the sharded trainer (:func:`check_sharded_trainer`; the ranks are
   processes started by ``fourdgs_tpu_torch/parallel/launch.py``, each joined
   with a time limit, a failed or late rank stopping them all; the kernels
   built above, which the ranks load): (a) phase 6's lego scene and preset
   at 800×800 on a 2×2 grid (cameras over ``data``, interleaved tile rows
   over ``model``: K1 and K2 at tile-row offset m and stride 2 inside the
   step), global batch 2 (ring cameras 0 and 1, GT rendered by K1 from the
   second seeded scene), four ranks sharing ``cuda:0`` over gloo, the
   default config (``shard_preprocess``): 3 warm-up and 10 timed steps;
   step 1's parameters, Adam moments, ``xyz_gradient_accum``, ``denom``
   and ``max_radii2d`` against the single-process ``make_train_step`` on
   the same batch (:data:`SHARD_TOL`), every rank's whole state bit-equal
   after the last step (a hash all-gathered), K1 and K2 once per camera of
   the rank per step, the loss finite and falling; each rank's ms a step
   and peak memory, the gradient all-reduce's bytes and ms, and K1/K2 at
   rank 0's slab against their plain versions with times and bounds
   (``sharded_step`` in the kernels line). These times are of four ranks
   time-sliced on one card, not a scaling number. (b) One step each with
   ``shard_preprocess`` off, with ``shard_primitives``, and with both,
   against (a)'s step 1. (c) ``--mesh data=2,model=1`` without
   ``--distributed`` raises on a one-GPU host; then ``train_torch.main``
   with ``--mesh data=2,model=1 --distributed --device cuda:0`` in two
   ranks that opened their own gloo group, on phase 10 (b)'s scene with
   the bouncingballs preset and 10 + 30 steps (20 + 60 until PR 16) that
   cross densify gates and a capacity growth (2,048 → 4,096): equal
   states, one checkpoint (rank
   0's), ``render_torch.py`` and ``metrics_torch.py`` of it, its PSNR and
   points beside the same schedule without ``--mesh`` (``sharded_cli`` in
   the kernels line). (d) A world of one rank through (a)'s step over
   nccl, step 1 against the single-process step; one rank per GPU over
   nccl where the host has two or more (else a line says it did not run).
   (e) ``fourdgs_tpu_torch.scripts.measure_scaling``: T_slab(1/N) at N = 1,
   2, 4 and 10, 2 reps of 2 calls each.
16. the repairs and the last entry points: (a) ``python -m
   fourdgs_tpu_torch.scripts.gradient_from_checkpoint`` on phase 10 (b)'s
   fine checkpoint of the bouncingballs preset at full width and its
   800×800 scene, 10 timestamps: K1 and K2 once per timestamp, finite
   records; then K1 and K2 against their plain versions at the timeline's
   shapes (``gradient_timeline`` in the kernels line). (b) The committed
   progressive JPEGs and PNG variants of ``tests/torch_fixtures/variants``
   decoded on the card's host bit for bit against Pillow's committed
   decodes (a file of unrefined scans smoothed as libjpeg smooths it,
   against its decode in ``tests/torch_fixtures/rare``), the
   ms of the 1352×1014 picture read progressive and baseline in turns, and
   a MultipleView scene of the twelve progressive frames through
   ``load_scene``. (c) ``train_torch.py --mesh data=1,model=2
   --shard_primitives --port`` in two ranks sharing ``cuda:0`` over gloo
   (launched as (15 c)'s), a SIBR client asking for train camera 0 before
   each of the first 3 coarse steps: rank 0 gathers the sharded primitives
   for each frame, and the first frame equals this process's render of the
   state ``build_scene`` makes from the same seed, bit for bit. (d) Phase
   ``train_torch.py`` twice in this process on phase 10 (b)'s scene with
   one ``--seed`` and ``SPREAD_SCHEDULE`` (10 + 30 steps, cut from 20 +
   60 to pay for phase 18): both held-out PSNRs and whether the trained
   states are bit-equal.
17. the rarer JPEG codings: (a) every committed file of
   ``tests/torch_fixtures/rare`` (the twelve frames arithmetic-coded,
   sequential and progressive, and lossless; smoothed, 4:1:1 and CMYK
   frames; small files of sampling factors 3 and 4, YCCK and CMYK,
   arithmetic coding with restarts and DAC conditioning, smoothing, and
   lossless predictors 1 to 7) decoded on the card's host bit for bit
   against Pillow's committed decode, a 4-component file's RGB through
   ``png.convert`` against Pillow's; then the 1352×1014 picture of phase 16
   (b) in each coding (:func:`capture_codings`, written on the host by
   ``tests/jpeg_writer.py``), each read in turns with the baseline file
   (coding, baseline, baseline, coding; 10 reads each), the arithmetic-coded
   and lossless decodes equal to the baseline's and the smoothed one to
   Pillow's (SHA-256). (b) A MultipleView scene whose twelve slots hold the
   six codings in turns (:func:`rare_frame`), every frame ``load_scene``
   gives equal to Pillow's RGB, through ``train_torch.py`` →
   ``render_torch.py`` → ``metrics_torch.py`` at ``MULTIPLEVIEW_SCHEDULE``
   (12 + 36 steps) with the launch counts zeroed just before each script
   (every frame sent to the ref's decoder), then K1 and K2 at train view 0
   of the trained model against their plain versions
   (``multipleview_rare`` in the kernels line).
18. the DyNeRF video extraction: (a) every committed stream of
   ``tests/torch_fixtures/h264`` (CABAC I, P and B slices of every
   macroblock type, partition and intra mode, the 8x8 transform, scaling
   lists, weights, MMCO and long-term references, slices and deblocking
   controls, POC types 0-2, reorder buffers with and without the VUI's
   depth, cropping, the VUI colours, MP4 and Annex-B; spatial and temporal
   direct prediction, bi-prediction with explicit and implicit weights,
   referenced B pictures) decoded on the card's host, frame by frame with
   the same count, equal to cv2's committed BGR decode; the CAVLC streams
   too (Baseline, Main and High, I, P and B slices, P_8x8ref0, empty 8x8
   parses, level escapes); and the interlaced ones (frame pictures with
   frame_mbs_only_flag 0, field pairs of either parity first, frames and
   field pairs mixed, field marking and lists, direct prediction across
   the two structures, unpaired fields; a frame coded as fields held to
   cv2's conversion of libavcodec's decode, which cv2 itself cannot
   return); and the MBAFF ones (frames of field and frame macroblock pairs,
   CABAC and CAVLC, I, P and B, alone and mixed with field pairs, held to
   libavcodec likewise); then every committed stream of
   ``tests/torch_fixtures/mpeg4`` (MPEG-4 Part 2: an ``mp4v`` stream cv2's
   VideoWriter wrote, and the writer's I- and P-VOPs of every macroblock
   type, inter4v, DQUANT, AC prediction, every escape mode, H.263 and MPEG
   quantisation with loaded matrices, video packets, N-VOPs, the colour
   variants), each equal to cv2's committed decode, the MPEG-4 decoder
   built while the H.264 one is. (b) The host's ms per 2704×2028 frame of a
   stream ``tests/h264_writer.py`` writes there (:func:`row_video`: I, P,
   B, B in decoding order, of one-row slices; spatial direct, implicit
   weights and a referenced B picture as x264's defaults have them; not a
   camera file), coded with CABAC and again with CAVLC from the same draws
   (the same frames): each picture's decode timed when it is decoded (I, P
   and B apart, ``decode_*_ms`` and ``decode_cavlc_*_ms``), the mean per
   frame out with the RGB conversion, the LANCZOS resize to 1352×1014 and
   the PNG write; and of the same kind of stream coded as field pairs (I/P,
   P/P, B/B, B/B; frame_mbs_only_flag 0): each field's decode by its type
   and each pair's (``decode_field_*_ms``, ``decode_pair_*_ms``) beside
   the frames'; and of it coded as MBAFF frames (mb_adaptive_frame_field_flag
   1, each macroblock pair field-coded with probability 0.5; CABAC; I, B, B,
   P out): each frame's decode by its type (``decode_mbaff_*_ms``); and of
   an MPEG-4 Part 2 stream ``tests/mpeg4_writer.py`` writes there
   (:func:`mpeg4_video`: I, P, P, P of one-row video packets): each VOP's
   decode by its type and the mean per frame out with the RGB conversion
   (``decode_mpeg4_*_ms``). (c) A DyNeRF scene of two ``cam*.mp4`` at
   2704×2028 of ``VIDEO_SCENE_FRAMES`` frames, the first MPEG-4 Part 2 (I
   and P VOPs, as cv2's VideoWriter writes an .mp4), the second H.264 coded
   with CABAC as an I/P field pair then MBAFF P and B frames, and no frames
   on disk
   (:func:`write_video_scene`) through ``load_scene``, which extracts each
   camera's frames (each equal to its video's decode resized), then
   ``train_torch.py`` → ``render_torch.py``
   → ``metrics_torch.py`` with the dynerf preset at full width and
   ``VIDEO_SCHEDULE`` (2 coarse + 4 fine steps), K1 once per render of a
   step, eval view and rendered view and K2 once per render of a step,
   every frame decoded by the native prefetcher, then K1 and K2 at train
   view 0 of the trained model against their plain versions
   (``dynerf_video`` in the kernels line).

Agreement bound of K1 with its plain version: atol 1e-4 on color and final
transmittance, except pixels riding T_STOP, where a different association of
the transmittance product may flip one instance (the association contract of
``tests/test_pallas_raster.py``): at most 0.01% of pixels may exceed 1e-4 and
none 1e-2. Depth is held at 1e-4 relative to max(1, |depth|). K2's bound is
in :func:`compare_blend_backward`.

Every time of the kernels line, each kernel's, its plain version's and its
yardstick's, is device time from one timer,
:func:`fourdgs_tpu_torch.scripts.time_ms` (CUDA events around calls queued
behind a sleep kernel). A plain version that waits for the card inside a
call holds host time too.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
LEGO = os.path.join(ROOT, "fourdgs_tpu", "configs", "presets", "dnerf", "lego.py")
WIDTH = HEIGHT = 800
N_POINTS, CAPACITY = 60_000, 65_536
N_TIMED = 20
N_WARM = 3                # warm-up train steps
H100_F32_FLOPS = 67e12    # non-tensor-core float32, H100 SXM data sheet
H100_HBM_BYTES = 3.35e12  # bytes/s
# float32 operations per (pixel, instance) pair, counted from the kernels'
# source (an exp counts as one). A pair the kernels gate takes dx, dy, the
# power (9), exp, α, the cap and two tests.
OPS_GATE = 16
# A pair that blends adds, in K1, the T update and its test (3), w and four
# colour multiply-adds (9);
OPS_LIVE_FWD = 12
# in K2, the T update and its test (3), w, combo (7), pw (2), S,
# 1/max(1−α, 1e-6) (3), dα (4), dpow, the ten gradient terms (22) and their
# sum over the tile's pixels (10).
OPS_LIVE_BWD = 54


def synthetic_blend_inputs(device, seed=0):
    """Blend inputs covering the window and cull edge cases (see module
    docstring): 24 tiles on a 4-wide grid, tile rows mapped to 1 + 2j,
    K = 4096."""
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
    # near-singular conics: eigenvalues λ1 and λ1·10^-7..10^-2 at any angle
    sing = tile == 13
    th = rng.uniform(0, np.pi, sing.sum())
    l1 = rng.uniform(0.05, 0.3, sing.sum())
    l2 = l1 * 10.0 ** rng.uniform(-7, -2, sing.sum())
    cs, sn = np.cos(th), np.sin(th)
    feat[2, sing] = l1 * cs * cs + l2 * sn * sn
    feat[3, sing] = (l1 - l2) * sn * cs
    feat[4, sing] = l1 * sn * sn + l2 * cs * cs

    def t(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    return (t(feat, torch.float32), t(starts, torch.int32), t(stops, torch.int32),
            t(row_off, torch.int32), t([0.2, 0.5, 0.9], torch.float32), gx)


def cull_edge_inputs(device, seed=0, n_tiles=1024):
    """Blend inputs that press on the cull's margin (``csrc/blend_common.cuh``):
    ``n_tiles`` tiles on a 32-wide grid, 16 instances each, means within 24 px of
    their tile at sub-pixel offsets; conics at any angle, 70% positive
    definite with eigenvalues 10^-3..2 and a ratio down to 10^-8 (near
    singular), 10% indefinite, 20% round; opacities half U(0, 1), a quarter
    within 1% of 1/255, a quarter U(0.9, 1). Returns the inputs of
    :func:`synthetic_blend_inputs` and a cotangent."""
    import torch

    from fourdgs_tpu_torch.ops import constants as C

    rng = np.random.default_rng(seed)
    gx, T, per = 32, n_tiles, 16
    K = T * per
    tile = np.repeat(np.arange(T), per)
    th = rng.uniform(0, np.pi, K)
    l1 = 10.0 ** rng.uniform(-3, np.log10(2), K)
    kind = rng.uniform(0, 1, K)
    l2 = np.where(kind < 0.7, l1 * 10.0 ** rng.uniform(-8, 0, K),
                  np.where(kind < 0.8, -l1 * 10.0 ** rng.uniform(-6, 0, K), l1))
    cs, sn = np.cos(th), np.sin(th)
    feat = np.zeros((C.FEAT_ROWS, K), np.float32)
    feat[0] = (tile % gx) * 16 + rng.uniform(-24, 40, K)
    feat[1] = (tile // gx) * 16 + rng.uniform(-24, 40, K)
    feat[2] = l1 * cs * cs + l2 * sn * sn
    feat[3] = (l1 - l2) * sn * cs
    feat[4] = l1 * sn * sn + l2 * cs * cs
    u = rng.uniform(0, 1, K)
    feat[5] = np.where(u < 0.5, rng.uniform(0, 1, K),
                       np.where(u < 0.75, (1 + rng.uniform(-0.01, 0.01, K)) / 255,
                                rng.uniform(0.9, 1.0, K)))
    feat[6:10] = rng.uniform(0, 1, (4, K))
    starts = np.arange(T, dtype=np.int32) * per
    g_out = rng.uniform(-1, 1, (T, C.OUT5, C.N_PIX))

    def t(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    return (t(feat, torch.float32), t(starts, torch.int32), t(starts + per, torch.int32),
            t((0, 1), torch.int32), t([0.2, 0.5, 0.9], torch.float32), gx,
            t(g_out, torch.float32))


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


def compare_blend_backward(d_kernel, d_plain, n_instances):
    """K2's ``dfeat`` [16, K] vs its plain version under the association
    contract; returns a dict of counts and errors, raising on violation.

    An element agrees when |kernel − plain| ≤ 1e-3·|plain| + 1e-4·(its
    row's largest |plain|): each is a float32 sum over a tile's 256 pixels
    of terms that cancel, taken in another order (warp butterflies against
    a tensor sum), with T from a serial product against a log-space
    cumsum. Instances seen by a pixel that rides T_STOP may be blended on
    one side only (the contract of K1): at most 0.1% of the instances in
    the tiles' ranges may disagree, none by more than 1% of its row's scale. Rows
    10..15 must be 0."""
    import torch

    err = (d_kernel[:10] - d_plain[:10]).abs()
    scale = d_plain[:10].abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    bad = (err > 1e-3 * d_plain[:10].abs() + 1e-4 * scale).any(dim=0)
    res = {
        "instances_over_tol": int(bad.sum()),
        "instances": int(n_instances),
        "max_abs_err": float(err.max()),
        "max_err_over_row_scale": float((err / scale).max()),
        "pad_rows_zero": bool((d_kernel[10:] == 0).all()),
        "finite": bool(torch.isfinite(d_kernel).all()),
    }
    ok = (res["finite"] and res["pad_rows_zero"]
          and res["instances_over_tol"] <= 1e-3 * n_instances
          and res["max_err_over_row_scale"] <= 1e-2)
    if not ok:
        raise AssertionError(
            f"backward blend kernel disagrees with its plain version: {res}")
    return res


def blend_work(feat, starts, stops, row_off, grid_x):
    """The blend's data-dependent work on this input: ``instances`` in the
    tiles' ranges and the pair counts of
    :func:`fourdgs_tpu_torch.ops.blend.pair_counts` (``in_range``,
    ``gated``, ``kept_pairs``, ``live_pairs``, K2's reductions at the batch
    its library was built with). ``gated`` comes from the kernels' own strip
    masks (``blend.strip_masks``), which must first equal their plain
    mirror's on the CPU bit for bit."""
    import torch

    from fourdgs_tpu_torch.ops import blend

    masks = blend.strip_masks(feat, starts, stops, row_off, grid_x).cpu()
    plain = blend.strip_masks_plain(*(x.cpu() for x in (feat, starts, stops, row_off)),
                                    grid_x)
    if not torch.equal(masks, plain):
        raise AssertionError(f"the kernels' strip masks differ from their plain mirror "
                             f"at {int((masks != plain).sum())} of {masks.numel()} slots")
    n = int((stops.long() - starts.long()).clamp(min=0).sum())
    return {"instances": n, **blend.pair_counts(
        feat, starts, stops, row_off, grid_x, k2_batch=blend.k2_reduction()["batch"])}


def _bound(ops, n_bytes):
    ops_s, bytes_s = ops / H100_F32_FLOPS, n_bytes / H100_HBM_BYTES
    return {"bound_ms": 1e3 * max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}


def _blend_bounds(work, ops_live, n_bytes):
    """The bound with the gates counted on the kept pairs a pixel reaches
    before it freezes at T_STOP (the least work: the cull leaves unkept
    pairs nothing to compute, and a frozen pixel needs no gate for the rest
    of its chunk); as ``bound_kept_pairs_ms`` with the gates counted on
    every kept pair, whatever T (the earlier count, which saturated tiles
    overstate); and as ``bound_all_pairs_ms`` with the gates counted
    on every in-range pair (the bound before the cull)."""
    live = work["live_pairs"] * ops_live
    return {**_bound(work["reached_pairs"] * OPS_GATE + live, n_bytes),
            "bound_kept_pairs_ms": _bound(work["kept_pairs"] * OPS_GATE + live,
                                          n_bytes)["bound_ms"],
            "bound_all_pairs_ms": _bound(work["in_range"] * OPS_GATE + live,
                                         n_bytes)["bound_ms"]}


def blend_bound(work, n_tiles):
    """Least time for K1's work (:func:`blend_work`): the larger of its
    operations at the float32 rate and its bytes at HBM rate (the payload
    read once, 40 B per instance; 8 B of range per tile; 5 output floats per
    pixel); see :func:`_blend_bounds`."""
    return _blend_bounds(work, OPS_LIVE_FWD,
                         40 * work["instances"] + n_tiles * (8 + 5 * 256 * 4))


def blend_backward_bound(work, n_tiles, k_pad):
    """Least time for K2's work, as :func:`blend_bound`; its bytes: the
    payload read once, 8 B of range per tile, the saved output and the
    cotangent read once (10 floats per pixel), ``dfeat`` [16, K] written
    once (64 B per slot)."""
    return _blend_bounds(work, OPS_LIVE_BWD,
                         40 * work["instances"] + n_tiles * (8 + 10 * 256 * 4)
                         + 64 * k_pad)


def work_line(work):
    """The pair counts and shares of :func:`blend_work` as one line, with the
    gated share of each warp's strip and K2's shuffles per live
    warp-instance (``blend.k2_reduction``'s shuffles per reduce-scatter)."""
    from fourdgs_tpu_torch.ops import blend

    red = blend.k2_reduction()
    n = work["in_range"]
    per_warp = n // len(work["gated_by_warp"])
    shares = "/".join(f"{g / per_warp:.3f}" for g in work["gated_by_warp"])
    live_wi = max(work["live_warp_instances"], 1)
    return (f"{work['instances']} instances, {n} pairs in range; the cull leaves "
            f"{work['gated']} to the gates (gated share {work['gated'] / n:.4f}; by "
            f"warp {shares}), {work['kept_pairs']} kept ({work['kept_pairs'] / n:.4f}), "
            f"{work['reached_pairs']} reached before T_STOP "
            f"({work['reached_pairs'] / n:.4f}), "
            f"{work['live_pairs']} live ({work['live_pairs'] / n:.4f}); "
            f"{work['live_warp_instances']} live warp-instances in "
            f"{work['k2_reductions']} K2 reductions, "
            f"{red['shuffles'] * work['k2_reductions'] / live_wi:.2f} shuffles each "
            f"({red['unbatched']} without batching)")


def tile_lengths(starts, stops):
    """Instances per tile: mean over all tiles and over nonempty ones,
    percentiles and the longest (``max_tile_len``)."""
    lens = (stops.long() - starts.long()).clamp(min=0).cpu().numpy()
    q = np.percentile(lens, [50, 90, 99])
    return (f"tile lengths: mean {lens.mean():.2f} (nonempty "
            f"{lens[lens > 0].mean():.2f}), p50/p90/p99 {q[0]:.0f}/{q[1]:.0f}/"
            f"{q[2]:.0f}, max_tile_len {lens.max()}")


def check_cull_exact(fn, *args):
    """Raise unless ``fn`` (a kernel wrapper) gives the same bits with its
    per-warp cull as walking every in-range instance, and twice the same."""
    import torch

    got, again, walked = fn(*args), fn(*args), fn(*args, _cull=False)
    if not torch.equal(got, again):
        raise AssertionError(f"{fn.__name__}: two runs differ")
    if not torch.equal(got, walked):
        bad = int((got != walked).sum())
        raise AssertionError(f"{fn.__name__}: the cull changed {bad} output elements")


GATHER_EDGE_P = (1, 17, 65_536, 65_537)
GATHER_EDGE_K = (1, 31, 33, 393_216, 2_097_152)


def gather_edge_inputs(P, K, device, seed=0):
    """K3 at an edge of its grids: a [16, P] table and K uniform ids, the
    first P − 1 and the last 0 (P = 17, 65,537: no multiple of the staging
    pass's 128 columns; K = 31, 33: a warp's 32 slots ± 1)."""
    import torch

    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.standard_normal((16, P), dtype=np.float32))
    idx = rng.integers(0, P, K, dtype=np.int32)
    idx[-1:] = 0
    idx[:1] = P - 1
    return table.to(device), torch.from_numpy(idx).to(device)


def check_gather(table, idx):
    """One K3 call (``gather.gather_cols``) on the card: raise unless it
    counts one launch (none at K = 0) and gives ``index_select(1)``'s bits
    on the ids in [0, P) and NaN columns on the others; returns the output."""
    import torch

    from fourdgs_tpu_torch.ops import gather

    before = gather.gather_cols.launches
    out = gather.gather_cols(table, idx)
    torch.cuda.synchronize()
    K = idx.numel()
    if gather.gather_cols.launches != before + (K > 0):
        raise AssertionError(f"gather_cols at K = {K} counted "
                             f"{gather.gather_cols.launches - before} launches")
    if out.shape != (16, K):
        raise AssertionError(f"gather_cols gave {tuple(out.shape)} at K = {K}")
    bad = (idx < 0) | (idx >= table.shape[1])
    if not bool(torch.isnan(out[:, bad]).all()):
        raise AssertionError("gather_cols: an id outside [0, P) gave a non-NaN value")
    if not torch.equal(out[:, ~bad], gather.gather_cols_plain(table, idx[~bad])):
        raise AssertionError(f"K3 differs from index_select(1) at P = "
                             f"{table.shape[1]}, K = {K}")
    return out


def check_gather_ranges(dev):
    """K3 with ids −1 and P among in-range ids (NaN columns there) and at
    K = 0 (an empty [16, 0], no launch)."""
    table, idx = gather_edge_inputs(17, 33, dev)
    idx[5], idx[6] = -1, 17
    check_gather(table, idx)
    check_gather(table, idx[:0])


def check_gather_back_to_back(dev):
    """Two K3 calls queued back to back on two tables of one shape (the
    second staging into the first's freed scratch while nothing waits in
    between): each gives its own table's columns."""
    import torch

    from fourdgs_tpu_torch.ops import gather

    a, idx = gather_edge_inputs(65_537, 393_216, dev, seed=1)
    b = gather_edge_inputs(65_537, 393_216, dev, seed=2)[0]
    outs = [gather.gather_cols(t, idx) for t in (a, b, a)]
    torch.cuda.synchronize()
    for t, out in zip((a, b, a), outs):
        if not torch.equal(out, gather.gather_cols_plain(t, idx)):
            raise AssertionError("K3 calls back to back read another call's rows")


def ptxas_report(log):
    """(kernel, line) for each ``nvcc -Xptxas -v`` line of ``log`` that gives
    a kernel's registers, barriers, shared memory or spills; the kernel is the
    mangled name of the entry function that line belongs to."""
    out, kernel = [], "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "registers" in line or "spill" in line or "smem" in line:
            out.append((kernel, line.strip()))
    return out


def check_probe(p, args):
    """One call of grid-cost probe ``p`` (an entry of ``ops/grid_cost.py::
    PROBES``) on the card, into memory that held NaN just before (blocks of
    the outputs' sizes filled and freed, which the caching allocator hands
    back), so a tile the kernel leaves unwritten shows: its launch counted
    and its outputs bit-equal to the plain version's. Returns the max abs
    error, 0."""
    import torch

    want = p.plain(*args)
    want = want if isinstance(want, tuple) else (want,)
    poison = [torch.full_like(w, float("nan")) for w in want]
    del poison
    before = p.fn.launches
    got = p.fn(*args)
    torch.cuda.synchronize()
    t = len(args[0]) if isinstance(args[0], torch.Tensor) else args[0]
    name = f"{p.fn.__name__} at T = {t}"
    if p.fn.launches != before + 1:
        raise AssertionError(f"{name} did not count its launch")
    got = got if isinstance(got, tuple) else (got,)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        errs = [float((a - b).abs().nan_to_num(float("inf")).max()) for a, b in zip(got, want)]
        raise AssertionError(f"{name} differs from its plain version: {errs}")
    return 0.0


def check_cost_experiments(dev):
    """Phase 7: the three cost experiments through their ``run()``, then each
    new kernel against its plain version; returns the kernels-line entries of
    K3–K10 and prints the rest."""
    import torch

    from fourdgs_tpu_torch.ops import blend, gather
    from fourdgs_tpu_torch.ops import grid_cost as GC
    from fourdgs_tpu_torch.scripts import exp_gather, exp_grid_cost, time_ms
    from fourdgs_tpu_torch.scripts import exp_kernel_overhead as EKO

    def drive(run, fns):
        for f in fns:
            f.launches = 0
        res = run(device=dev)
        counts = {f.__name__: f.launches for f in fns}
        if not all(counts.values()):
            raise AssertionError(f"{run.__module__}: a kernel never launched: {counts}")
        print(f"    launches in {run.__module__.rsplit('.', 1)[-1]}.run(): {counts}")
        return res, counts

    print("[7] cost experiments: exp_gather.run()")
    r_gather, n_gather = drive(exp_gather.run, [gather.gather_cols])
    print("    exp_grid_cost.run()")
    r_grid, n_grid = drive(exp_grid_cost.run, [p.fn for p in GC.PROBES])
    print("    exp_kernel_overhead.run()")
    r_over, _ = drive(EKO.run, [blend.blend_forward, blend.blend_backward])

    def timed(fn):
        return time_ms(fn, dev)[0]

    # K3 at its edge cases, then at the script's and the render's shape
    n_edges = 0
    for P_e in GATHER_EDGE_P:
        for K_e in GATHER_EDGE_K:
            check_gather(*gather_edge_inputs(P_e, K_e, dev))
            n_edges += 1
    check_gather_ranges(dev)
    check_gather_back_to_back(dev)
    print(f"    K3 bit-equal to index_select(1) at {n_edges} edge cases (P in "
          f"{GATHER_EDGE_P}, K in {GATHER_EDGE_K}), NaN columns for ids -1 and P, "
          f"nothing launched at K = 0, three calls back to back each its own")
    rng = np.random.default_rng(0)
    P, K, KR = r_gather["P"], r_gather["K"], r_gather["render_K"]
    tableT = torch.from_numpy(rng.standard_normal((16, P), dtype=np.float32)).to(dev)
    kernels = []
    for shape, idx in (
            ("script", torch.from_numpy(rng.integers(0, P, K, dtype=np.int32)).to(dev)),
            ("render", exp_gather.render_ids(P, KR, r_gather["render_n_ids"], rng, dev))):
        out = check_gather(tableT, idx)
        err = float((out - gather.gather_cols_plain(tableT, idx)).abs().max())
        rows = gather._stage_rows(tableT)
        if not (torch.equal(rows, tableT.T) and torch.equal(gather._gather_rows(rows, idx), out)):
            raise AssertionError(f"K3's pass hooks differ from table.T and the call "
                                 f"at the {shape} shape")
        n = idx.numel()
        bound = _bound(0, 4 * n + 64 * n + 64 * P)
        ms = {v: r_gather["ms"][f"{shape}/{v}/float32"] for v in (
            "gather_cols", "stage", "gather_pass", "take_axis0_T", "take_axis1")}
        plain_ms = timed(lambda: gather.gather_cols_plain(tableT, idx))
        print(f"    K3 at the {shape} shape (P {P}, K {n}): bit-equal to plain; call "
              f"{ms['gather_cols']:.4f} ms = staging pass {ms['stage']:.4f} + gather "
              f"pass {ms['gather_pass']:.4f} (each hook bit-equal); "
              f"index_select(1) {ms['take_axis1']:.4f} ms; the render path's "
              f"index_select(0).T {ms['take_axis0_T']:.4f} ms against the gather pass; "
              f"plain {plain_ms:.4f} ms; bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}), call/bound {ms['gather_cols'] / bound['bound_ms']:.2f}, "
              f"index_select(1)/call {ms['take_axis1'] / ms['gather_cols']:.2f}")
        if shape == "script":
            kernels.append(dict(
                name="gather_cols", route="cuda",
                source="fourdgs_tpu_torch/csrc/gather_cols.cu",
                replaces="scripts/exp_gather.py:93", launches=n_gather["gather_cols"],
                max_abs_err=err, ms=ms["gather_cols"], plain_ms=plain_ms,
                library_ms=ms["take_axis1"], **bound))

    # K4-K10 against their plain versions over the experiment's tiles
    T = r_grid["T"]
    print(f"    probes over T = {T} tiles, floor (1 block) {r_grid['floor_ms']:.5f} ms:")
    for p in GC.PROBES:
        name = p.fn.__name__
        # the experiment's arguments, then the edges of the grid
        cases = [p.args(T, dev)] + p.check_args(dev)
        err = max(check_probe(p, args) for args in cases)
        # the inputs read once, the outputs written once
        n_bytes = sum(4 * a.numel() for a in cases[0] if isinstance(a, torch.Tensor))
        bound = _bound(0, n_bytes + T * 256 * p.floats * 4)
        pr = r_grid["probes"][name]
        # the same-bytes fill the experiment read in turns with the probe; it
        # is the library call where it computes the probe's output
        lib_ms = pr["ones_ms"]
        plain_ms = timed(lambda: p.plain(*cases[0]))
        lib = "the library call" if p.ones else "no library call"
        print(f"      {p.id:3s} {name:16s} bit-equal in {len(cases)} cases, "
              f"{pr['ms']:.5f} ms, {pr['blocks']} "
              f"blocks, {pr['per_block_us']} us/block over the floor, bound "
              f"{bound['bound_ms']:.5f} ms, plain {plain_ms:.5f} ms, torch.ones of "
              f"its bytes {pr['fill_ms']:.5f} ms (vs_fill {pr['vs_fill']:.3f}x; {lib})")
        kernels.append(dict(
            name=name, route="cuda", source="fourdgs_tpu_torch/csrc/grid_cost.cu",
            replaces=p.site, launches=n_grid[name], max_abs_err=err,
            ms=pr["ms"], plain_ms=plain_ms, library_ms=lib_ms,
            fill_ms=pr["fill_ms"], **bound))

    # K1 and K2 on the synthetic grids against their plain versions
    for grid, (feat, starts, stops, row_off, bg, g_out) in EKO.inputs(
            r_over["T"], r_over["gx"], r_over["K"], dev).items():
        out = blend.blend_forward(feat, starts, stops, row_off, bg, r_over["gx"])
        d = blend.blend_backward(feat, starts, stops, row_off, bg, out, g_out, r_over["gx"])
        torch.cuda.synchronize()
        fwd = compare_blend(out, blend.blend_forward_plain(
            feat, starts, stops, row_off, bg, r_over["gx"]))
        bwd = compare_blend_backward(d, blend.blend_backward_plain(
            feat, starts, stops, row_off, bg, out, g_out, r_over["gx"]),
            r_over["grids"][grid]["instances"])
        print(f"    K1/K2 on the {grid} grid vs plain: K1 max abs err "
              f"{fwd['max_abs_err']:.3g} ({fwd['over_1e-4']} pixels over 1e-4), K2 "
              f"{bwd['instances_over_tol']} instances over tolerance, max err / row scale "
              f"{bwd['max_err_over_row_scale']:.3g}")
    print(f"    K1/K2 per-tile fixed cost (us): {r_over['per_tile_us']}; per-instance "
          f"cost (ns): {r_over['per_instance_ns']}")
    return kernels


def check_maintenance_on_card(dev, seed=0):
    """Phase 9 (c): capacity growth, clone, split (the same normals), prune
    with the size gate and the opacity reset on one state of 2,000 points
    with random shapes, statistics and Adam moments, on the card and on the
    CPU. Raises unless alive, table and counts are equal and every element
    of the parameters and moments agrees within rtol 1e-6 of its operands:
    of itself, but for a split child's position, the sum p + R·(s∘n) of its
    parent's position and its offset, which may cancel to near 0; its
    operands are |p| and ‖s∘n‖ (≥ each |Σ_j R_ij s_j n_j| term by term, R a
    rotation), read from a CPU run with the normals set to 0, which places
    the same children at their parents' positions."""
    import torch

    from fourdgs_tpu_torch.configs.core import load_config
    from fourdgs_tpu_torch.models import gaussians as G
    from fourdgs_tpu_torch.train import adam
    from fourdgs_tpu_torch.train.loop import make_maintenance

    rng = np.random.default_rng(seed)
    n = 2000
    cfg = load_config(os.path.join(ROOT, "fourdgs_tpu", "configs", "presets",
                                   "dnerf", "bouncingballs.py"))
    cfg.tpu.capacity_init = 2048
    st = G.create_from_pcd(cfg, rng.uniform(-1.3, 1.3, (n, 3)),
                           rng.uniform(0, 1, (n, 3)), 5.0, device=dev)
    P = st.alive.shape[0]
    denom = rng.integers(0, 4, P).astype(np.float32)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    params = dict(st.params)
    params["scaling"] = t(np.log(rng.uniform(0.005, 0.3, (P, 3))))
    params["opacity"] = t(rng.normal(-1.0, 2.5, (P, 1)))
    params["rotation"] = t(rng.normal(size=(P, 4)))
    st = st._replace(params=params, denom=t(denom),
                     xyz_gradient_accum=t(denom * rng.exponential(2e-4, P)),
                     max_radii2d=t(rng.integers(0, 40, P)))
    opt = adam.init(params)
    for m in (opt.mu, opt.nu):
        for k in G.PRIMITIVE_KEYS:
            m[k].copy_(t(rng.normal(size=tuple(m[k].shape))))
    normals = torch.tensor(rng.standard_normal((2, 4096, 3), dtype=np.float32))
    densify_fn, prune_fn, reset_fn = make_maintenance(cfg)

    def run(state, opt_state, device, normals=normals):
        """The maintenance sequence; the deformation module stays where it is
        (no maintenance call reads it)."""
        state, opt_state = G.grow_capacity(state, opt_state, 4096)
        state, opt_state, n_cloned, n_split = densify_fn(
            state, opt_state, 2e-4, 5.0, normals.to(device))
        state, n_pruned = prune_fn(state, 0.005, 5.0, True)
        state, opt_state = reset_fn(state, opt_state)
        return state, opt_state, (n_cloned, n_split, int(n_pruned))

    def to_cpu(tree):
        if isinstance(tree, torch.Tensor):
            return tree.cpu()
        if isinstance(tree, dict):
            return {k: (v if k == "deform" else to_cpu(v)) for k, v in tree.items()}
        return tree

    cpu_state = G.GaussianState(*(to_cpu(x) for x in st))
    cpu_opt = adam.AdamState(mu=to_cpu(opt.mu), nu=to_cpu(opt.nu), count=0)
    got, got_opt, got_n = run(st, opt, dev)
    want, want_opt, want_n = run(cpu_state, cpu_opt, "cpu")
    if got_n != want_n or not all(got_n[:2]):
        raise AssertionError(f"maintenance counts card {got_n} vs CPU {want_n}")
    for k in ("alive", "deformation_table", "max_radii2d", "denom"):
        if not torch.equal(getattr(got, k).cpu(), getattr(want, k)):
            raise AssertionError(f"maintenance: {k} differs between card and CPU")
    at_parent = run(cpu_state, cpu_opt, "cpu", torch.zeros_like(normals))[0]
    if not (torch.equal(at_parent.alive, want.alive)
            and torch.equal(at_parent.deformation_table, want.deformation_table)):
        raise AssertionError("maintenance: the normals moved the slots")
    parent = at_parent.params["xyz"]
    offset = (want.params["xyz"] - parent).norm(dim=1, keepdim=True)
    worst = 0.0
    for name, a, b in [(k, got.params[k], want.params[k]) for k in G.PRIMITIVE_KEYS] + [
            (f"moment {k}", m[k], w[k]) for m, w in ((got_opt.mu, want_opt.mu),
                                                   (got_opt.nu, want_opt.nu))
            for k in G.PRIMITIVE_KEYS]:
        err = (a.cpu() - b).abs()
        operands = parent.abs() + offset if name == "xyz" else b.abs()
        bad = err > 1e-6 * operands
        if bad.any():
            i = int(torch.argmax((err - 1e-6 * operands).flatten()))
            raise AssertionError(
                f"maintenance: {name} differs between card and CPU at "
                f"{int(bad.sum())} elements, worst {float(err.flatten()[i])} against "
                f"operands {float(operands.flatten()[i])}")
        worst = max(worst, float(err.max()))
    return {"cloned": got_n[0], "split": got_n[1], "pruned": got_n[2],
            "alive": int(got.alive.sum()), "max_abs_err": worst}


def step_blend_inputs(cfg, state, cam, width, height, gt_tiles, bg, sh_degree, dev):
    """The blend inputs of camera ``cam`` (``CameraArrays``) at ``width`` ×
    ``height`` as a fine-stage
    train step builds them (the SH degree ``sh_degree``, ``cfg``'s budget and
    payload), and that step's cotangent of the tile-space L1 against
    ``gt_tiles`` [T, 5, 256]. Returns (K1's arguments, K2's arguments)."""
    import torch

    from fourdgs_tpu_torch import render as TR
    from fourdgs_tpu_torch.ops import blend
    from fourdgs_tpu_torch.ops import rasterize as R
    from fourdgs_tpu_torch.utils import losses

    W, H = int(width), int(height)
    with torch.no_grad():
        xyz, sc, rot, op, shs, _ = TR.activated_gaussians(
            state.params, state, cam, "fine", cfg.model.use_isotropic_gaussian)
        bi = R.blend_inputs(xyz, sc, rot, op, shs, cam.camera_center, cam.world_view,
                            cam.full_proj, cam.tanfovx, cam.tanfovy, W, H,
                            sh_degree, cfg.tpu.instance_budget,
                            alive=state.alive, payload_bf16=cfg.tpu.payload_bf16)
    fwd_args = (bi.feat, bi.bins.tile_start, bi.bins.tile_stop, bi.row_off, bg, bi.grid_x)
    out5 = blend.blend_forward(*fwd_args)
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0], device=dev)[:, None]
    if H % 16 or W % 16:
        mask = mask * losses.tile_pixel_mask(H, W, device=dev)
    with torch.enable_grad():                     # the train step's L1 cotangent
        o = out5.clone().requires_grad_()
        diff = (o - gt_tiles) * mask
        (g_out,) = torch.autograd.grad(
            losses.abs_(diff).sum() / (cfg.opt.batch_size * 3 * H * W), o)
    return fwd_args, (*fwd_args[:5], out5, g_out, fwd_args[5])


def view_blend_inputs(model, view, dev):
    """:func:`step_blend_inputs` of train view ``view`` of a trained model
    (``bench_quality_torch.Trained``) at its active SH degree, against the
    view's GT frame."""
    import torch

    from fourdgs_tpu_torch import render as TR
    from fourdgs_tpu_torch.utils import losses

    cfg, state, train_cams, bg = model
    cam_np, frame = train_cams[view]
    gt = torch.tensor(np.asarray(frame), device=dev)
    if gt.dtype == torch.uint8:                   # the oracle's [H, W, 3] frames
        gt = gt.to(torch.float32).permute(2, 0, 1) / 255.0
    return step_blend_inputs(cfg, state, TR.CameraArrays.from_camera(cam_np, device=dev),
                             cam_np.width, cam_np.height,
                             losses.tile_image(gt[:3], pad_cols=2), bg,
                             state.active_sh_degree, dev)


def check_step_blend(fwd_args, bwd_args, dev, where):
    """K1 and K2 at the shapes of a train step (:func:`step_blend_inputs`)
    against their plain versions, with the cull against the walk of every
    in-range instance and the kernels' strip masks against their plain
    mirror's; their times and bounds, printed under ``where``. Returns the
    kernels-line fields of K1 and K2 at this shape."""
    from fourdgs_tpu_torch.ops import blend
    from fourdgs_tpu_torch.scripts import time_ms

    out5 = bwd_args[5]
    fwd = compare_blend(out5, blend.blend_forward_plain(*fwd_args))
    d_k = blend.blend_backward(*bwd_args)
    work = blend_work(*fwd_args[:4], fwd_args[5])
    bwd = compare_blend_backward(d_k, blend.blend_backward_plain(*bwd_args),
                                 work["instances"])
    check_cull_exact(blend.blend_forward, *fwd_args)
    check_cull_exact(blend.blend_backward, *bwd_args)
    n_tiles, k_pad = fwd_args[1].numel(), fwd_args[0].shape[1]
    bounds = (blend_bound(work, n_tiles), blend_backward_bound(work, n_tiles, k_pad))
    res = {}
    for fn, plain, args, cmp, bound in (
            (blend.blend_forward, blend.blend_forward_plain, fwd_args, fwd, bounds[0]),
            (blend.blend_backward, blend.blend_backward_plain, bwd_args, bwd, bounds[1])):
        res[fn.__name__] = {
            "ms": time_ms(lambda: fn(*args), dev)[0],
            "ms_without_cull": time_ms(lambda: fn(*args, _cull=False), dev)[0],
            "plain_ms": time_ms(lambda: plain(*args), dev, iters=1, reps=3)[0],
            "max_abs_err": cmp["max_abs_err"], **bound,
            "gated_share": work["gated"] / max(work["in_range"], 1),
            "slots": k_pad, "instances": work["instances"]}
    print(f"    K1/K2 at {where} ({n_tiles} tiles, K = {k_pad} slots): K1 vs plain "
          f"{fwd}; K2 vs plain with the step's cotangent {bwd}")
    for name, r in res.items():
        print(f"    {name} at this shape: kernel {r['ms']:.4f} ms (cull off "
              f"{r['ms_without_cull']:.4f}), plain {r['plain_ms']:.4f} ms, bound on "
              f"reached pairs {r['bound_ms']:.4f} ms ({r['bound_by']}), kernel/bound "
              f"{r['ms'] / r['bound_ms']:.2f}; on kept pairs "
              f"{r['bound_kept_pairs_ms']:.4f} ms; on all in-range pairs "
              f"{r['bound_all_pairs_ms']:.4f} ms")
    opaque = float((out5[:, 4] < 0.01).float().mean())
    print(f"    {work_line(work)}; pixels with final T < 0.01: {opaque:.4f}")
    print(f"    {tile_lengths(fwd_args[1], fwd_args[2])}; K1 and K2 with the cull equal "
          f"their walk of every in-range instance bit for bit, the strip masks their "
          f"plain mirror's")
    return res


def check_trained_blend(model, dev, view=0):
    """Phase 9 (a), after the run: :func:`check_step_blend` at train view
    ``view`` of the trained model (:func:`view_blend_inputs`)."""
    state = model.state
    return check_step_blend(
        *view_blend_inputs(model, view, dev), dev,
        f"train view {view} of the trained model (capacity {state.alive.shape[0]}, "
        f"{int(state.alive.sum())} alive, SH degree {state.active_sh_degree})")


def check_bench_blend(w, dev):
    """Phase 10 (a), after the run: :func:`check_step_blend` at the bench's
    last step (``bench_torch.run``'s final workload ``w``: its camera, GT,
    bf16 payload, 384k budget and SH degree, the state after the step)."""
    import torch

    from fourdgs_tpu_torch.render import CameraArrays

    bg = torch.tensor([1.0, 1.0, 1.0] if w.cfg.model.white_background
                      else [0.0, 0.0, 0.0], device=dev)
    cam = CameraArrays(*(x[0] for x in w.cams))
    state = w.state
    return check_step_blend(
        *step_blend_inputs(w.cfg, state, cam, w.cameras[0].width, w.cameras[0].height,
                           w.gts[0], bg, w.cfg.model.sh_degree, dev), dev,
        f"the bench's last step (capacity {state.alive.shape[0]}, "
        f"{int(state.alive.sum())} alive, SH degree {w.cfg.model.sh_degree}, bf16 payload "
        f"{w.cfg.tpu.payload_bf16})")


def check_training_from_pcd(dev):
    """Phase 9: ``bench_quality_torch.run`` twice, K1/K2 on
    (a)'s trained model and the maintenance on card and CPU (module
    docstring); returns (a)'s result and :func:`check_trained_blend`'s."""
    import bench_quality_torch as BQ
    from fourdgs_tpu_torch.ops import blend

    print("[9] training from a point cloud: (a) bench_quality_torch --gt oracle "
          "--scale 0.0075", flush=True)
    t0 = time.perf_counter()
    a, model = BQ.run(scale=0.0075, gt="oracle", log_interval=50, device=dev)
    launches = (blend.blend_forward.launches, blend.blend_backward.launches)
    renders = (a["schedule"]["coarse"] + a["schedule"]["fine"]) * a["batch_size"]
    log = a["train_log"]
    print(f"    (a) from 2,000 random points, bouncingballs preset, oracle GT "
          f"{a['resolution']}x{a['resolution']}, {a['schedule']} steps "
          f"({time.perf_counter() - t0:.1f} s with GT load and eval): held-out PSNR "
          f"{a['test_psnr_db']:.4f} dB, final points {a['final_points']}, train wall "
          f"{a['train_wall_clock_s']:.3f} s, it/s {a['it_per_s']:.3f}")
    print(f"    K1 launches {a['k1_launches']} (steps {renders} + eval views "
          f"{a['eval_views']}), K2 launches {a['k2_launches']}; budget growths "
          f"{a['budget_growths']} (final {a['final_instance_budget']}), capacity "
          f"growths {a['capacity_growths']} (final {a['final_capacity']}); "
          f"K1 vs oracle frame {a['gt_pallas_vs_oracle']['max_abs']:.4f} max abs")
    print(f"    stage seconds {json.dumps(a['stage_s'])}; densify/prune "
          f"{json.dumps(a['densify_events'])}")
    if launches != (a["k1_launches"], a["k2_launches"]):
        raise AssertionError(f"the counts moved after the run: {launches}")
    if (a["k2_launches"], a["k1_launches"]) != (renders, renders + a["eval_views"]):
        raise AssertionError(f"launches K1 {a['k1_launches']}, K2 {a['k2_launches']}; "
                             f"expected {renders + a['eval_views']}, {renders}")
    if not all(math.isfinite(e["loss"]) for e in log):
        raise AssertionError("a logged loss is not finite")
    if not a["last_train_psnr"] > log[0]["psnr"]:
        raise AssertionError(f"train PSNR did not rise: {log[0]['psnr']} -> "
                             f"{a['last_train_psnr']}")
    trained = check_trained_blend(model, dev)
    del model

    def early_gates(cfg):
        cfg.opt.coarse_iterations, cfg.opt.iterations = 60, 40
        cfg.opt.position_lr_max_steps = 40
        cfg.opt.densify_from_iter = cfg.opt.pruning_from_iter = 20
        cfg.opt.densification_interval = cfg.opt.pruning_interval = 20
        cfg.opt.opacity_reset_interval = 60
        cfg.opt.densify_until_iter = 1000
        cfg.tpu.capacity_init = 2048

    print("    (b) 256x256, GT from K1, gates every 20", flush=True)
    t0 = time.perf_counter()
    b, _ = BQ.run(size=256, n_train=20, n_test=4, gt="kernel", log_interval=20,
                  device=dev, adjust=early_gates)
    print(f"    (b) {b['schedule']} steps in "
          f"{time.perf_counter() - t0:.1f} s; capacity growths {b['capacity_growths']} "
          f"(final {b['final_capacity']}), resets {b['resets']}, final points "
          f"{b['final_points']}, held-out PSNR {b['test_psnr_db']:.4f} dB; densify "
          f"{json.dumps(b['densify_events'])}")
    if b["capacity_growths"] < 1 or b["resets"] < 1:
        raise AssertionError("capacity growth or the opacity reset did not fire")
    c = check_maintenance_on_card(dev)
    print(f"    (c) maintenance on card and CPU: alive, table and counts equal, "
          f"parameters and moments within rtol 1e-6 of their operands: {c}")
    return a, trained


# phases 10 (b) and 12 (a): 100 + 300 steps until PR 16, cut to 50 + 150 to
# pay for phase 16
CLI_SCHEDULE = ("opt.coarse_iterations=50", "opt.iterations=150",
                "opt.position_lr_max_steps=150")
# phase 12 (a): cut from CLI_SCHEDULE to pay for phase 17; the fine stage
# keeps the debug panel at its iteration 100
HYPERNERF_SCHEDULE = ("opt.coarse_iterations=30", "opt.iterations=100",
                      "opt.position_lr_max_steps=100")
# the pose convention of data/blender.py: R = F·m[:3, :3]ᵀ, T = −m[:3, 3]
# with m = inv(transform_matrix)
_BLENDER_FLIP = np.diag([1.0, -1.0, -1.0])


def write_dnerf_scene(root, dev, size=WIDTH, n_train=20, n_test=4):
    """Write a D-NeRF (Blender) scene under ``root`` with the port's PNG
    writer: RGBA frames that K1 renders from ``bench_quality_torch.py``'s
    ground-truth scene (straight colour, the render's alpha; every row
    Paeth-filtered, the reader's costliest filter) on ring cameras
    at times i/(n−1), ``transforms_{train,test}.json``, no ``fused.ply``.
    Returns the cameras per split."""
    import torch

    import bench_quality_torch as BQ
    from fourdgs_tpu_torch.ops.rasterize import rasterize_pallas
    from fourdgs_tpu_torch.render import CameraArrays
    from fourdgs_tpu_torch.utils import png

    pts, cols, scales, offsets = BQ.make_gt_scene()
    extra = {k: torch.tensor(v, device=dev)
             for k, v in BQ.gt_raster_args(pts, cols, scales).items()}
    black = torch.zeros(3, device=dev)
    cameras = {}
    for split, n, seed in (("train", n_train, 1), ("test", n_test, 2)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        r = np.random.default_rng(seed)
        frames, cameras[split] = [], []
        for i in range(n):
            t = i / max(n - 1, 1)
            cam = BQ.ring_camera(r.uniform(0, 2 * np.pi), r.uniform(0.15, 0.9),
                                 size, size, t)
            c = CameraArrays.from_camera(cam, device=dev)
            with torch.no_grad():
                out = rasterize_pallas(
                    torch.tensor(pts + offsets(t), device=dev), extra["scales"],
                    extra["rotations"], extra["opacities"], extra["shs"],
                    c.camera_center, c.world_view, c.full_proj, c.tanfovx,
                    c.tanfovy, size, size, 0, black, instance_budget=BQ.GT_BUDGET)
            if int(out.num_rendered) > BQ.GT_BUDGET:
                raise AssertionError(f"scene frame overflowed its budget: "
                                     f"{int(out.num_rendered)}")
            alpha = out.alpha.clamp(0, 1)
            straight = (out.color / alpha.clamp(min=1 / 255)).clamp(0, 1)
            rgba = torch.cat([straight, alpha]).permute(1, 2, 0).cpu().numpy()
            name = f"r_{i:03d}"
            png.write_png(os.path.join(root, split, name + ".png"),
                          (rgba * 255 + 0.5).astype(np.uint8), filter_type=4)
            w2c = np.asarray(cam.world_view, np.float64).T
            m = np.eye(4)
            m[:3, :3] = _BLENDER_FLIP @ w2c[:3, :3]
            m[:3, 3] = -w2c[:3, 3]
            frames.append({"file_path": f"./{split}/{name}", "time": t,
                           "transform_matrix": np.linalg.inv(m).tolist()})
            cameras[split].append(cam)
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.6911112070083618, "frames": frames}, f)
    return cameras


def _checkpoint_leaves(state, opt):
    """(name, tensor) of every leaf a training checkpoint holds."""
    from fourdgs_tpu_torch.train import adam

    out = [(f"params.{n}", x) for n, x in adam.named_leaves(state.params)]
    out += [(f, getattr(state, f)) for f in (
        "alive", "max_radii2d", "xyz_gradient_accum", "denom", "deformation_accum",
        "deformation_table", "aabb")]
    for which in ("mu", "nu"):
        out += [(f"{which}.{n}", x)
                for n, x in adam.named_leaves(getattr(opt, which))]
    return out


def run_cli_chain(data_dir, model_path, dev, overrides=CLI_SCHEDULE, preset=None,
                  extra_args=()):
    """``train_torch.py`` → ``render_torch.py`` (test split) →
    ``metrics_torch.py`` on ``data_dir`` with ``preset`` (default the
    bouncingballs preset), ``overrides`` and ``train_torch.py``'s
    ``extra_args``, then phase 10 (b)'s checks
    (module docstring) but the PSNR's against the blank image, which
    :func:`check_entry_points` makes. Returns the walls, the scene's load
    time, the renders' FPS, the PSNRs, the points, the batch size, the
    launch counts of each script (zeroed just before it), the native
    prefetcher's frame counts over the training (``events.jsonl``),
    each stage's data-loading ms per step and share of the step's wall
    from ``timing_report.json`` (``utils/timer.py``), and the trained
    config and state."""
    import torch

    import bench_quality_torch as BQ
    import metrics_torch
    import render_torch
    import train_torch
    from fourdgs_tpu_torch.configs.core import config_from_dict
    from fourdgs_tpu_torch.data.scene import load_scene
    from fourdgs_tpu_torch.models import gaussians as G
    from fourdgs_tpu_torch.ops import blend
    from fourdgs_tpu_torch.render import CameraArrays, render
    from fourdgs_tpu_torch.train import checkpoint
    from fourdgs_tpu_torch.utils import losses, png

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def counted(fn):
        blend.blend_forward.launches = blend.blend_backward.launches = 0
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0, (blend.blend_forward.launches,
                                               blend.blend_backward.launches)

    iters = next(int(o.split("=")[1]) for o in overrides
                 if o.startswith("opt.iterations="))
    (state, opt), train_s, train_launches = counted(lambda: train_torch.main([
        "-s", data_dir, "--configs", preset or BQ.PRESET, "--model_path", model_path,
        "--quiet", "--test_iterations", str(iters), "--save_iterations", str(iters),
        "--device", dev.type, *extra_args, "--override", *overrides]))
    rendered, render_s, render_launches = counted(lambda: render_torch.main([
        "--model_path", model_path, "--skip_train", "--skip_video",
        "--device", dev.type]))
    results, metrics_s, metrics_launches = counted(
        lambda: metrics_torch.main(["--model_path", model_path, "--device", dev.type]))
    if metrics_launches != (0, 0):
        raise AssertionError(f"metrics_torch launched the blend: {metrics_launches}")

    for name in ("cfg_args.json", "timing_report.json", "training_logs.json",
                 "eval_log.jsonl", "events.jsonl"):
        if not os.path.exists(os.path.join(model_path, name)):
            raise AssertionError(f"train_torch.py wrote no {name}")
    eval_renders = sum("_render_" in f for f in os.listdir(
        os.path.join(model_path, "eval_images")))
    snap = os.path.join(model_path, "point_cloud", f"iteration_{iters}")
    for name in ("point_cloud.ply", "deformation.npz"):
        if not os.path.exists(os.path.join(snap, name)):
            raise AssertionError(f"the snapshot has no {name}")
    ckpt = checkpoint.find_stage_checkpoint(model_path, "fine")
    if ckpt is None or not ckpt.endswith(f"chkpnt_fine_{iters}"):
        raise AssertionError(f"no fine checkpoint at {iters}: {ckpt}")
    if eval_renders == 0:
        raise AssertionError("train_torch.py wrote no eval image")

    with open(os.path.join(model_path, "cfg_args.json")) as f:
        cfg = config_from_dict(json.load(f))
    prefetch = {"submitted": 0, "native": 0, "to_ref": 0}
    with open(os.path.join(model_path, "events.jsonl")) as f:   # train_torch's counts
        for event in map(json.loads, f):
            key = event["tag"].partition("/prefetch/")[2]
            if key:
                prefetch[key] += int(event["scalar"])
    with open(os.path.join(model_path, "timing_report.json")) as f:
        timing = json.load(f)["iterations"]
    loading = {}
    for stage in ("coarse", "fine"):
        rows = [r for r in timing if r["stage"] == stage]
        load = sum(r["phases"].get(f"{stage}_data_loading", 0.0) for r in rows)
        total = sum(r["total_time"] for r in rows)
        loading[stage] = {"ms_per_step": 1e3 * load / max(len(rows), 1),
                          "share": load / total if total else 0.0}
    c_state, c_opt, c_iter = checkpoint.load_checkpoint(ckpt, cfg, device=dev)
    pairs = list(zip(_checkpoint_leaves(c_state, c_opt), _checkpoint_leaves(state, opt)))
    differ = [a for (a, x), (_, y) in pairs if not torch.equal(x, y)]
    if (differ or c_iter != iters or c_opt.count != opt.count
            or c_state.active_sh_degree != state.active_sh_degree):
        raise AssertionError(f"the fine checkpoint does not reload the trained "
                             f"state: {differ[:5]}")

    snap_state = checkpoint.load_snapshot(snap, cfg, device=dev)
    bg = torch.ones(3, device=dev) if cfg.model.white_background else torch.zeros(3, device=dev)
    t0 = time.perf_counter()
    scene = load_scene(cfg, data_dir)
    test_cams = scene.test_cameras
    load_s = time.perf_counter() - t0
    base = os.path.join(model_path, "test", f"ours_{iters}")
    worst, blank = 0, []
    for i, lc in enumerate(test_cams):
        cam = lc.camera
        with torch.no_grad():
            img = render(snap_state.params, snap_state, CameraArrays.from_camera(cam, device=dev),
                         cfg, cam.width, cam.height, "fine", bg, cfg.model.sh_degree,
                         device=dev).color.cpu().numpy().transpose(1, 2, 0)
        want = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        got = png.read_png(os.path.join(base, "renders", f"{i:05d}.png"))
        worst = max(worst, int(np.abs(got.astype(int) - want.astype(int)).max()))
        gt = torch.tensor(png.read_png(os.path.join(base, "gt", f"{i:05d}.png")),
                          dtype=torch.float32).permute(2, 0, 1) / 255.0
        blank.append(float(losses.psnr(bg.cpu()[:, None, None].expand_as(gt), gt)))
    if worst > 1:
        raise AssertionError(f"render_torch.py's PNGs differ from the in-process "
                             f"render by {worst} levels")
    psnr = results[model_path][f"ours_{iters}"]["PSNR"]
    if not math.isfinite(psnr):
        raise AssertionError(f"held-out PSNR {psnr}")
    return {"train_s": train_s, "render_s": render_s, "metrics_s": metrics_s,
            "load_s": load_s,
            "fps": rendered["fps"]["test"], "psnr": psnr, "blank_psnr": float(np.mean(blank)),
            "metrics": results[model_path][f"ours_{iters}"],
            "points": int(G.count_alive(state)), "steps": iters + int(next(
                o.split("=")[1] for o in overrides if o.startswith("opt.coarse_iterations="))),
            "eval_renders": eval_renders, "test_views": len(test_cams),
            "render_max_level_diff": worst, "train_launches": train_launches,
            "render_launches": render_launches, "batch_size": cfg.opt.batch_size,
            "prefetch": prefetch, "data_loading": loading, "cfg": cfg, "state": state,
            "scene": scene}


def check_entry_points(dev, data_dir, model_path):
    """Phase 10 (module docstring): ``bench_torch.py`` and K1/K2 at its last
    step, then the D-NeRF CLI chain on a scene written to ``data_dir`` (which
    phases 13, 15 and 16 reuse), its model at ``model_path`` (whose fine
    checkpoint phase 16 (a) reads); returns the launch counts of each and
    :func:`check_bench_blend`'s fields for the kernels line."""
    import bench_torch
    from fourdgs_tpu_torch.ops import blend

    print("[10] the user's entry points: (a) bench_torch.py", flush=True)
    blend.blend_forward.launches = blend.blend_backward.launches = 0
    t0 = time.perf_counter()
    line, info, final = bench_torch.run(device=dev)
    bench_launches = (blend.blend_forward.launches, blend.blend_backward.launches)
    print(json.dumps(line))
    print(f"    {info['steps']} timed steps after {info['warmup']} warm-up in "
          f"{info['seconds']:.3f} s = {info['it_per_s']:.3f} it/s, loss "
          f"{info['loss']:.4f}, max instances {info['max_num_rendered']} "
          f"({time.perf_counter() - t0:.1f} s with the set-up); card: {info['device']}")
    print(f"    K1/K2 launches {bench_launches} (GT 1 + {info['warmup'] + info['steps']} "
          f"steps; {info['warmup'] + info['steps']} steps)")
    if bench_launches != (info["warmup"] + info["steps"] + 1,
                          info["warmup"] + info["steps"]):
        raise AssertionError(f"bench_torch launched K1/K2 {bench_launches} times")
    bench_blend = check_bench_blend(final, dev)
    del final

    print("    (b) a D-NeRF scene, then train_torch.py -> render_torch.py -> "
          "metrics_torch.py", flush=True)
    t0 = time.perf_counter()
    write_dnerf_scene(data_dir, dev)
    scene_s = time.perf_counter() - t0
    cli = run_cli_chain(data_dir, model_path, dev)
    k1_train, k2_train = cli["train_launches"]
    k1_render, k2_render = cli["render_launches"]
    print(f"    scene {WIDTH}x{HEIGHT}, 20 train + 4 test views written in {scene_s:.1f} s; "
          f"train wall {cli['train_s']:.3f} s ({cli['steps']} steps, "
          f"{cli['steps'] / cli['train_s']:.3f} it/s with the evals and saves, "
          f"{cli['points']} points), render wall {cli['render_s']:.3f} s "
          f"(FPS {cli['fps']:.3f}), metrics {cli['metrics_s']:.3f} s; load_scene "
          f"(every frame, Paeth-filtered rows) {cli['load_s']:.3f} s")
    print(f"    held-out PSNR {cli['psnr']:.4f} dB (blank image {cli['blank_psnr']:.4f}); "
          f"metrics {json.dumps(cli['metrics'])}; renders vs in-process render: "
          f"max {cli['render_max_level_diff']} levels; the fine checkpoint reloads "
          f"to the same leaves")
    print(f"    K1/K2 launches: train {cli['train_launches']} ({cli['steps']} steps + "
          f"{cli['eval_renders']} eval views), render {cli['render_launches']} "
          f"({cli['test_views']} views + 1 warm-up)")
    if not cli["psnr"] > cli["blank_psnr"]:
        raise AssertionError(f"held-out PSNR {cli['psnr']} not above the blank "
                             f"image's {cli['blank_psnr']}")
    if (k2_train != cli["steps"] or k1_train != cli["steps"] + cli["eval_renders"]
            or (k1_render, k2_render) != (cli["test_views"] + 1, 0)):
        raise AssertionError(f"CLI launches: train {cli['train_launches']}, render "
                             f"{cli['render_launches']}")
    return {"bench": bench_launches, "bench_blend": bench_blend,
            "cli": (k1_train + k1_render, k2_train)}


DYNERF_FRAMES = 6          # frames per camera of phase 11 (c)'s scene
# phase 11 (c): 20 + 60 steps, cut to 10 + 30 to pay for phase 16, to
# 6 + 18 to pay for phase 17 and to 4 + 12 to pay for phase 18
DYNERF_CLI_SCHEDULE = ("opt.coarse_iterations=4", "opt.iterations=12",
                       "opt.position_lr_max_steps=12", 'opt.custom_sampler="fine"')


class _Tee:
    """Standard output copied into a buffer (to find a line a run printed)."""

    def __init__(self):
        import io
        self.buf, self.out = io.StringIO(), sys.stdout

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def printed(fn):
    """(fn(), what it printed), the output still printed."""
    tee = _Tee()
    sys.stdout = tee
    try:
        return fn(), tee.buf.getvalue()
    finally:
        sys.stdout = tee.out


def check_padding(out5, plain5, g_out, gt_tiles, height, width, dev):
    """The tile grid's padding pixels (outside ``height`` × ``width``) at a
    train step's shapes: K1's colour and T there against its plain
    version's under :func:`compare_blend`'s contract, the step's L1
    cotangent exactly 0 there, and the L1 unchanged when those pixels of
    the render are replaced by noise. Returns the counts and errors."""
    import torch

    from fourdgs_tpu_torch.utils import losses

    mask = losses.tile_pixel_mask(height, width, device=dev)       # [T, 1, 256]
    pad = (mask[:, 0] == 0)                                        # [T, 256]
    n_pad = int(pad.sum())
    if n_pad == 0:
        raise AssertionError(f"{width}x{height} has no padding pixel")

    def rows(x):                                                   # [N, 5, 1]
        return x.permute(0, 2, 1)[pad][:, :, None]

    cmp = compare_blend(rows(out5), rows(plain5))
    cot_zero = bool((g_out.permute(0, 2, 1)[pad] == 0).all())
    keep = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0], device=dev)[:, None] * mask

    def l1(o):
        return float(losses.abs_((o - gt_tiles) * keep).sum())

    noise = torch.rand(out5.shape, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0))
    noisy = out5 + noise * (1 - mask)
    same_loss = l1(out5) == l1(noisy)
    res = {"padding_pixels": n_pad, "of_pixels": pad.numel(),
           "max_abs_err": cmp["max_abs_err"], "over_1e-4": cmp["over_1e-4"],
           "cotangent_zero": cot_zero, "loss_unchanged_by_noise": same_loss}
    if not (cot_zero and same_loss):
        raise AssertionError(f"the loss reads the padding pixels: {res}")
    return res


def check_dynerf_bench(dev, scale, instant4d=False):
    """Phase 11 (a) or (b): ``bench_quality_dynerf_torch.run`` at ``scale``
    with the launch counts zeroed just before it (by the run, after its GT
    renders) and read just after; returns the result, the trained model
    and the launches."""
    import bench_quality_dynerf_torch as BD
    from fourdgs_tpu_torch.ops import blend

    t0 = time.perf_counter()
    (res, model), out = printed(lambda: BD.run(scale=scale, instant4d=instant4d,
                                                log_interval=50, device=dev))
    launches = (blend.blend_forward.launches, blend.blend_backward.launches)
    steps = res["schedule"]["coarse"] + res["schedule"]["fine"]
    renders = steps * res["batch_size"] if dev.type == "cuda" else 0   # the plain path
    log = res["train_log"]
    print(f"    {res['resolution'][0]}x{res['resolution'][1]}, {res['cams_train']} cams x "
          f"{res['timestamps']} t, batch {res['batch_size']}, sh {res['sh_degree']}, "
          f"isotropic {res['isotropic']}, {res['schedule']} steps "
          f"({time.perf_counter() - t0:.1f} s with the GT and the eval): held-out PSNR "
          f"{res['test_psnr_db']:.4f} dB, final points {res['final_points']}, train wall "
          f"{res['train_wall_clock_s']:.3f} s, it/s {res['it_per_s']:.3f}")
    print(f"    K1 launches {res['k1_launches']} (renders {renders} + eval views "
          f"{res['eval_views']}; GT {res['gt_launches']} apart), K2 launches "
          f"{res['k2_launches']}; budget growths {res['budget_growths']} (final "
          f"{res['final_instance_budget']}), capacity growths {res['capacity_growths']} "
          f"(final {res['final_capacity']}), resets {res['resets']}; train PSNR "
          f"{res['first_train_psnr']:.4f} -> {res['last_train_psnr']:.4f}")
    print(f"    stage seconds {json.dumps(res['stage_s'])}")
    if launches != (res["k1_launches"], res["k2_launches"]):
        raise AssertionError(f"the counts moved after the run: {launches}")
    evals = res["eval_views"] if dev.type == "cuda" else 0
    if (res["k2_launches"], res["k1_launches"]) != (renders, renders + evals):
        raise AssertionError(f"launches K1 {res['k1_launches']}, K2 {res['k2_launches']}; "
                             f"expected {renders + evals}, {renders}")
    if "[sampler] WARNING" in out:
        raise AssertionError("the FineSampler did not engage on the camera-major layout")
    bad = [e for e in log if not math.isfinite(e["loss"])]
    if bad:
        raise AssertionError(f"a logged loss is not finite: first at {bad[0]['stage']} "
                             f"iteration {bad[0]['iter']}")
    if not res["last_train_psnr"] > res["first_train_psnr"]:
        raise AssertionError(f"train PSNR did not rise: {res['first_train_psnr']} -> "
                             f"{res['last_train_psnr']}")
    return res, model, launches


def render_gt(cam, dev, bg, budget=None):
    """uint8 [H, W, 3] of ``bench_quality_torch.py``'s GT scene at
    ``cam.time`` through K1 on ``bg``, with ``budget`` instances (default
    ``bench_quality_torch.GT_BUDGET``)."""
    import torch

    import bench_quality_torch as BQ
    from fourdgs_tpu_torch.ops.rasterize import rasterize_pallas
    from fourdgs_tpu_torch.render import CameraArrays

    pts, cols, scales, offsets = BQ.make_gt_scene()
    extra = {k: torch.tensor(v, device=dev)
             for k, v in BQ.gt_raster_args(pts, cols, scales).items()}
    c = CameraArrays.from_camera(cam, device=dev)
    with torch.no_grad():
        out = rasterize_pallas(
            torch.tensor(pts + offsets(cam.time), device=dev), extra["scales"],
            extra["rotations"], extra["opacities"], extra["shs"], c.camera_center,
            c.world_view, c.full_proj, c.tanfovx, c.tanfovy, cam.width, cam.height, 0,
            torch.tensor(bg, dtype=torch.float32, device=dev),
            instance_budget=budget or BQ.GT_BUDGET)
    if int(out.num_rendered) > (budget or BQ.GT_BUDGET):
        raise AssertionError(f"a GT frame overflowed its budget: {int(out.num_rendered)}")
    return (out.color.permute(1, 2, 0) * 255 + 0.5).clamp(0, 255).to(torch.uint8).cpu().numpy()


def _init_cloud():
    """(points, colours) of the DyNeRF bench's 8,000-point init cloud of the
    GT scene: 4,000 noisy surface points, then 4,000 uniform ones."""
    import bench_quality_dynerf_torch as BD
    import bench_quality_torch as BQ

    return BD.init_cloud(BQ.make_gt_scene()[0])


def write_dynerf_scene(root, dev, n_frames=DYNERF_FRAMES, size=(1352, 1014), n_cams=4,
                       budget=None):
    """Write a DyNeRF (Neu3D) scene under ``root`` with the port's PNG
    writer: ``poses_bounds.npy`` for ``n_cams`` cameras of the DyNeRF bench's
    ring, ``cam00…/images/0000.png…`` (``n_frames`` each, at ``size``, the
    loader's 1352×1014 by default, every filter type in turn) that K1
    renders from the GT scene on black at the loader's times i/300 (with
    ``budget`` instances, :func:`render_gt`'s default if None), and the
    bench's 8,000-point init cloud as ``points3D_downsample2.ply``. The
    poses invert the loader's LLFF convention so that it rebuilds each
    ring camera. Returns the cameras per camera index."""
    import bench_quality_dynerf_torch as BD
    import bench_quality_torch as BQ
    from fourdgs_tpu_torch.data.ply import store_pointcloud
    from fourdgs_tpu_torch.utils import graphics, png

    W, H = size
    fov = 0.6911112070083618
    focal = graphics.fov2focal(fov, W)
    fovy = graphics.focal2fov(focal, H)
    rows, cameras = [], {}
    for ci, (ang, elev) in enumerate(BD.camera_poses()[:n_cams]):
        ring = BQ.ring_camera(ang, elev, W, H, 0.0)
        R = np.asarray(ring.world_view, np.float64)[:3, :3]     # world_view[:3, :3] = R
        eye = np.asarray(ring.camera_center, np.float64)
        m = R @ np.diag([1.0, -1.0, -1.0])                       # the loader's pose [:3, :3]
        llff = np.concatenate([-m[:, 1:2], m[:, 0:1], m[:, 2:3], eye[:, None],
                               np.array([[H * 2.0], [W * 2.0], [focal * 2704.0 / W]])],
                              axis=1)
        rows.append(np.concatenate([llff.reshape(-1), [0.5, 10.0]]))
        img_dir = os.path.join(root, f"cam{ci:02d}", "images")
        os.makedirs(img_dir)
        cameras[ci] = []
        for fi in range(n_frames):
            t = fi / 300
            cam = graphics.make_camera(R, -R.T @ eye, fov, fovy, W, H, time=t)
            png.write_png(os.path.join(img_dir, f"{fi:04d}.png"),
                          render_gt(cam, dev, [0.0, 0.0, 0.0], budget),
                          filter_type=(ci + fi) % 5)
            cameras[ci].append(cam)
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows))
    init_pts, init_cols = _init_cloud()
    store_pointcloud(os.path.join(root, "points3D_downsample2.ply"), init_pts,
                     init_cols * 255)
    return cameras


def dynerf_cull_read(model, dev):
    """The instance demand (``num_rendered``) of train view 0 of a trained
    model with ``tpu.ellipse_tile_cull`` off and on: how much of it is dead
    corner cells. A read only: the cull is output-exact, and the model's
    config is left as it was."""
    import copy

    import torch

    from fourdgs_tpu_torch import render as TR

    cam0 = model.train_cams[0][0]
    cam = TR.CameraArrays.from_camera(cam0, device=dev)
    cfg_on = copy.deepcopy(model.cfg)
    cfg_on.tpu.ellipse_tile_cull = True
    out = {}
    with torch.no_grad():
        for name, c in (("off", model.cfg), ("on", cfg_on)):
            st = model.state
            out[name] = int(TR.render(st.params, st, cam, c, cam0.width, cam0.height,
                                      "fine", model.bg, st.active_sh_degree,
                                      device=dev).num_rendered)
    return out


def check_dynerf_path(dev):
    """Phase 11 (module docstring): the DyNeRF bench at scale 0.0075 with
    K1/K2 and the padding on its trained model, at 0.0075 with
    ``--instant4d``, then the DyNeRF CLI chain on lazy frames. Returns the
    launches and :func:`check_trained_blend`'s fields for the kernels
    line."""
    import torch

    import bench_quality_dynerf_torch as BD
    from fourdgs_tpu_torch import render as TR
    from fourdgs_tpu_torch.ops import blend
    from fourdgs_tpu_torch.utils import losses

    print("[11] the DyNeRF path: (a) bench_quality_dynerf_torch --scale 0.0075", flush=True)
    a, model, a_launches = check_dynerf_bench(dev, 0.0075)
    fwd_args, bwd_args = view_blend_inputs(model, 0, dev)
    cfg, state = model.cfg, model.state
    W, H = a["resolution"]
    trained = check_step_blend(
        fwd_args, bwd_args, dev,
        f"train view 0 of the DyNeRF model ({W}x{H}, {fwd_args[1].numel()} tiles, "
        f"batch {cfg.opt.batch_size}, capacity {state.alive.shape[0]}, "
        f"{int(state.alive.sum())} alive, budget {cfg.tpu.instance_budget})")
    frame = torch.tensor(model.train_cams[0][1], device=dev).to(torch.float32)
    gt_tiles = losses.tile_image(frame.permute(2, 0, 1) / 255.0, pad_cols=2)
    pad = check_padding(bwd_args[5], blend.blend_forward_plain(*fwd_args), bwd_args[6],
                        gt_tiles, H, W, dev)
    print(f"    padding of the {W}x{H} grid: {pad}")
    cull_read = dynerf_cull_read(model, dev)
    print(f"    the cull's read of the trained model (view 0, changes nothing): "
          f"num_rendered {cull_read['off']} with the cull off, {cull_read['on']} on, "
          f"against the budget {cfg.tpu.instance_budget}")
    del model

    print("    (b) bench_quality_dynerf_torch --scale 0.0075 --instant4d", flush=True)
    b, model, _ = check_dynerf_bench(dev, 0.0075, instant4d=True)
    st = model.state
    cam = TR.CameraArrays.from_camera(model.train_cams[0][0], device=dev)
    with torch.no_grad():
        sc = TR.activated_gaussians(st.params, st, cam, "fine", True)[1][st.alive]
    iso = bool((sc[:, 1] == sc[:, 0]).all() & (sc[:, 2] == sc[:, 0]).all())
    print(f"    {int(st.alive.sum())} live Gaussians: three equal scales after the "
          f"broadcast = {iso}")
    if not iso or model.cfg.model.sh_degree != 0:
        raise AssertionError("the Instant4D model is not isotropic at SH degree 0")
    del model

    print("    (c) a DyNeRF scene on disk, then train_torch.py -> render_torch.py -> "
          "metrics_torch.py on its lazy frames", flush=True)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_dynerf_") as tmp:
        data_dir, model_path = os.path.join(tmp, "data"), os.path.join(tmp, "model")
        t0 = time.perf_counter()
        written = write_dynerf_scene(data_dir, dev)
        scene_s = time.perf_counter() - t0
        cli, out = printed(lambda: run_cli_chain(data_dir, model_path, dev,
                                                 DYNERF_CLI_SCHEDULE, BD.PRESET))
    (k1_train, k2_train), (k1_render, k2_render) = cli["train_launches"], cli["render_launches"]
    renders = cli["steps"] * cli["batch_size"]
    on_card = int(dev.type == "cuda")       # the plain path launches nothing
    pf = cli["prefetch"]
    cam0 = written[0][0]
    print(f"    scene: {len(written)} cams x {len(written[0])} frames at {cam0.width}x"
          f"{cam0.height} written in "
          f"{scene_s:.1f} s; load_scene {cli['load_s']:.3f} s (lazy frames); train wall "
          f"{cli['train_s']:.3f} s ({cli['steps']} steps, batch {cli['batch_size']}, "
          f"{cli['points']} points), render wall {cli['render_s']:.3f} s (FPS "
          f"{cli['fps']:.3f}), metrics {cli['metrics_s']:.3f} s")
    print(f"    prefetcher: {pf['submitted']} frames submitted, {pf['native']} decoded "
          f"natively, {pf['to_ref']} sent to the ref; data loading per step "
          f"{json.dumps(cli['data_loading'])}")
    print(f"    held-out PSNR {cli['psnr']:.4f} dB (blank image {cli['blank_psnr']:.4f}); "
          f"renders vs in-process render: max {cli['render_max_level_diff']} levels")
    print(f"    K1/K2 launches: train {cli['train_launches']} ({renders} renders of "
          f"{cli['steps']} steps + {cli['eval_renders']} eval views), render "
          f"{cli['render_launches']} ({cli['test_views']} views + 1 warm-up)")
    if "[sampler] WARNING" in out:
        raise AssertionError("the FineSampler did not engage on the DyNeRF scene")
    if pf["submitted"] != renders or pf["native"] != renders or pf["to_ref"]:
        raise AssertionError(f"the prefetcher decoded {pf}, expected {renders} natively")
    if not cli["psnr"] > cli["blank_psnr"]:
        raise AssertionError(f"held-out PSNR {cli['psnr']} not above the blank "
                             f"image's {cli['blank_psnr']}")
    if ((k2_train, k1_train) != (on_card * renders, on_card * (renders + cli["eval_renders"]))
            or (k1_render, k2_render) != (on_card * (cli["test_views"] + 1), 0)):
        raise AssertionError(f"CLI launches: train {cli['train_launches']}, render "
                             f"{cli['render_launches']}")
    return {"bench": a_launches, "bench_blend": trained, "padding": pad,
            "instant4d": (b["k1_launches"], b["k2_launches"]),
            "cli": (k1_train + k1_render, k2_train)}


HYPERNERF_PRESET = os.path.join(ROOT, "fourdgs_tpu", "configs", "presets", "hypernerf",
                                "default.py")
MULTIPLEVIEW_PRESET = os.path.join(ROOT, "fourdgs_tpu", "configs", "presets", "multipleview",
                                   "default.py")
HYPERNERF_FRAMES = 48              # frames of phase 12 (a)'s scene, two cameras in turn
HYPERNERF_IMAGE_SIZE = (1080, 1920)   # camera/<id>.json's (W, H); rgb/2x holds half
HYPERNERF_FOCAL = 1400.0           # at the full size
JPEG_FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures", "jpeg")
JPEG_SCENE_CAMS, JPEG_SCENE_FRAMES = 3, 4    # phase 12 (b)'s scenes: 12 committed frames
JPEG_SCENE_SIZE = (160, 120)
# the progressive JPEGs and the PNG variants of phase 16 (b), and Pillow's
# decodes of them (tests/test_torch_progressive.py::write_committed_fixtures)
VARIANT_FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures", "variants")
CAPTURE_FRAME = "capture_1352x1014"     # one picture, progressive and baseline
MULTIPLEVIEW_SCHEDULE = ("opt.coarse_iterations=12", "opt.iterations=36",
                         "opt.position_lr_max_steps=36")
# the JPEG tolerance against Pillow (tests/test_torch_jpeg.py): two conforming
# decoders may round the IDCT differently (T.81 leaves it to the decoder),
# and the colour transform multiplies a chroma difference of 1 by up to 1.772
JPEG_MAX_LEVELS, JPEG_MEAN_LEVELS = 2, 0.02


def hypernerf_camera_json(i, n_frames=HYPERNERF_FRAMES, image_size=HYPERNERF_IMAGE_SIZE,
                          focal=HYPERNERF_FOCAL):
    """``camera/<id>.json`` of frame ``i``: two phone cameras in turn (even
    frames the left, odd the right, 0.06 rad apart) walking an arc of 1 rad
    around the GT scene at elevation 0.35, looking at its centre, pinhole
    (the released rgb/2x frames are rectified)."""
    import bench_quality_torch as BQ

    ang = -0.5 + i / max(n_frames - 1, 1) + (0.06 if i % 2 else 0.0)
    ring = BQ.ring_camera(ang, 0.35, 8, 8, 0.0)
    R = np.asarray(ring.world_view, np.float64)[:3, :3]      # camera-to-world axes
    W, H = image_size
    return {"orientation": R.T.tolist(), "position": np.asarray(
                ring.camera_center, np.float64).tolist(),
            "focal_length": focal, "principal_point": [W / 2, H / 2],
            "image_size": [W, H], "skew": 0.0, "pixel_aspect_ratio": 1.0,
            "radial_distortion": [0.0, 0.0, 0.0], "tangential_distortion": [0.0, 0.0]}


def write_hypernerf_scene(root, dev, n_frames=HYPERNERF_FRAMES,
                          image_size=HYPERNERF_IMAGE_SIZE):
    """Write a HyperNeRF (Nerfies) scene in the vrig layout under ``root``
    with the port's PNG writer: ``scene.json``, ``metadata.json`` (``warp_id``
    = frame index), ``dataset.json`` (the left camera's frames train, the
    right's validate), ``camera/<id>.json`` (:func:`hypernerf_camera_json`),
    ``rgb/2x/<id>.png`` at half of ``image_size`` (the focal length scaled
    with it, so that any size frames the same view) that K1 renders from the GT
    scene on the hypernerf preset's white background at the loader's times
    (warp_id / max warp_id), covisible masks ``covisible/2x/val/<id>.png``
    for the val ids (0 over the columns [0.8 W, W), the right camera's edge
    that the left one does not see, 255 elsewhere), and the
    4,000 surface points of the DyNeRF bench's init cloud (the GT scene's,
    with N(0, 0.05) noise; a capture's ``points.npy`` holds its sparse
    reconstruction) as ``points.npy``. Returns (the loader's cameras by id,
    the masks by id)."""
    from fourdgs_tpu_torch.utils import graphics, png

    ids = [f"{i:06d}" for i in range(n_frames)]
    w, h = int(image_size[0] * 0.5), int(image_size[1] * 0.5)
    focal = HYPERNERF_FOCAL * image_size[0] / HYPERNERF_IMAGE_SIZE[0]   # the same view
    for d in ("camera", os.path.join("rgb", "2x"), os.path.join("covisible", "2x", "val")):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    with open(os.path.join(root, "scene.json"), "w") as f:
        json.dump({"scale": 1.0, "center": [0.0, 0.0, 0.0], "near": 0.5, "far": 10.0}, f)
    with open(os.path.join(root, "metadata.json"), "w") as f:
        json.dump({k: {"warp_id": i, "appearance_id": i, "camera_id": i % 2}
                   for i, k in enumerate(ids)}, f)
    with open(os.path.join(root, "dataset.json"), "w") as f:
        json.dump({"count": n_frames, "num_exemplars": n_frames // 2, "ids": ids,
                   "train_ids": ids[0::2], "val_ids": ids[1::2]}, f)
    mask = np.full((h, w), 255, np.uint8)
    mask[:, int(0.8 * w):] = 0        # what the left (train) camera does not see
    cameras, masks = {}, {}
    for i, k in enumerate(ids):
        cj = hypernerf_camera_json(i, n_frames, image_size, focal)
        with open(os.path.join(root, "camera", f"{k}.json"), "w") as f:
            json.dump(cj, f)
        R = np.asarray(cj["orientation"]).T                    # the loader's pose
        T = -np.asarray(cj["position"]) @ R
        fovx, fovy = graphics.focal2fov(focal * 0.5, w), graphics.focal2fov(focal * 0.5, h)
        cam = graphics.make_camera(R, T, fovx, fovy, w, h, time=i / (n_frames - 1))
        png.write_png(os.path.join(root, "rgb", "2x", f"{k}.png"), render_gt(cam, dev, [1.0] * 3),
                      filter_type=i % 5)
        if i % 2:
            png.write_png(os.path.join(root, "covisible", "2x", "val", f"{k}.png"), mask)
            masks[k] = mask
        cameras[k] = cam
    np.save(os.path.join(root, "points.npy"), _init_cloud()[0][:4000])
    return cameras, masks


def progress_saves(iterations):
    """The ``render_process`` frames of a stage of ``iterations`` steps."""
    from fourdgs_tpu_torch.utils import debug_images

    return [i for i in range(1, iterations + 1) if debug_images.should_save_progress(i)]


def check_hypernerf_path(dev, n_frames=HYPERNERF_FRAMES, image_size=HYPERNERF_IMAGE_SIZE,
                         schedule=HYPERNERF_SCHEDULE, preset=HYPERNERF_PRESET, root=None):
    """Phase 12 (a) (module docstring): the HyperNeRF scene, the CLI chain
    with ``--debug_mode``, the outputs of ``render_process``, the masks and
    the masked PSNRs, then K1/K2 at a train step of the trained model on its
    padded grid, in ``root`` (kept) or a temporary directory. Returns the
    launches, the kernels-line fields and the masked PSNRs of the model and
    of a blank image, which the caller compares (a cut schedule's model need
    not beat the blank)."""
    import torch

    from fourdgs_tpu_torch.data.hypernerf import read_mask
    from fourdgs_tpu_torch.render import CameraArrays, render
    from fourdgs_tpu_torch.ops import blend
    from fourdgs_tpu_torch.utils import losses, png

    print("[12] the loaders: (a) a HyperNeRF scene (vrig, portrait phone frames), then "
          "train_torch.py --debug_mode -> render_torch.py -> metrics_torch.py", flush=True)
    with (contextlib.nullcontext(root) if root else
          tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_hypernerf_")) as tmp:
        data_dir, model_path = os.path.join(tmp, "data"), os.path.join(tmp, "model")
        t0 = time.perf_counter()
        cameras, masks = write_hypernerf_scene(data_dir, dev, n_frames, image_size)
        scene_s = time.perf_counter() - t0
        cli, _ = printed(lambda: run_cli_chain(data_dir, model_path, dev, schedule, preset,
                                               extra_args=("--debug_mode",)))
        cfg, state = cli["cfg"], cli["state"]
        stages = {"coarse": cfg.opt.coarse_iterations, "fine": cfg.opt.iterations}
        # render_process frames and debug panels at JAX's iterations
        def listed(*parts):
            d = os.path.join(model_path, *parts)
            return sorted(os.listdir(d)) if os.path.isdir(d) else []

        frames = {st: [int(f[:-4]) for f in listed("train_render", f"{st}test")]
                  for st in stages}
        panels = listed("debug_images")
        want_panels = sorted(f"{st}_{i:06d}.png" for st, n in stages.items()
                             for i in range(100, n + 1, 100))
        for st, n in stages.items():
            if frames[st] != progress_saves(n):
                raise AssertionError(f"render_process frames of {st}: {frames[st]}")
        if panels != want_panels:
            raise AssertionError(f"debug panels {panels}, expected {want_panels}")
        extra_renders = sum(len(v) for v in frames.values()) + len(panels)
        with open(os.path.join(model_path, "eval_log.jsonl")) as f:
            eval_log = [json.loads(line) for line in f][-1]
        # masks/ of render_torch.py against the sources; the masked PSNR of
        # metrics_torch.py against the same computed here from the PNGs
        iters = cfg.opt.iterations
        base = os.path.join(model_path, "test", f"ours_{iters}")
        data = cli["scene"]
        bg = torch.ones(3, device=dev)
        own, blank = [], []
        for vi, lc in enumerate(data.test_cameras):
            key = os.path.basename(lc.mask_path)[:-4]
            got_mask = png.read_png(os.path.join(base, "masks", f"{vi:05d}.png"))
            if not np.array_equal(got_mask, masks[key]):
                raise AssertionError(f"masks/{vi:05d}.png differs from its source")
            mask = torch.tensor(read_mask(lc.mask_path, lc.camera.width, lc.camera.height),
                                dtype=torch.float32, device=dev)
            ren = torch.tensor(png.read_png(os.path.join(base, "renders", f"{vi:05d}.png")),
                               dtype=torch.float32, device=dev).permute(2, 0, 1) / 255.0
            gt = torch.tensor(lc.image(), dtype=torch.float32,
                              device=dev).permute(2, 0, 1) / 255.0
            own.append(float(losses.masked_psnr(ren, gt, mask)))
            blank.append(float(losses.masked_psnr(bg[:, None, None].expand_as(gt), gt, mask)))
            unmasked = float(losses.psnr(ren[None], gt[None])[0])
        masked_own, masked_blank = float(np.mean(own)), float(np.mean(blank))
        # K1/K2 at a train step of the trained model: train view 0
        lc0 = data.train_cameras[0]
        cam0 = lc0.camera
        gt0 = torch.tensor(lc0.image(), device=dev).to(torch.float32).permute(2, 0, 1) / 255.0
        gt_tiles = losses.tile_image(gt0, pad_cols=2)
        fwd_args, bwd_args = step_blend_inputs(
            cfg, state, CameraArrays.from_camera(cam0, device=dev), cam0.width, cam0.height,
            gt_tiles, bg, state.active_sh_degree, dev)
        trained = check_step_blend(
            fwd_args, bwd_args, dev,
            f"train view 0 of the HyperNeRF model ({cam0.width}x{cam0.height} portrait, "
            f"{fwd_args[1].numel()} tiles, batch {cfg.opt.batch_size}, capacity "
            f"{state.alive.shape[0]}, {int(state.alive.sum())} alive, budget "
            f"{cfg.tpu.instance_budget})")
        pad = check_padding(bwd_args[5], blend.blend_forward_plain(*fwd_args), bwd_args[6],
                            gt_tiles, cam0.height, cam0.width, dev)
    (k1_train, k2_train), (k1_render, k2_render) = cli["train_launches"], cli["render_launches"]
    renders = cli["steps"] * cli["batch_size"]
    on_card = int(dev.type == "cuda")
    pf = cli["prefetch"]
    w, h = cam0.width, cam0.height
    print(f"    scene: {n_frames} frames at {w}x{h} ({len(data.train_cameras)} train, "
          f"{len(data.test_cameras)} val with covisible masks) written in {scene_s:.1f} s; "
          f"load_scene {cli['load_s']:.3f} s; train wall {cli['train_s']:.3f} s "
          f"({cli['steps']} steps of batch {cli['batch_size']}, "
          f"{cli['steps'] / cli['train_s']:.3f} it/s with the evals, saves and debug images, "
          f"{cli['points']} points), render wall {cli['render_s']:.3f} s (FPS "
          f"{cli['fps']:.3f}), metrics {cli['metrics_s']:.3f} s")
    print(f"    render_process frames {json.dumps({k: len(v) for k, v in frames.items()})} at "
          f"should_save_progress's iterations, debug panels {len(panels)} every 100")
    print(f"    prefetcher: {pf['submitted']} frames submitted, {pf['native']} decoded "
          f"natively, {pf['to_ref']} sent to the ref; data loading per step "
          f"{json.dumps(cli['data_loading'])}")
    print(f"    eval_log.jsonl at {eval_log['iteration']}: test (masked) PSNR "
          f"{eval_log['test']['psnr']:.4f} dB, train PSNR {eval_log['train']['psnr']:.4f}")
    print(f"    metrics_torch.py masked PSNR {cli['psnr']:.6f} dB, computed here "
          f"{masked_own:.6f}; blank (white) image masked {masked_blank:.4f}; the last view "
          f"unmasked {unmasked:.4f}; masks/ equal to the sources; renders vs in-process "
          f"render: max {cli['render_max_level_diff']} levels")
    print(f"    padding of the {w}x{h} grid: {pad}")
    print(f"    K1/K2 launches: train {cli['train_launches']} ({renders} renders of "
          f"{cli['steps']} steps + {cli['eval_renders']} eval views + {extra_renders} "
          f"render_process and debug renders), render {cli['render_launches']} "
          f"({cli['test_views']} views + 1 warm-up)")
    if abs(cli["psnr"] - masked_own) > 1e-5:
        raise AssertionError(f"metrics_torch.py's masked PSNR {cli['psnr']} against "
                             f"{masked_own} computed here")
    if pf["submitted"] != renders or pf["native"] != renders or pf["to_ref"]:
        raise AssertionError(f"the prefetcher decoded {pf}, expected {renders} natively")
    if ((k2_train, k1_train) != (on_card * renders,
                                 on_card * (renders + cli["eval_renders"] + extra_renders))
            or (k1_render, k2_render) != (on_card * (cli["test_views"] + 1), 0)):
        raise AssertionError(f"CLI launches: train {cli['train_launches']}, render "
                             f"{cli['render_launches']}")
    return {"cli": (k1_train + k1_render, k2_train), "blend": trained, "padding": pad,
            "masked_psnr": cli["psnr"], "blank_masked_psnr": masked_blank}


def jpeg_scene_camera(c, f, size=JPEG_SCENE_SIZE):
    """Camera ``c`` of phase 12 (b)'s scenes at frame ``f``: the DyNeRF
    bench's ring camera ``c`` at ``size``, one focal length for both axes
    (as the MultipleView loader reads it), time f / JPEG_SCENE_FRAMES.
    Returns (camera, focal, camera-to-world rotation, centre)."""
    import bench_quality_dynerf_torch as BD
    import bench_quality_torch as BQ
    from fourdgs_tpu_torch.utils import graphics

    W, H = size
    ang, elev = BD.camera_poses()[c]
    ring = BQ.ring_camera(ang, elev, W, H, 0.0)
    R = np.asarray(ring.world_view, np.float64)[:3, :3]
    eye = np.asarray(ring.camera_center, np.float64)
    focal = graphics.fov2focal(0.6911112070083618, W)
    cam = graphics.make_camera(R, -R.T @ eye, graphics.focal2fov(focal, W),
                               graphics.focal2fov(focal, H), W, H,
                               time=f / JPEG_SCENE_FRAMES)
    return cam, focal, R, eye


def jpeg_frame(c, f):
    """The committed JPEG of camera ``c`` at frame ``f``."""
    return os.path.join(JPEG_FIXTURES, f"frame_c{c}_f{f}.jpg")


def progressive_frame(c, f):
    """The committed progressive JPEG of the picture :func:`jpeg_frame`
    holds (the same quantized coefficients, so the same decode)."""
    return os.path.join(VARIANT_FIXTURES, f"prog_frame_c{c}_f{f}.jpg")


def write_multipleview_scene(root, frame=jpeg_frame):
    """A MultipleView scene of the committed frames (``frame(c, f)``'s file):
    ``cam01…cam03/frame_00001.jpg…``, ``sparse_/0`` (one PINHOLE camera, an image per
    rig camera named ``image<NN>.jpg``, no points) by the port's COLMAP
    writers, ``poses_bounds_multipleview.npy`` in the LLFF convention and
    the init cloud as ``points3D_multipleview.ply``."""
    import shutil

    from fourdgs_tpu_torch.data import colmap_io
    from fourdgs_tpu_torch.data.ply import store_pointcloud

    W, H = JPEG_SCENE_SIZE
    images, rows = {}, []
    for c in range(JPEG_SCENE_CAMS):
        folder = os.path.join(root, f"cam{c + 1:02d}")
        os.makedirs(folder)
        for f in range(JPEG_SCENE_FRAMES):
            shutil.copy(frame(c, f), os.path.join(folder, f"frame_{f + 1:05d}.jpg"))
        cam, focal, R, eye = jpeg_scene_camera(c, 0)
        wv = np.asarray(cam.world_view, np.float64)
        images[c + 1] = colmap_io.ColmapImage(
            c + 1, colmap_io.rotmat2qvec(R.T), wv[3, :3].copy(), 1, f"image{c + 1:02d}.jpg",
            np.zeros((0, 2)), np.zeros(0, np.int64))
        m = R @ np.diag([1.0, -1.0, -1.0])
        llff = np.concatenate([-m[:, 1:2], m[:, 0:1], m[:, 2:3], eye[:, None],
                               np.array([[H], [W], [focal]])], axis=1)
        rows.append(np.concatenate([llff.reshape(-1), [0.5, 10.0]]))
    cams = {1: colmap_io.ColmapCamera(1, "PINHOLE", W, H,
                                      np.array([focal, focal, W / 2, H / 2]))}
    colmap_io.write_model(cams, images, {}, os.path.join(root, "sparse_", "0"))
    np.save(os.path.join(root, "poses_bounds_multipleview.npy"), np.stack(rows))
    pts, cols = _init_cloud()
    store_pointcloud(os.path.join(root, "points3D_multipleview.ply"), pts, cols * 255)


def write_panoptic_scene(root):
    """A PanopticSports scene of the committed frames: ``ims/<c>/<f>.jpg``,
    ``train_meta.json`` and ``test_meta.json`` (K and w2c of each camera at
    each of the frames) and ``init_pt_cld.npz``."""
    import shutil

    W, H = JPEG_SCENE_SIZE
    meta = {"w": W, "h": H, "k": [], "w2c": [], "fn": [], "cam_id": []}
    for f in range(JPEG_SCENE_FRAMES):
        ks, w2cs, fns = [], [], []
        for c in range(JPEG_SCENE_CAMS):
            cam, focal, R, eye = jpeg_scene_camera(c, f)
            w2c = np.eye(4)
            w2c[:3, :3], w2c[:3, 3] = R.T, -R.T @ eye
            fn = f"{c}/{f:06d}.jpg"
            os.makedirs(os.path.join(root, "ims", str(c)), exist_ok=True)
            shutil.copy(jpeg_frame(c, f), os.path.join(root, "ims", fn))
            ks.append([[focal, 0.0, W / 2], [0.0, focal, H / 2], [0.0, 0.0, 1.0]])
            w2cs.append(w2c.tolist())
            fns.append(fn)
        meta["k"].append(ks)
        meta["w2c"].append(w2cs)
        meta["fn"].append(fns)
        meta["cam_id"].append(list(range(JPEG_SCENE_CAMS)))
    for name in ("train_meta.json", "test_meta.json"):
        with open(os.path.join(root, name), "w") as fh:
            json.dump(meta, fh)
    pts, cols = _init_cloud()
    np.savez(os.path.join(root, "init_pt_cld.npz"),
             data=np.concatenate([pts, cols, np.ones((len(pts), 1), np.float32)], axis=1))


def write_colmap_scene(root):
    """A COLMAP scene of the committed frames: ``images/frame_c<c>_f<f>.jpg``
    and ``sparse/0`` (one PINHOLE camera, an image per frame, 500 points of
    the init cloud with one-observation tracks) by the port's writers."""
    import shutil

    from fourdgs_tpu_torch.data import colmap_io

    W, H = JPEG_SCENE_SIZE
    os.makedirs(os.path.join(root, "images"))
    images, iid = {}, 0
    for c in range(JPEG_SCENE_CAMS):
        for f in range(JPEG_SCENE_FRAMES):
            iid += 1
            name = os.path.basename(jpeg_frame(c, f))
            shutil.copy(jpeg_frame(c, f), os.path.join(root, "images", name))
            cam, focal, R, eye = jpeg_scene_camera(c, f)
            images[iid] = colmap_io.ColmapImage(
                iid, colmap_io.rotmat2qvec(R.T), -R.T @ eye, 1, name,
                np.zeros((0, 2)), np.zeros(0, np.int64))
    pts, cols = _init_cloud()
    points = {i + 1: colmap_io.ColmapPoint3D(
        i + 1, pts[i].astype(np.float64), (cols[i] * 255).astype(np.uint8), 0.5,
        np.array([1], np.int32), np.array([0], np.int32)) for i in range(500)}
    cams = {1: colmap_io.ColmapCamera(1, "PINHOLE", W, H,
                                      np.array([focal, focal, W / 2, H / 2]))}
    colmap_io.write_model(cams, images, points, os.path.join(root, "sparse", "0"))


RESAMPLE_FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures", "resample",
                                 "pillow_resize.npz")


def check_resample_fixtures():
    """``utils/resample.py::resize`` on every committed fixture (the inputs
    and Pillow's outputs of ``tests/test_torch_resample.py::
    write_committed_fixtures``) against Pillow's output: exactly, for L, RGB
    and RGBA alike. Returns (the cases, the worst level)."""
    from fourdgs_tpu_torch.utils.resample import resize

    n, worst = 0, 0
    with np.load(RESAMPLE_FIXTURES) as z:
        for key in z.files:
            if not key.startswith("out__"):
                continue
            _, case, flt = key.split("__")
            want = z[key]
            got = resize(z[f"in__{case}"], (want.shape[1], want.shape[0]), flt)
            d = int(np.abs(got.astype(int) - want.astype(int)).max()) if got.size else 0
            if got.shape != want.shape or d:
                raise AssertionError(f"resize {case} {flt}: {got.shape} against Pillow's "
                                     f"{want.shape}, {d} levels apart")
            n, worst = n + 1, max(worst, d)
    return n, worst


def check_jpeg_frames(frames, want, where):
    """Each decoded frame (name → uint8 [H, W, 3], or [H, W] grey) against
    Pillow's decode of its source (grey replicated for an RGB frame), to
    :data:`JPEG_MAX_LEVELS` / :data:`JPEG_MEAN_LEVELS`; returns the worst
    level and the share of exact values."""
    worst, exact, n = 0, 0, 0
    for name, got in frames.items():
        ref = want[name]
        if ref.ndim == 2 and got.ndim == 3:
            ref = np.repeat(ref[:, :, None], 3, axis=2)
        d = np.abs(got.astype(int) - ref.astype(int))
        if d.max() > JPEG_MAX_LEVELS or d.mean() > JPEG_MEAN_LEVELS:
            raise AssertionError(f"{where}: {name} differs from Pillow's decode by max "
                                 f"{d.max()}, mean {d.mean():.4f} levels")
        worst, exact, n = max(worst, int(d.max())), exact + int((d == 0).sum()), n + d.size
    return worst, exact / max(n, 1)


def check_jpeg_path(dev, schedule=MULTIPLEVIEW_SCHEDULE, preset=MULTIPLEVIEW_PRESET):
    """Phase 12 (b) (module docstring): the committed JPEGs against Pillow's
    decodes, then the MultipleView scene through the CLI chain and the
    Panoptic and COLMAP scenes through ``load_scene``. Returns the
    launches."""
    from fourdgs_tpu_torch.configs.core import load_config
    from fourdgs_tpu_torch.data.scene import load_scene
    from fourdgs_tpu_torch.utils.jpeg import read_jpeg

    print("    (b) the JPEG decoder on the committed fixtures, then the MultipleView, "
          "Panoptic and COLMAP loaders on the twelve committed frames", flush=True)
    with np.load(os.path.join(JPEG_FIXTURES, "pillow_decode.npz")) as z:
        want = {k: z[k] for k in z.files}
    got = {name: read_jpeg(os.path.join(JPEG_FIXTURES, name + ".jpg")) for name in want}
    for name, g in got.items():
        if g.shape != want[name].shape:
            raise AssertionError(f"{name}: shape {g.shape}, Pillow's {want[name].shape}")
    worst, exact = check_jpeg_frames(got, want, "read_jpeg")
    frames = [jpeg_frame(c, f) for c in range(JPEG_SCENE_CAMS)
              for f in range(JPEG_SCENE_FRAMES)]
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        for p in frames:
            read_jpeg(p)
    ms = 1e3 * (time.perf_counter() - t0) / (reps * len(frames))
    print(f"    read_jpeg: {len(want)} committed fixtures against Pillow's decodes: max "
          f"{worst} levels, {exact:.6f} of the values exact; {ms:.4f} ms per "
          f"{JPEG_SCENE_SIZE[0]}x{JPEG_SCENE_SIZE[1]} frame (host)")

    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_multipleview_") as tmp:
        data_dir, model_path = os.path.join(tmp, "data"), os.path.join(tmp, "model")
        write_multipleview_scene(data_dir)
        cli = run_cli_chain(data_dir, model_path, dev, schedule, preset)
        with open(os.path.join(model_path, "training_logs.json")) as f:
            logged = [r["loss"] for r in json.load(f)]
    pf = cli["prefetch"]
    renders = cli["steps"] * cli["batch_size"]
    on_card = int(dev.type == "cuda")
    (k1_train, k2_train), (k1_render, _) = cli["train_launches"], cli["render_launches"]
    print(f"    MultipleView ({JPEG_SCENE_CAMS} cams x {JPEG_SCENE_FRAMES} JPEG frames, "
          f"multipleview preset): train wall {cli['train_s']:.3f} s ({cli['steps']} steps, "
          f"{cli['points']} points, losses {logged[0]:.5f} -> {logged[-1]:.5f}), "
          f"render FPS {cli['fps']:.3f}, held-out PSNR {cli['psnr']:.4f} dB (blank "
          f"{cli['blank_psnr']:.4f}); renders vs in-process render: max "
          f"{cli['render_max_level_diff']} levels; prefetcher {json.dumps(pf)}; K1/K2 "
          f"launches train {cli['train_launches']}, render {cli['render_launches']}")
    if not all(math.isfinite(x) for x in logged):
        raise AssertionError(f"a logged loss is not finite: {logged}")
    if pf["submitted"] != renders or pf["to_ref"] != renders or pf["native"]:
        raise AssertionError(f"the prefetcher's counts {pf}: every JPEG frame goes to the "
                             f"ref ({renders})")
    if ((k2_train, k1_train) != (on_card * renders, on_card * (renders + cli["eval_renders"]))
            or k1_render != on_card * (cli["test_views"] + 1)):
        raise AssertionError(f"CLI launches: train {cli['train_launches']}, render "
                             f"{cli['render_launches']}")

    by_frame = {f"frame_c{c}_f{f}": (c, f) for c in range(JPEG_SCENE_CAMS)
                for f in range(JPEG_SCENE_FRAMES)}
    for kind, writer in (("PanopticSports", write_panoptic_scene),
                         ("colmap", write_colmap_scene)):
        with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_jpeg_scene_") as tmp:
            writer(tmp)
            t0 = time.perf_counter()
            data = load_scene(load_config(), tmp)
            load_s = time.perf_counter() - t0
            lcs = data.train_cameras + data.test_cameras
            loaded = {}
            for lc in lcs:
                base = os.path.basename(lc.image.path)[:-4]
                name = (base if kind == "colmap" else   # Panoptic: ims/<c>/<f>.jpg
                        f"frame_c{os.path.basename(os.path.dirname(lc.image.path))}"
                        f"_f{int(base)}")
                loaded[name] = lc.image()
                c, f = by_frame[name]
                t = (f / JPEG_SCENE_FRAMES if kind == "PanopticSports"
                     else (c * JPEG_SCENE_FRAMES + f) / len(by_frame))
                if lc.camera.time != t:
                    raise AssertionError(f"{kind}: {name} at time {lc.camera.time}, not {t}")
            k_worst, _ = check_jpeg_frames(loaded, want, kind)
        n_train, n_test = len(data.train_cameras), len(data.test_cameras)
        print(f"    {kind}: load_scene {load_s:.4f} s, {n_train} train + {n_test} test "
              f"cameras, times {sorted({lc.camera.time for lc in lcs})}, every frame "
              f"within {k_worst} levels of Pillow's decode")
        expect = ((12, 12) if kind == "PanopticSports" else (10, 2))
        if (n_train, n_test) != expect or len(loaded) != 12 or data.dataset_type != kind:
            raise AssertionError(f"{kind}: {n_train} train, {n_test} test cameras, "
                                 f"{len(loaded)} frames")
    return {"cli": (k1_train + k1_render, k2_train)}


# phase 13 (a): 20 + 60 steps until PR 16, cut to 10 + 30 to pay for phase 16
EVAL_TOOLS_SCHEDULE = ("opt.coarse_iterations=10", "opt.iterations=30",
                       "opt.position_lr_max_steps=30")
CAPTURE_SIZE = (2704, 2028)        # DyNeRF's capture size, resized to DYNERF_SIZE
COARSE_STEP_MS = 73.7              # phase 11 (c)'s coarse step (PERF.md §5)


def free_port() -> int:
    """A TCP port of the loopback interface that is free now."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sibr_message(cam, keep_alive: bool, train: bool = True) -> bytes:
    """The SIBR viewer's camera message for ``cam`` (a
    ``utils/graphics.py`` camera): the little-endian length, then the JSON
    whose matrices carry the viewer's handedness, so that
    ``viewer.py::NetworkGUI.receive`` rebuilds ``cam`` (it negates the view
    matrix's Y and Z columns and the view-projection's Y column)."""
    wv = np.asarray(cam.world_view, np.float32).copy()
    wv[:, 1:3] = -wv[:, 1:3]
    fp = np.asarray(cam.full_proj, np.float32).copy()
    fp[:, 1] = -fp[:, 1]
    body = json.dumps({
        "resolution_x": int(cam.width), "resolution_y": int(cam.height),
        "fov_x": 2 * math.atan(float(cam.tanfovx)), "fov_y": 2 * math.atan(float(cam.tanfovy)),
        "z_near": 0.01, "z_far": 100.0, "view_matrix": wv.reshape(-1).tolist(),
        "view_projection_matrix": fp.reshape(-1).tolist(), "train": train,
        "keep_alive": keep_alive, "scaling_modifier": 1.0, "time": float(cam.time),
    }).encode()
    return len(body).to_bytes(4, "little") + body


def sibr_client(port: int, cams, result: dict, timeout: float = 300.0) -> None:
    """A viewer as SIBR connects: to 127.0.0.1:``port`` (retried until the
    listener is up), then one message per camera of ``cams`` (a
    ``(camera, keep_alive)`` list), each answered by W·H·3 bytes and a
    length-prefixed verify string. Fills ``result`` with ``frames`` (uint8
    [H, W, 3]) and ``verify``, or ``error``; a thread's target."""
    import socket

    result.update(frames=[], verify=[])
    deadline = time.monotonic() + timeout
    try:
        while True:
            try:
                conn = socket.create_connection(("127.0.0.1", port), timeout=timeout)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.01)
        with conn:
            def recv(n):
                buf = b""
                while len(buf) < n:
                    chunk = conn.recv(n - len(buf))
                    if not chunk:
                        raise ConnectionError("the trainer closed the connection")
                    buf += chunk
                return buf

            for cam, keep_alive in cams:
                conn.sendall(sibr_message(cam, keep_alive))
                img = recv(cam.width * cam.height * 3)
                n = int.from_bytes(recv(4), "little")
                result["frames"].append(np.frombuffer(img, np.uint8).reshape(
                    cam.height, cam.width, 3))
                result["verify"].append(recv(n).decode("ascii"))
    except Exception as e:    # reported to the caller, which raises
        result["error"] = repr(e)


def write_capture_scene(root, dev, capture=CAPTURE_SIZE, n_cams=2, n_frames=3):
    """A DyNeRF scene of ``n_cams`` cameras × ``n_frames`` frames written at
    the capture size (:func:`write_dynerf_scene`), so that every frame is
    resized when it is read."""
    return write_dynerf_scene(root, dev, n_frames=n_frames, size=capture, n_cams=n_cams,
                              budget=1 << 20)


def check_eval_tools(dev, data_dir, schedule=EVAL_TOOLS_SCHEDULE, preset=None,
                     lpips_size=WIDTH, capture=CAPTURE_SIZE, run_script=None):
    """Phase 13 (module docstring) on phase 10 (b)'s scene at ``data_dir``.
    ``run_script(cmd, **kw)`` runs ``full_eval_torch.py``'s command lines
    in (d) (default ``subprocess.run``; the CPU rehearsal runs them in its
    process, where its frame sizes are set). Returns the K1/K2 launches of
    (a) and (c) and the numbers printed."""
    import shutil
    import subprocess
    import threading

    import torch

    import export_perframe_3DGS_torch as EX
    import full_eval_torch
    import merge_many_4dgs_torch as MG
    from fourdgs_tpu_torch.configs.core import load_config
    from fourdgs_tpu_torch.data import ply as ply_lib
    from fourdgs_tpu_torch.data import scene as tscene
    from fourdgs_tpu_torch.data.fastloader import PrefetchPool
    from fourdgs_tpu_torch.data.scene import load_scene
    from fourdgs_tpu_torch.ops import blend
    from fourdgs_tpu_torch.ops.rasterize import rasterize_pallas
    from fourdgs_tpu_torch.render import CameraArrays
    from fourdgs_tpu_torch.utils import lpips, png
    from fourdgs_tpu_torch.utils.gradient_tracker import GROUPS
    from fourdgs_tpu_torch.utils.resample import resize

    on_card = dev.type == "cuda"
    out = {}
    tmp = tempfile.mkdtemp(dir=ROOT, prefix=".smoke_tools_")
    try:
        # (a) the viewer and the gradient tracker
        t_part = time.perf_counter()
        model_path = os.path.join(tmp, "model")
        test_cam = load_scene(load_config(), data_dir).test_cameras[0].camera
        port = free_port()
        client = {}
        thread = threading.Thread(target=sibr_client, args=(
            port, [(test_cam, True), (test_cam, False)], client), daemon=True)
        print(f"[13] eval and tools: (a) train_torch.py --port {port} --gradient_tracking",
              flush=True)
        thread.start()
        cli = run_cli_chain(data_dir, model_path, dev, schedule, preset,
                            extra_args=("--port", str(port), "--gradient_tracking"))
        thread.join(timeout=60)
        if thread.is_alive() or "error" in client or len(client["frames"]) != 2:
            raise AssertionError(f"the viewer client got {len(client.get('frames', []))} "
                                 f"frames: {client.get('error')}")
        shape = (test_cam.height, test_cam.width, 3)
        for f in client["frames"]:
            if f.shape != shape or f.min() == f.max():
                raise AssertionError(f"a served frame is {f.shape}, levels "
                                     f"{f.min()}..{f.max()}")
        if client["verify"] != [data_dir] * 2:
            raise AssertionError(f"verify strings {client['verify']}, not the source path")
        with open(os.path.join(model_path, "gradient_report.json")) as f:
            report = json.load(f)
        n_coarse = int(next(o.split("=")[1] for o in schedule
                            if o.startswith("opt.coarse_iterations=")))
        n_fine = cli["steps"] - n_coarse
        want_iters = list(range(10, n_coarse + 1, 10)) + list(range(10, n_fine + 1, 10))
        groups = {k.split("/")[0] for k in report["history"]}
        if (report["iterations"] != want_iters or groups != set(GROUPS)
                or not all(len(v) == len(want_iters) and all(map(math.isfinite, v))
                           for v in report["history"].values())):
            raise AssertionError(f"gradient report: iterations {report['iterations']}, "
                                 f"groups {sorted(groups)}")
        with open(os.path.join(model_path, "gradient_timeline.json")) as f:
            timeline = json.load(f)
        if len(timeline) != 10 or not all(math.isfinite(r["loss"]) and
                                          math.isfinite(r["grad_norm_max"]) for r in timeline):
            raise AssertionError(f"gradient timeline: {timeline}")
        k1, k2 = cli["train_launches"]
        want = ((cli["steps"] + cli["eval_renders"] + 2 + 10, cli["steps"] + 10)
                if on_card else (0, 0))
        if (k1, k2) != want:
            raise AssertionError(f"train_torch.py --port --gradient_tracking launched "
                                 f"K1/K2 {(k1, k2)}, expected {want}")
        plots = {name: os.path.exists(os.path.join(model_path, name))
                 for name in ("gradient_curves.png", "gradient_timeline.png")}
        out["a"] = {"launches": (k1, k2), "train_s": cli["train_s"], "steps": cli["steps"],
                    "records": len(want_iters), "plots": plots}
        print(f"    {cli['steps']} steps in {cli['train_s']:.3f} s with 2 served "
              f"{shape[1]}x{shape[0]} frames (verify = source path), "
              f"{len(want_iters)} gradient records of {len(groups)} groups, a 10-point "
              f"timeline (losses {timeline[0]['loss']:.5f}..{timeline[-1]['loss']:.5f}); "
              f"K1/K2 launches {(k1, k2)} = {cli['steps']} steps + {cli['eval_renders']} "
              f"eval views + 2 frames + 10 timeline renders, {cli['steps']} + 10 passes; "
              f"plots " + ", ".join(f"{n} {'written' if w else 'skipped (no matplotlib)'}"
                                    for n, w in plots.items()))

        out["a"]["seconds_all"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        # (b) export
        t0 = time.perf_counter()
        paths = EX.main(["--model_path", model_path, "--device", dev.type])
        export_s = time.perf_counter() - t0
        cfg, state = MG.load_model(model_path, -1, None, dev)
        times = [lc.camera.time for lc in load_scene(cfg, data_dir).test_cameras]
        if len(paths) != len(times) or times[0] != 0.0:
            raise AssertionError(f"{len(paths)} PLYs for {len(times)} test cameras")
        back = ply_lib.load_gaussian_ply(paths[0])
        xyz, scales, rot, opacity, shs = EX.get_state_at_time(state.params, state, 0.0)
        alive = state.alive
        n = int(alive.sum())
        want_t0 = {"xyz": xyz, "scaling": scales, "rotation": rot, "opacity": opacity,
                   "f_dc": shs[:, 0, :], "f_rest": shs[:, 1:, :].reshape(shs.shape[0], -1)}
        err = max(float(np.abs(back[k] - v[alive].cpu().numpy()).max())
                  for k, v in want_t0.items())
        if back["xyz"].shape[0] != n or not err <= 1e-6:
            raise AssertionError(f"time 0's PLY differs from get_state_at_time by {err}")
        out["b"] = {"plys": len(paths), "seconds": export_s, "max_abs_err": err}
        print(f"    (b) export_perframe_3DGS_torch.py: {len(paths)} PLYs of {n} Gaussians "
              f"in {export_s:.3f} s; time 0's read back against get_state_at_time: "
              f"max |diff| {err:.3g}", flush=True)

        out["b"]["seconds_all"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        # (c) merge the model with itself, moved
        merged_dir = os.path.join(tmp, "merged")
        bias = dict(motion=[(0.5, 0.0, 0.0)], rot=[("90", "0")], scl=[0.8])
        blend.blend_forward.launches = blend.blend_backward.launches = 0
        res = MG.main(["--model_paths", model_path, model_path, "-s", data_dir,
                       "--rotation_bias", "90,0", "--motion_bias", "0.5,0,0",
                       "--scale_bias", "0.8", "--output", merged_dir, "--device", dev.type])
        merge_launches = (blend.blend_forward.launches, blend.blend_backward.launches)
        video = load_scene(cfg, data_dir).video_cameras
        if res["frames"] != len(video) or len(os.listdir(merged_dir)) != len(video):
            raise AssertionError(f"{len(os.listdir(merged_dir))} merged frames for "
                                 f"{len(video)} video cameras")
        if merge_launches != ((len(video), 0) if on_card else (0, 0)):
            raise AssertionError(f"the merge launched K1/K2 {merge_launches} times "
                                 f"for {len(video)} frames")
        models = [(cfg, state)] * 2
        xyz_m, sc_m, rot_m, op_m, shs_m, deg = MG.merged_gaussians(
            models, video[0].time, bias["motion"], bias["rot"], bias["scl"])
        ca = CameraArrays.from_camera(video[0], device=dev)
        bg = torch.ones(3, device=dev) if cfg.model.white_background else torch.zeros(3, device=dev)
        with torch.no_grad():
            ref = rasterize_pallas(xyz_m, sc_m, rot_m, op_m, shs_m, ca.camera_center,
                                   ca.world_view, ca.full_proj, ca.tanfovx, ca.tanfovy,
                                   video[0].width, video[0].height, deg, bg,
                                   instance_budget=MG.INSTANCE_BUDGET)
        want8 = (np.clip(ref.color.cpu().numpy(), 0, 1).transpose(1, 2, 0) * 255
                 ).astype(np.uint8)
        got8 = png.read_png(os.path.join(merged_dir, "00000.png"))
        merge_diff = int(np.abs(got8.astype(int) - want8.astype(int)).max())
        if merge_diff > 1 or xyz_m.shape[0] != 2 * n:
            raise AssertionError(f"merged frame 0 differs from the in-process render by "
                                 f"{merge_diff} levels ({xyz_m.shape[0]} Gaussians)")
        fps = res["frames"] / res["seconds"]
        out["c"] = {"launches": merge_launches, "frames": res["frames"], "fps": fps,
                    "max_level_diff": merge_diff}
        print(f"    (c) merge_many_4dgs_torch.py (the model twice, the second turned "
              f"90 degrees, moved 0.5 and scaled 0.8): {res['frames']} frames of "
              f"{2 * n} Gaussians in {res['seconds']:.3f} s = {fps:.3f} frames/s with "
              f"the PNG writes; K1/K2 launches {merge_launches}; frame 0 against the "
              f"in-process K1 render: max {merge_diff} levels", flush=True)

        out["c"]["seconds_all"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        # (d) full_eval over the model, where the script looks for it
        cwd = os.path.join(tmp, "full_eval")
        scene = os.path.basename(data_dir)
        shutil.copytree(model_path, os.path.join(cwd, "output", "dnerf", scene),
                        ignore=shutil.ignore_patterns("test", "train", "video"))
        real_run, commands = subprocess.run, []

        def run(cmd, **kw):
            commands.append(list(cmd))
            return (run_script or real_run)(cmd, **kw)

        here = os.getcwd()
        t0 = time.perf_counter()
        try:
            os.chdir(cwd)
            subprocess.run = run
            full_eval_torch.main(["--base_dir", os.path.dirname(data_dir), "--family",
                                  "dnerf", "--scenes", scene, "--skip_train",
                                  "--device", dev.type])
        finally:
            subprocess.run = real_run
            os.chdir(here)
        full_s = time.perf_counter() - t0
        scripts = [os.path.basename(c[1]) for c in commands]
        results = os.path.join(cwd, "output", "dnerf", scene, "results.json")
        if (scripts != ["render_torch.py", "metrics_torch.py"]
                or any(c[-2:] != ["--device", dev.type] for c in commands)
                or not os.path.exists(results)):
            raise AssertionError(f"full_eval_torch.py ran {commands}; results.json "
                                 f"{'exists' if os.path.exists(results) else 'missing'}")
        with open(results) as f:
            full_psnr = next(iter(json.load(f).values()))["PSNR"]
        out["d"] = {"seconds": full_s, "psnr": full_psnr}
        print(f"    (d) full_eval_torch.py --skip_train: render_torch.py and "
              f"metrics_torch.py {'in this process' if run_script else 'as subprocesses'} "
              f"on {dev.type} in {full_s:.3f} s; "
              f"results.json PSNR {full_psnr:.4f} dB", flush=True)

        out["d"]["seconds_all"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        # (e) LPIPS trunks, on the card against the CPU
        base = os.path.join(model_path, "test", f"ours_{cli['steps'] - n_coarse}")
        r, g = (torch.tensor(png.read_png(os.path.join(base, d, "00000.png"))[
            :lpips_size, :lpips_size], dtype=torch.float32).permute(2, 0, 1) / 255.0
            for d in ("renders", "gt"))
        cpu = torch.device("cpu")
        lp = {}
        for net in ("vgg", "alex"):
            w = lpips.random_weights(net, seed=0)
            fn_dev, fn_cpu = lpips.make_lpips(w, net, dev), lpips.make_lpips(w, net, cpu)
            d_dev = float(fn_dev(r.to(dev), g.to(dev)))
            d_cpu = float(fn_cpu(r, g))
            if not abs(d_dev - d_cpu) <= 1e-5:
                raise AssertionError(f"LPIPS-{net} on {dev.type} {d_dev} against the "
                                     f"CPU's {d_cpu}")
            if on_card:
                from fourdgs_tpu_torch.scripts import time_ms
                ms = time_ms(lambda: fn_dev(r.to(dev), g.to(dev)), dev, iters=3, reps=3)[0]
            else:
                ms = None
            lp[net] = {"value": d_dev, "cpu": d_cpu, "diff": abs(d_dev - d_cpu), "ms": ms}
        found = {net: lpips.load_weights(net) is not None for net in ("vgg", "alex")}
        null = [f"LPIPS-{n}" for n, f in found.items() if not f]
        out["e"] = {"nets": lp, "pretrained": found}
        print(f"    (e) LPIPS, random weights, {r.shape[2]}x{r.shape[1]} pair: " + "; ".join(
            f"{n} {v['value']:.6f} (CPU {v['cpu']:.6f}, |diff| {v['diff']:.2e}"
            + (f", {v['ms']:.3f} ms a pair" if v["ms"] is not None else "") + ")"
            for n, v in lp.items()) + f"; pretrained weights found: {found}; "
            f"null columns: {null or 'none'}", flush=True)

        out["e"]["seconds_all"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        # (f) the resample
        n_fix, worst = check_resample_fixtures()
        rng = np.random.default_rng(0)
        y, x = np.mgrid[0:capture[1], 0:capture[0]]
        frame = np.clip(np.stack([128 + 100 * np.sin(x / (9.0 + k)) * np.cos(y / 7.0)
                                  for k in range(3)], -1)
                        + rng.normal(0, 10, (capture[1], capture[0], 3)), 0, 255
                        ).astype(np.uint8)
        target = tscene.DYNERF_SIZE
        resize(frame, target, "lanczos")          # the first call builds the library
        t_rs = []
        for _ in range(5):
            t0 = time.perf_counter()
            resize(frame, target, "lanczos")
            t_rs.append(1e3 * (time.perf_counter() - t0))
        cap_dir = os.path.join(tmp, "capture")
        t0 = time.perf_counter()
        write_capture_scene(cap_dir, dev, capture)
        write_s = time.perf_counter() - t0
        data = load_scene(load_config(), cap_dir)
        refs = [lc.image for lc in data.train_cameras + data.test_cameras]
        pool = PrefetchPool(n_threads=8)
        try:
            t0 = time.perf_counter()
            pool.submit_batch(refs)
            frames = pool.wait_batch()
            read_ms = 1e3 * (time.perf_counter() - t0) / len(refs)
            counts = pool.counts()
        finally:
            pool.close()
        if counts != {"submitted": len(refs), "native": 0, "to_ref": len(refs)}:
            raise AssertionError(f"prefetcher counts {counts} for {len(refs)} frames at "
                                 f"{capture}")
        t0 = time.perf_counter()
        decoded = [png.convert(png.read_png(ref.path), "RGB") for ref in refs]
        decode_ms = 1e3 * (time.perf_counter() - t0) / len(refs)
        for ref, got, dec in zip(refs, frames, decoded):
            want = resize(dec, target, "lanczos")
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"{ref.path}: the loaded frame is not resize of its "
                                     f"decode")
        out["f"] = {"fixtures": n_fix, "worst": worst, "resize_ms": min(t_rs),
                    "resize_ms_mean": float(np.mean(t_rs)), "read_ms": read_ms,
                    "decode_ms": decode_ms, "frames": len(refs)}
        print(f"    (f) resample: {n_fix} committed fixtures equal Pillow's outputs "
              f"(worst {worst} levels); one {capture[0]}x{capture[1]} -> "
              f"{target[0]}x{target[1]} LANCZOS frame on the host {min(t_rs):.2f} ms "
              f"(mean of 5 {np.mean(t_rs):.2f} ms; the coarse step {COARSE_STEP_MS} ms); "
              f"a {len(refs)}-frame DyNeRF scene at the capture size (written in "
              f"{write_s:.1f} s): every frame sent to the ref ({counts}), equal to resize "
              f"of its decode, {read_ms:.2f} ms a frame decoded and resized on the "
              f"training thread (the port's PNG codec alone {decode_ms:.2f} ms a frame)",
              flush=True)
        out["f"]["seconds_all"] = time.perf_counter() - t_part
        print("    phase 13 seconds: " + ", ".join(
            f"({k}) {v['seconds_all']:.1f}" for k, v in out.items()), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


ORACLE_FRAMES = 2                  # phase 14 (c)'s oracle frames, train split


def t_stop_riders(t_a, t_b, ulps=8):
    """Pixels whose final transmittance lies within ``ulps`` float32 ulps of
    T_STOP in either of two renders ([..., 256] T blocks): those whose walk
    may take or lose one instance under another association (the contract
    of ``tests/test_pallas_raster.py:14-21``)."""
    from fourdgs_tpu_torch.ops import constants as C

    tol = ulps * float(np.spacing(np.float32(C.T_STOP)))
    return ((t_a - C.T_STOP).abs() <= tol) | ((t_b - C.T_STOP).abs() <= tol)


def check_cull_on_card(cfg, state, cam, gt, dev):
    """Phase 14 (a): the lego view with ``tpu.ellipse_tile_cull`` off and
    on. The render through ``render`` both ways (launches, ``num_rendered``,
    device and wall ms a view); K1's output and K2's per-Gaussian payload
    gradients (after the segment sum, under the step's L1 cotangent against
    ``gt``) with the cull against without it: equal to 1e-6 apart from the
    pixels that ride T_STOP (:func:`t_stop_riders`, counted, with the pixels
    equal bit for bit); K1 and K2 at the culled shapes against their plain
    versions, with times and bounds."""
    import copy

    import torch

    from fourdgs_tpu_torch import render as TR
    from fourdgs_tpu_torch.ops import blend
    from fourdgs_tpu_torch.ops import rasterize as R
    from fourdgs_tpu_torch.scripts import time_ms
    from fourdgs_tpu_torch.utils.losses import abs_

    cfg_on = copy.deepcopy(cfg)
    cfg_on.tpu.ellipse_tile_cull = True
    bg = torch.ones(3, device=dev)
    res = {}
    for name, c in (("off", cfg), ("on", cfg_on)):
        def view(c=c):
            return TR.render(state.params, state, cam, c, WIDTH, HEIGHT, "fine", bg,
                             c.model.sh_degree, device=dev)
        blend.blend_forward.launches = 0
        out = view()
        torch.cuda.synchronize()
        launches = blend.blend_forward.launches
        dev_ms, wall_ms = time_ms(view, dev, iters=5, reps=3)
        res[name] = {"num_rendered": int(out.num_rendered), "launches": launches,
                     "view_ms": dev_ms, "view_wall_ms": wall_ms}
        if launches != int(dev.type == "cuda"):     # the plain path launches nothing
            raise AssertionError(f"cull {name}: K1 launched {launches} times for a view")
    if not res["on"]["num_rendered"] < res["off"]["num_rendered"]:
        raise AssertionError(f"the cull did not lower the demand: {res}")

    xyz, sc, rot, op, shs, _ = TR.activated_gaussians(state.params, state, cam, "fine")
    P = xyz.shape[0]
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0], device=dev)[:, None]
    per = {}
    for name in ("off", "on"):
        bi = R.blend_inputs(xyz, sc, rot, op, shs, cam.camera_center, cam.world_view,
                            cam.full_proj, cam.tanfovx, cam.tanfovy, WIDTH, HEIGHT,
                            cfg.model.sh_degree, cfg.tpu.instance_budget, alive=state.alive,
                            ellipse_tile_cull=name == "on")
        fwd = (bi.feat, bi.bins.tile_start, bi.bins.tile_stop, bi.row_off, bg, bi.grid_x)
        per[name] = {"bi": bi, "fwd": fwd, "out5": blend.blend_forward(*fwd)}
    with torch.enable_grad():      # the step's L1 cotangent, from the render without the cull
        o = per["off"]["out5"].clone().requires_grad_()
        (g_out,) = torch.autograd.grad(
            abs_((o - gt[0]) * mask).sum() / (3 * WIDTH * HEIGHT), o)
    for name, p in per.items():
        p["bwd"] = (*p["fwd"][:5], p["out5"], g_out, p["fwd"][5])
        p["d_table"] = R.payload_grad(blend.blend_backward(*p["bwd"]), p["bi"].bins, P)
    off5, on5 = per["off"]["out5"], per["on"]["out5"]
    err = (on5 - off5)[:, [0, 1, 2, 4]].abs().amax(dim=1)              # [T, 256]
    riders = t_stop_riders(off5[:, 4], on5[:, 4])
    g_off, g_on = per["off"]["d_table"], per["on"]["d_table"]
    g_err = (g_on - g_off).abs()
    g_scale = float(g_off.abs().max())
    res["image"] = {"pixels": err.numel(), "bit_equal": int((err == 0).sum()),
                    "ride_t_stop": int(riders.sum()),
                    "over_1e-6": int((err > 1e-6).sum()),
                    "over_1e-6_not_riding": int(((err > 1e-6) & ~riders).sum()),
                    "max_abs_err": float(err.max())}
    res["payload_grad"] = {"gaussians": P,
                           "bit_equal": int((g_err == 0).all(dim=1).sum()),
                           "over_1e-6": int((g_err > 1e-6).any(dim=1).sum()),
                           "max_abs_err": float(g_err.max()), "max_abs_grad": g_scale,
                           "max_err_over_scale": float(g_err.max()) / max(g_scale, 1e-30)}
    if res["image"]["over_1e-6_not_riding"] or not bool(torch.isfinite(on5).all()):
        raise AssertionError(f"the cull changed pixels that do not ride T_STOP: {res['image']}")
    if not res["payload_grad"]["max_err_over_scale"] <= 1e-2:
        raise AssertionError(f"the cull changed the payload gradients: {res['payload_grad']}")

    # K1 and K2 at the culled shapes: against their plain versions, times, bounds
    on = per["on"]
    n_tiles = on["bi"].bins.tile_start.numel()
    k_pad = on["bi"].feat.shape[1]
    res["k1"] = compare_blend(on5, blend.blend_forward_plain(*on["fwd"]))
    res["k2"] = compare_blend_backward(blend.blend_backward(*on["bwd"]),
                                       blend.blend_backward_plain(*on["bwd"]),
                                       int((on["fwd"][2].long() - on["fwd"][1].long())
                                           .clamp(min=0).sum()))
    check_cull_exact(blend.blend_forward, *on["fwd"])
    check_cull_exact(blend.blend_backward, *on["bwd"])
    for name, p in per.items():
        work = blend_work(*p["fwd"][:4], p["fwd"][5])
        p["timing"] = {
            "k1_ms": time_ms(lambda: blend.blend_forward(*p["fwd"]), dev)[0],
            "k2_ms": time_ms(lambda: blend.blend_backward(*p["bwd"]), dev)[0],
            "k1_bound": blend_bound(work, n_tiles),
            "k2_bound": blend_backward_bound(work, n_tiles, k_pad),
            "work": work}
    res["k1_plain_ms"] = time_ms(lambda: blend.blend_forward_plain(*on["fwd"]), dev,
                                 iters=1, reps=3)[0]
    res["k2_plain_ms"] = time_ms(lambda: blend.blend_backward_plain(*on["bwd"]), dev,
                                 iters=1, reps=3)[0]
    res["timing"] = {k: {kk: v for kk, v in p["timing"].items() if kk != "work"}
                     for k, p in per.items()}
    res["work"] = {k: p["timing"]["work"] for k, p in per.items()}
    return res


def check_dssim_step(gt, step_ms, dev):
    """Phase 14 (b): the lego train step of phase 6 with
    ``opt.lambda_dssim = 0.2`` (``ssim_tiles`` on the packed render), 3
    warm-up and 20 timed steps: one K1 and one K2 launch a step, a finite
    falling loss above the L1; ``ssim_tiles`` on the card against the
    image-space ``ssim`` on the card and against the float64 SSIM on the
    CPU, on the last step's render."""
    import torch

    from fourdgs_tpu_torch import render as TR
    from fourdgs_tpu_torch.configs.core import load_config
    from fourdgs_tpu_torch.ops import blend
    from fourdgs_tpu_torch.ops.rasterize import untile
    from fourdgs_tpu_torch.train import adam
    from fourdgs_tpu_torch.train.loop import make_train_step
    from fourdgs_tpu_torch.utils import losses

    cfg = load_config(LEGO)
    cfg.tpu.capacity = CAPACITY
    cfg.opt.lambda_dssim = 0.2
    state = bench_scene(cfg, seed=0, device=dev)
    cam = TR.CameraArrays.from_camera(ring_camera(0, N_TIMED), device=dev)
    cams = TR.CameraArrays(*(x[None] for x in cam))
    step_fn = make_train_step(cfg, WIDTH, HEIGHT, "fine", cfg.model.sh_degree, device=dev)
    params, opt = state.params, adam.init(state.params)
    metrics = []
    blend.blend_forward.launches = blend.blend_backward.launches = 0
    with torch.enable_grad():
        for it in range(1, N_WARM + N_TIMED + 1):
            if it == N_WARM + 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            params, opt, state, m = step_fn(params, opt, state, cams, gt, it)
            metrics.append(m)
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    n = N_WARM + N_TIMED
    launches = (blend.blend_forward.launches, blend.blend_backward.launches)
    loss = [float(m["loss"]) for m in metrics]
    l1 = [float(m["l1"]) for m in metrics]
    res = {"steps": n, "launches": launches, "ms_per_step": elapsed * 1e3 / N_TIMED,
           "ms_per_step_without": step_ms, "loss": (loss[0], loss[-1]), "l1": (l1[0], l1[-1]),
           "dssim_term_last": loss[-1] - l1[-1]}
    if launches != (n, n) and dev.type == "cuda":
        raise AssertionError(f"expected one K1 and one K2 launch a step: {launches}")
    if not all(math.isfinite(x) for x in loss) or not loss[-1] < loss[0]:
        raise AssertionError(f"loss not finite or not falling: {loss}")
    if not all(a > b for a, b in zip(loss, l1)):
        raise AssertionError("the loss is not above the L1: the D-SSIM term is not live")

    out = TR.render(params, state, cam, cfg, WIDTH, HEIGHT, "fine", torch.ones(3, device=dev),
                    cfg.model.sh_degree, device=dev, tile_space=True).color
    gx, gy = -(-WIDTH // 16), -(-HEIGHT // 16)
    s_tiles = float(losses.ssim_tiles(out[None, :, 0:3], gt[:, :, 0:3], gx, gy))
    img, gt_img = (untile(x[:, 0:3], gx, gy, WIDTH, HEIGHT) for x in (out, gt[0]))
    s_image = float(losses.ssim(img, gt_img))
    s_f64 = float(losses.ssim(img.double().cpu(), gt_img.double().cpu()))
    res["ssim"] = {"tiles": s_tiles, "image": s_image, "cpu_float64": s_f64,
                   "tiles_minus_image": s_tiles - s_image, "tiles_minus_f64": s_tiles - s_f64,
                   "image_minus_f64": s_image - s_f64}
    if not abs(s_tiles - s_f64) <= 1e-5:
        raise AssertionError(f"ssim_tiles on the card is off the float64 SSIM: {res['ssim']}")
    return res


def check_backends(cfg, state, cam, dev):
    """Phase 14 (c): the ``tile`` backend at the lego view against K1's
    render under the association contract, and the ``reference`` backend
    (``scripts/render_oracle_gt.py``'s oracle) on the first
    :data:`ORACLE_FRAMES` frames of the committed oracle split, as uint8
    against ``gt_cache/oracle_gt_800_100_10.npz``; each one's ms a view."""
    import copy

    import torch

    from fourdgs_tpu_torch import render as TR
    from fourdgs_tpu_torch.ops import blend
    from fourdgs_tpu_torch.scripts import render_oracle_gt as ROG
    from fourdgs_tpu_torch.scripts import time_ms

    bg = torch.ones(3, device=dev)
    k1 = TR.render(state.params, state, cam, cfg, WIDTH, HEIGHT, "fine", bg,
                   cfg.model.sh_degree, device=dev)
    longest = int(k1.max_tile_len)
    cfg_t = copy.deepcopy(cfg)
    # the longest list rounded up to the blend chunk, so no list is cut
    cfg_t.tpu.tile_budget = -(-longest // cfg.tpu.blend_chunk) * cfg.tpu.blend_chunk

    def tile_view():
        return TR.render(state.params, state, cam, cfg_t, WIDTH, HEIGHT, "fine", bg,
                         cfg.model.sh_degree, device=dev, backend="tile")

    blend.blend_forward.launches = 0
    tiled = tile_view()
    torch.cuda.synchronize()
    res = {"tile": {"launches_k1": blend.blend_forward.launches,
                    "tile_budget": cfg_t.tpu.tile_budget, "max_tile_len": int(tiled.max_tile_len),
                    "num_rendered": int(tiled.num_rendered),
                    "k1_num_rendered": int(k1.num_rendered)}}
    err = torch.cat([(tiled.color - k1.color).abs(), (tiled.alpha - k1.alpha).abs()]).amax(dim=0)
    n = err.numel()
    res["tile"].update({"pixels": n, "over_1e-4": int((err > 1e-4).sum()),
                        "over_1e-2": int((err > 1e-2).sum()), "max_abs_err": float(err.max()),
                        "depth_max_abs_err": float((tiled.depth - k1.depth).abs().max())})
    if (res["tile"]["launches_k1"] or res["tile"]["over_1e-2"]
            or res["tile"]["over_1e-4"] > 1e-4 * n
            or res["tile"]["max_tile_len"] > cfg_t.tpu.tile_budget):
        raise AssertionError(f"the tile backend disagrees with K1's render: {res['tile']}")
    res["tile"]["ms"], res["tile"]["wall_ms"] = time_ms(tile_view, dev, iters=1, reps=3)
    res["k1_view_ms"] = time_ms(lambda: TR.render(
        state.params, state, cam, cfg, WIDTH, HEIGHT, "fine", bg, cfg.model.sh_degree,
        device=dev), dev, iters=5, reps=3)[0]
    del tiled

    render = ROG.oracle_renderer(WIDTH, dev)
    with np.load(os.path.join(ROOT, "gt_cache", "oracle_gt_800_100_10.npz")) as f:
        n_split = f["train_meta"].shape[0]
        want, meta = f["train_imgs"][:ORACLE_FRAMES], f["train_meta"][:ORACLE_FRAMES]
    import bench_quality_torch as BQ

    r = np.random.default_rng(ROG.SPLIT_SEEDS["train"])
    frames = []
    for i in range(ORACLE_FRAMES):
        t = i / max(n_split - 1, 1)
        ang, elev = r.uniform(0, 2 * np.pi), r.uniform(*ROG.ELEVATION)
        if not np.array_equal([ang, elev, t], meta[i]):
            raise AssertionError(f"oracle frame {i}: cameras differ from the committed {meta[i]}")
        cam_i = BQ.ring_camera(ang, elev, WIDTH, WIDTH, t)
        frames.append(render(t, cam_i))
    diff = np.abs(np.stack(frames).astype(int) - want.astype(int))
    res["reference"] = {"frames": ORACLE_FRAMES, "max_level_diff": int(diff.max()),
                        "pixels_differing": int((diff.max(axis=-1) > 0).sum()),
                        "pixels": int(diff[..., 0].size),
                        "ms": time_ms(lambda: render(t, cam_i), dev, iters=1, reps=3)[0]}
    if res["reference"]["max_level_diff"] > 1:
        raise AssertionError(f"the port's oracle disagrees with the committed frames: "
                             f"{res['reference']}")
    return res


def check_options(cfg, state, cam, gt, step_ms, dev):
    """Phase 14 (module docstring): (a) :func:`check_cull_on_card`, (b)
    :func:`check_dssim_step`, (c) :func:`check_backends`; returns their
    results and the seconds of each."""
    print("[14] the remaining single-device options: (a) the ellipse cull at the "
          "lego view", flush=True)
    secs = {}
    t0 = time.perf_counter()
    a = check_cull_on_card(cfg, state, cam, gt, dev)
    secs["a"] = time.perf_counter() - t0
    print(f"    render with the cull off / on: num_rendered {a['off']['num_rendered']} / "
          f"{a['on']['num_rendered']}, K1 launches {a['off']['launches']} / "
          f"{a['on']['launches']} a view; device ms a view {a['off']['view_ms']:.4f} / "
          f"{a['on']['view_ms']:.4f}, wall {a['off']['view_wall_ms']:.4f} / "
          f"{a['on']['view_wall_ms']:.4f}")
    print(f"    K1's image on against off: {json.dumps(a['image'])}")
    print(f"    per-Gaussian payload gradients on against off: {json.dumps(a['payload_grad'])}")
    for name in ("off", "on"):
        tm = a["timing"][name]
        print(f"    cull {name}: K1 {tm['k1_ms']:.4f} ms (bound {tm['k1_bound']['bound_ms']:.4f}, "
              f"{tm['k1_bound']['bound_by']}; kept pairs "
              f"{tm['k1_bound']['bound_kept_pairs_ms']:.4f}), K2 {tm['k2_ms']:.4f} ms (bound "
              f"{tm['k2_bound']['bound_ms']:.4f}, {tm['k2_bound']['bound_by']}; kept pairs "
              f"{tm['k2_bound']['bound_kept_pairs_ms']:.4f}); {work_line(a['work'][name])}")
    print(f"    K1 / K2 at the culled shapes against their plain versions: {a['k1']}; "
          f"{a['k2']}; plain {a['k1_plain_ms']:.4f} / {a['k2_plain_ms']:.4f} ms; the "
          f"strip cull equals the walk bit for bit")
    print("    (b) the lego train step with lambda_dssim = 0.2", flush=True)
    t0 = time.perf_counter()
    b = check_dssim_step(gt, step_ms, dev)
    secs["b"] = time.perf_counter() - t0
    print(f"    {b['steps']} steps: {b['ms_per_step']:.3f} ms/step (phase 6 without D-SSIM "
          f"{b['ms_per_step_without']:.3f}); K1/K2 launches {b['launches']}; loss "
          f"{b['loss'][0]:.6f} -> {b['loss'][1]:.6f}, L1 {b['l1'][0]:.6f} -> {b['l1'][1]:.6f}")
    print(f"    SSIM of the last step's render: {json.dumps(b['ssim'])}")
    print("    (c) the tile and reference backends", flush=True)
    t0 = time.perf_counter()
    c = check_backends(cfg, state, cam, dev)
    secs["c"] = time.perf_counter() - t0
    print(f"    tile backend at the lego view against K1's render: {json.dumps(c['tile'])}; "
          f"K1's view {c['k1_view_ms']:.4f} ms")
    print(f"    reference backend on the committed oracle frames: {json.dumps(c['reference'])}")
    print("    phase 14 seconds: " + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items()))
    return {"a": a, "b": b, "c": c, "seconds": secs}


# -- phase 15: the sharded trainer ----------------------------------------------

SHARD_GRID = (2, 2)                # (data, model) of phase 15 (a)
SHARD_BATCH = 2                    # the global batch: ring cameras 0 and 1
SHARD_WARM, SHARD_TIMED = 3, 10    # (a)'s warm-up and timed steps
# (shard_preprocess, shard_primitives): (a) runs the default, (b) the others
SHARD_MODES = {"pre": (True, False), "replicated": (False, False),
               "prim": (False, True), "pre_prim": (True, True)}
# (rtol, atol) of a step-1 leaf against the single-process step:
# tests/test_parallel.py:146-176's for the parameters, the first moments
# and the view-space accumulator; the second moments (0.001·g², whose
# relative error is twice the gradient's) at twice the first's rtol;
# denom and max_radii2d exactly
SHARD_TOL = {"p": (2e-4, 2e-6), "mu": (2e-4, 5e-5), "nu": (4e-4, 1e-9),
             "xyz_gradient_accum": (2e-4, 1e-7), "denom": (0.0, 0.0),
             "max_radii2d": (0.0, 0.0)}
# a parameter's gradient is at float32 noise below this share of its
# leaf's largest first moment (:func:`compare_records`): the rounding of
# sums of some hundred float32 terms (each ~6e-8 relative)
GRAD_NOISE = 1e-5
# phase 15 (c)'s schedule: 20 + 60 steps with densify from 10 every 20 until
# PR 16, cut to 10 + 30 with densify from 5 every 10 (still crossing a
# capacity growth) to pay for phase 16
SHARD_CLI_SCHEDULE = ("opt.coarse_iterations=10", "opt.iterations=30",
                      "opt.position_lr_max_steps=30", "opt.densify_from_iter=5",
                      "opt.densification_interval=10", "tpu.capacity_init=2048")


def _rank_device(backend: str):
    """A rank's device: ``cuda:0`` for ranks sharing the card over gloo,
    ``cuda:<rank>`` under nccl (a GPU per rank)."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count()
                       if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    return dev


def sharded_inputs(cfg, dev):
    """Phase 15's global batch: ring cameras 0 and 1 (stacked
    ``CameraArrays``) and their GT images [2, 3, 800, 800], K1's render of
    the second seeded scene, as phase 6's GT."""
    import torch

    from fourdgs_tpu_torch import render as TR

    gt_state = bench_scene(cfg, seed=1, device=dev)
    bg = torch.ones(3, device=dev)
    cams, gts = [], []
    for i in range(SHARD_BATCH):
        cam = TR.CameraArrays.from_camera(ring_camera(i, N_TIMED), device=dev)
        with torch.no_grad():
            gts.append(TR.render(gt_state.params, gt_state, cam, cfg, WIDTH, HEIGHT,
                                 "fine", bg, cfg.model.sh_degree, device=dev).color)
        cams.append(cam)
    return TR.CameraArrays(*(torch.stack(xs) for xs in zip(*cams))), torch.stack(gts)


def shard_record(state, opt, metrics) -> dict:
    """The leaves phase 15 compares, as numpy: parameters, moments and the
    densification statistics after a step."""
    from fourdgs_tpu_torch.train import adam

    rec = {}
    for tag, tree in (("p", state.params), ("mu", opt.mu), ("nu", opt.nu)):
        rec.update({f"{tag}.{n}": x.detach().cpu().numpy()
                    for n, x in adam.named_leaves(tree)})
    for f in ("xyz_gradient_accum", "denom", "max_radii2d"):
        rec[f] = getattr(state, f).cpu().numpy()
    rec["loss"] = np.float32(float(metrics["loss"]))
    return rec


def compare_records(got: dict, want: dict, where: str) -> list:
    """Each leaf of ``got`` against ``want`` at :data:`SHARD_TOL`; prints the
    largest difference of each group and the elements over tolerance, and
    returns the groups with any. A parameter may differ beyond tolerance
    only where its gradient is zero to float32 noise (both first moments
    within :data:`GRAD_NOISE` of the leaf's largest): a gradient that
    cancels to 0 in one association leaves a residual in another, and
    Adam's first step turns any nonzero gradient into a step of ±lr. Those
    are counted apart, at most 1e-4 of a leaf, and each is printed with
    both parameters and both first moments."""
    groups: dict = {}
    noise_steps = 0
    for k, w in want.items():
        if k == "loss":
            continue
        group = k.split(".")[0]
        rtol, atol = SHARD_TOL[group]
        g = got[k]
        diff = np.abs(g.astype(np.float64) - w.astype(np.float64))
        over = diff > atol + rtol * np.abs(w)
        if group == "p" and over.any():
            mu_w, mu_g = want["mu" + k[1:]], got["mu" + k[1:]]
            floor = GRAD_NOISE * np.abs(mu_w).max()
            noise = over & (np.abs(mu_w) <= floor) & (np.abs(mu_g) <= floor)
            if noise.sum() <= 1e-4 * over.size:
                noise_steps += int(noise.sum())
                over &= ~noise
                for i in map(tuple, np.argwhere(noise)[:8]):
                    print(f"    {where}: {k}{list(i)} at gradient noise: parameter "
                          f"{g[i]:.9g} against {w[i]:.9g}, first moment {mu_g[i]:.3g} "
                          f"against {mu_w[i]:.3g} (the leaf's largest |moment| "
                          f"{np.abs(mu_w).max():.3g})")
        n, mx, ov = groups.get(group, (0, 0.0, 0))
        groups[group] = (n + w.size, max(mx, float(diff.max()) if diff.size else 0.0),
                         ov + int(over.sum()))
    print(f"    {where}: " + "; ".join(
        f"{g} max |diff| {mx:.3g}, {ov} of {n} over (rtol {SHARD_TOL[g][0]:g}, "
        f"atol {SHARD_TOL[g][1]:g})" for g, (n, mx, ov) in groups.items())
        + f"; parameters over tolerance with a gradient at float32 noise: {noise_steps}")
    return [g for g, (_, _, ov) in groups.items() if ov]


def _state_hash(state, opt) -> str:
    import hashlib

    from fourdgs_tpu_torch.parallel import trainer

    h = hashlib.sha256()
    for t in trainer.tensor_leaves([state, opt.mu, opt.nu]):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def slab_blend_check(cfg, state, cams, gts, mesh, dev) -> dict:
    """:func:`check_step_blend` at this rank's slab of its first camera:
    the blend inputs the sharded step builds (tile-row offset m, stride M)
    and the cotangent of its L1 share on the slab's rows."""
    import torch

    from fourdgs_tpu_torch import render as TR
    from fourdgs_tpu_torch.ops import blend
    from fourdgs_tpu_torch.ops import rasterize as R
    from fourdgs_tpu_torch.utils.losses import abs_

    n_model = mesh.shape["model"]
    rows = (HEIGHT // 16) // n_model
    cam = TR.CameraArrays(*(x[0] for x in cams))
    bg = torch.ones(3, device=dev)
    with torch.no_grad():
        xyz, sc, rot, op, shs, _ = TR.activated_gaussians(state.params, state, cam, "fine")
        bi = R.blend_inputs(xyz, sc, rot, op, shs, cam.camera_center, cam.world_view,
                            cam.full_proj, cam.tanfovx, cam.tanfovy, WIDTH, HEIGHT,
                            cfg.model.sh_degree, cfg.tpu.instance_budget,
                            alive=state.alive, payload_bf16=cfg.tpu.payload_bf16,
                            tile_row_offset=mesh.m, tile_rows=rows, tile_row_stride=n_model)
    fwd_args = (bi.feat, bi.bins.tile_start, bi.bins.tile_stop, bi.row_off, bg, bi.grid_x)
    out5 = blend.blend_forward(*fwd_args)
    with torch.enable_grad():
        o = out5.clone().requires_grad_()
        img = R.untile(o[:, 0:3], bi.grid_x, rows, WIDTH, rows * 16)
        share = abs_(img - gts[0, :3]).sum() / (SHARD_BATCH * 3 * WIDTH * HEIGHT)
        (g_out,) = torch.autograd.grad(share, o)
    return check_step_blend(
        fwd_args, (*fwd_args[:5], out5, g_out, fwd_args[5]), dev,
        f"rank {mesh.rank}'s slab (tile rows {mesh.m} + {n_model}j, {rows} of them) of "
        f"the last sharded step")


def sharded_rank(workdir: str, n_data: int, n_model: int, modes: list, n_warm: int,
                 n_timed: int, check_blend: bool) -> dict:
    """One rank of phase 15 (a), (b) and (d): for each mode of ``modes``
    the lego preset's state of phase 6 on an ``n_data × n_model`` grid,
    :func:`sharded_inputs` placed by ``place_batch``; the first mode takes
    ``n_warm + n_timed`` steps, the others one. Rank 0 saves each mode's
    step-1 leaves (:func:`shard_record`) to ``workdir``. Returns the losses,
    per-step ms, K1/K2 launches over the counted steps, peak memory, whether
    the grid's state hashes agree, and for the first mode the gradient
    all-reduce's bytes and ms, the collectives of a step and, on rank 0 with
    ``check_blend``, K1/K2 at its slab (:func:`slab_blend_check`)."""
    import torch
    import torch.distributed as dist

    from fourdgs_tpu_torch.configs.core import load_config
    from fourdgs_tpu_torch.ops import blend
    from fourdgs_tpu_torch.parallel import collectives, trainer
    from fourdgs_tpu_torch.parallel.mesh import make_mesh
    from fourdgs_tpu_torch.train import adam

    backend = dist.get_backend()
    dev = _rank_device(backend)
    mesh = make_mesh(n_data, n_model)
    cfg0 = load_config(LEGO)
    cfg0.tpu.capacity = CAPACITY
    cams_all, gts_all = sharded_inputs(cfg0, dev)
    out = {"rank": mesh.rank, "d": mesh.d, "m": mesh.m, "device": str(dev),
           "backend": backend, "modes": {}}

    def sync():
        torch.cuda.synchronize(dev)

    def hashes_agree(h: str) -> bool:
        t = torch.tensor(np.frombuffer(bytes.fromhex(h), dtype=np.int64).copy(), device=dev)
        g = collectives.all_gather(t[None], mesh.world)
        return bool((g == g[0]).all())

    for i, name in enumerate(modes):
        pre, prim = SHARD_MODES[name]
        cfg = load_config(LEGO)
        cfg.tpu.capacity = CAPACITY
        cfg.tpu.shard_preprocess, cfg.tpu.shard_primitives = pre, prim
        state = bench_scene(cfg, device=dev)
        opt = adam.init(state.params)
        state, opt = trainer.replicate(mesh, state), trainer.replicate(mesh, opt)
        if prim:
            state = state._replace(params=trainer.shard_primitives(mesh, state.params))
            opt = trainer.shard_adam(mesh, opt)
        cams, gts = trainer.place_batch(mesh, cams_all, gts_all)
        step = trainer.make_sharded_train_step(cfg, mesh, WIDTH, HEIGHT, "fine",
                                               cfg.model.sh_degree, device=dev)
        n_steps, counted_from = (n_warm + n_timed, n_warm + 1) if i == 0 else (1, 1)
        losses, ms = [], []
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
        with torch.enable_grad():
            for it in range(1, n_steps + 1):
                if it == counted_from:
                    blend.blend_forward.launches = blend.blend_backward.launches = 0
                    collectives.reset_counts()
                t0 = time.perf_counter()
                params, opt, state, m = step(state.params, opt, state, cams, gts, it)
                state = state._replace(params=params)
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(m["loss"]))
                if it == 1:
                    whole, wopt = state, opt
                    if prim:
                        whole = state._replace(
                            params=trainer.unshard_primitives(mesh, state.params))
                        wopt = trainer.unshard_adam(mesh, opt)
                    if mesh.rank == 0:
                        np.savez(os.path.join(workdir, f"{name}_step1.npz"),
                                 **shard_record(whole, wopt, m))
        rec = {"losses": losses, "ms": ms[counted_from - 1:],
               "launches": (blend.blend_forward.launches, blend.blend_backward.launches),
               "counted_steps": n_steps - counted_from + 1,
               "collectives": dict(collectives.counts),
               "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
               "num_rendered": int(m["num_rendered"]), "b_local": int(gts.shape[0])}
        if prim:
            state = state._replace(params=trainer.unshard_primitives(mesh, state.params))
            opt = trainer.unshard_adam(mesh, opt)
        rec["hash"] = _state_hash(state, opt)
        rec["hashes_agree"] = hashes_agree(rec["hash"])
        if i == 0:
            # the step's gradient all-reduce alone, at its bytes, over the grid
            buf = torch.zeros(step.grad_allreduce_bytes // 4, device=dev)
            collectives.psum(buf, mesh.world)
            sync()
            t0 = time.perf_counter()
            for _ in range(10):
                collectives.psum(buf, mesh.world)
            sync()
            rec["allreduce_ms"] = (time.perf_counter() - t0) * 1e2
            rec["allreduce_bytes"] = step.grad_allreduce_bytes
            if check_blend and mesh.rank == 0:
                with torch.no_grad():
                    rec["blend"] = slab_blend_check(cfg, state, cams, gts, mesh, dev)
        out["modes"][name] = rec
        del state, opt, step
        torch.cuda.empty_cache()
    return out


def sharded_cli_rank(data_dir: str, model_path: str, overrides: tuple) -> dict:
    """One rank of phase 15 (c): ``train_torch.main`` with ``--mesh
    data=2,model=1 --distributed --device cuda:0`` in the world this process
    opened (gloo, CUDA tensors), which ``--distributed`` keeps."""
    import torch

    import bench_quality_torch as BQ
    import train_torch
    from fourdgs_tpu_torch.data import scene as tscene
    from fourdgs_tpu_torch.ops import blend

    tscene.TARGET_SIZE = (WIDTH, HEIGHT)
    iters = next(int(o.split("=")[1]) for o in overrides if o.startswith("opt.iterations="))
    blend.blend_forward.launches = blend.blend_backward.launches = 0
    t0 = time.perf_counter()
    state, opt = train_torch.main([
        "-s", data_dir, "--configs", BQ.PRESET, "--model_path", model_path, "--quiet",
        "--test_iterations", str(iters), "--save_iterations", str(iters),
        "--mesh", "data=2,model=1", "--distributed", "--device", "cuda:0",
        "--override", *overrides])
    torch.cuda.synchronize()
    return {"launches": (blend.blend_forward.launches, blend.blend_backward.launches),
            "points": int(state.alive.sum()), "capacity": int(state.alive.shape[0]),
            "hash": _state_hash(state, opt), "train_s": time.perf_counter() - t0}


def _print_rank_log(path: str, prefix: str = "    ") -> None:
    """The lines a rank printed that carry results (its log, without
    warnings)."""
    with open(path, errors="replace") as f:
        for line in f:
            if line.startswith(prefix) and "Warning" not in line and "return func" not in line:
                print(line.rstrip())


def hold_grid(ranks: list, name: str, rec: dict, ref: dict, where: str) -> list:
    """The failures of mode ``name`` in :func:`sharded_rank`'s results
    ``ranks``: rank 0's step-1 leaves ``rec`` against ``ref``
    (:func:`compare_records`) and its loss within 1e-5; on every rank K1 and
    K2 launched once a local camera a counted step, the loss finite and,
    over more than one step, falling; every rank's state hash equal."""
    runs = [r["modes"][name] for r in ranks]
    failures = [f"{where} {g}" for g in compare_records(rec, ref, where)]
    if abs(float(rec["loss"]) - float(ref["loss"])) > 1e-5:
        failures.append(f"{where} loss {float(rec['loss'])} against {float(ref['loss'])}")
    for r, x in zip(ranks, runs):
        if x["launches"] != (x["b_local"] * x["counted_steps"],) * 2:
            failures.append(f"{where} rank {r['rank']} launches {x['launches']}")
        losses = x["losses"]
        if not all(math.isfinite(v) for v in losses) or (
                len(losses) > 1 and not losses[-1] < losses[0]):
            failures.append(f"{where} rank {r['rank']} loss not finite or not falling: "
                            f"{losses}")
    if not all(x["hashes_agree"] for x in runs) or len({x["hash"] for x in runs}) != 1:
        failures.append(f"{where} the ranks' states differ")
    return failures


def run_grid(grid: tuple, backend: str, modes: list, n_warm: int, n_timed: int,
             check_blend: bool) -> tuple:
    """:func:`sharded_rank` on a ``grid`` (data, model) of ranks over
    ``backend``: (each rank's result, each mode's step-1 leaves of rank 0,
    seconds with the start of the ranks)."""
    from fourdgs_tpu_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_sharded_") as tmp:
        ranks = run_ranks("chip_smoke:sharded_rank", grid[0] * grid[1],
                          dict(workdir=tmp, n_data=grid[0], n_model=grid[1], modes=modes,
                               n_warm=n_warm, n_timed=n_timed, check_blend=check_blend),
                          tmp, backend=backend, timeout=900, threads=2)
        _print_rank_log(os.path.join(tmp, "rank_0.log"))
        recs = {}
        for name in modes:
            with np.load(os.path.join(tmp, f"{name}_step1.npz")) as r:
                recs[name] = {k: r[k] for k in r.files}
    return ranks, recs, time.perf_counter() - t0


def check_sharded_trainer(dev, dnerf_dir: str) -> dict:
    """Phase 15 (module docstring): the sharded trainer on the card
    ``dev``."""
    import torch

    import metrics_torch
    import render_torch
    import train_torch
    from fourdgs_tpu_torch.configs.core import load_config
    from fourdgs_tpu_torch.parallel.launch import run_ranks
    from fourdgs_tpu_torch.scripts import measure_scaling
    from fourdgs_tpu_torch.train import adam
    from fourdgs_tpu_torch.train.loop import make_train_step

    secs = {}
    failures = []
    t_phase = time.perf_counter()
    cfg = load_config(LEGO)
    cfg.tpu.capacity = CAPACITY
    print(f"[15] the sharded trainer (lego preset, {N_POINTS:,} Gaussians in "
          f"{CAPACITY:,} rows, {WIDTH}x{HEIGHT}, global batch {SHARD_BATCH})", flush=True)
    # the single-process step 1 the grid is held against
    state = bench_scene(cfg, device=dev)
    opt = adam.init(state.params)
    cams, gts = sharded_inputs(cfg, dev)
    step = make_train_step(cfg, WIDTH, HEIGHT, "fine", cfg.model.sh_degree, device=dev)
    with torch.enable_grad():
        params, opt, state, m = step(state.params, opt, state, cams, gts, 1)
    ref = shard_record(state._replace(params=params), opt, m)
    del state, opt, step, params
    torch.cuda.empty_cache()

    def print_ranks(ranks, name):
        for r in ranks:
            x = r["modes"][name]
            print(f"    rank {r['rank']} (d, m) = ({r['d']}, {r['m']}) on {r['device']}: "
                  f"ms/step median {float(np.median(x['ms'])):.3f} (min {min(x['ms']):.3f}), "
                  f"peak memory {x['peak_gib']:.3f} GiB, K1/K2 launches {x['launches']} over "
                  f"{x['counted_steps']} steps of {x['b_local']} camera(s), loss "
                  f"{x['losses'][0]:.6f} -> {x['losses'][-1]:.6f}")

    # -- (a) and (b): four ranks on cuda:0 over gloo
    D, M = SHARD_GRID
    ranks, recs, secs["a+b"] = run_grid(SHARD_GRID, "gloo", list(SHARD_MODES), SHARD_WARM,
                                        SHARD_TIMED, check_blend=True)
    print(f"    (a) {D}x{M} grid, {D * M} ranks sharing cuda:0 over gloo, the default "
          f"config (shard_preprocess): {SHARD_WARM} warm-up + {SHARD_TIMED} timed "
          f"steps, {secs['a+b']:.1f} s with the start of the ranks")
    print("    these times are of four ranks time-sliced on one card: no scaling number")
    print_ranks(ranks, "pre")
    a = [r["modes"]["pre"] for r in ranks]
    a0 = a[0]
    print(f"    gradient all-reduce over the grid: {a0['allreduce_bytes']:,} bytes, "
          f"{a0['allreduce_ms']:.3f} ms (rank 0; {max(x['allreduce_ms'] for x in a):.3f} ms "
          f"the slowest rank); collectives of rank 0 over the timed steps: "
          f"{json.dumps(a0['collectives'])}")
    failures += hold_grid(ranks, "pre", recs["pre"], ref,
                          "(a) step 1 against the single-process step")
    print(f"    every rank's whole state after the last step equal bit for bit: "
          f"{all(ra['hashes_agree'] for ra in a)} (sha256 {a0['hash'][:16]}...)")
    # (b) the other modes, one step each, against (a)'s step 1
    for name in list(SHARD_MODES)[1:]:
        rb = [r["modes"][name] for r in ranks]
        print(f"    (b) {name} (shard_preprocess, shard_primitives = "
              f"{SHARD_MODES[name]}): loss {rb[0]['losses'][0]:.6f}, K1/K2 launches "
              f"{[x['launches'] for x in rb]}, ms {rb[0]['ms'][0]:.3f}, states equal "
              f"{all(x['hashes_agree'] for x in rb)}")
        failures += hold_grid(ranks, name, recs[name], recs["pre"],
                              f"(b) {name} against (a)'s step 1")

    # -- (c) the CLI, two ranks on cuda:0 over gloo
    t0 = time.perf_counter()
    if torch.cuda.device_count() < 2:
        try:
            train_torch.main(["-s", dnerf_dir, "--mesh", "data=2,model=1", "--device", "cuda"])
        except ValueError as e:
            print(f"    (c) --mesh data=2,model=1 without --distributed on one GPU raises: {e}")
        else:
            failures.append("(c) --mesh data=2 on one GPU did not raise")
    iters = next(int(o.split("=")[1]) for o in SHARD_CLI_SCHEDULE
                 if o.startswith("opt.iterations="))
    steps = iters + next(int(o.split("=")[1]) for o in SHARD_CLI_SCHEDULE
                         if o.startswith("opt.coarse_iterations="))
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_sharded_cli_") as tmp:
        model_path = os.path.join(tmp, "mesh")
        cli = run_ranks("chip_smoke:sharded_cli_rank", 2,
                        dict(data_dir=dnerf_dir, model_path=model_path,
                             overrides=SHARD_CLI_SCHEDULE),
                        os.path.join(tmp, "ranks"), backend="gloo", timeout=900, threads=4)
        ckpts = [d for d in os.listdir(model_path) if d.startswith("chkpnt_")]
        evals = sum("_render_" in f for f in os.listdir(os.path.join(model_path, "eval_images")))
        render_torch.main(["--model_path", model_path, "--skip_train", "--skip_video",
                           "--device", "cuda"])
        mesh_psnr = metrics_torch.main(["--model_path", model_path, "--device", "cuda"])[
            model_path][f"ours_{iters}"]["PSNR"]
        plain = run_cli_chain(dnerf_dir, os.path.join(tmp, "single"), dev,
                              overrides=SHARD_CLI_SCHEDULE)
    print(f"    (c) train_torch.py --mesh data=2,model=1 --distributed on two ranks sharing "
          f"cuda:0 over gloo ({steps} steps of the bouncingballs preset at {WIDTH}x{HEIGHT}): "
          f"{cli[0]['train_s']:.1f} s, {cli[0]['points']} points in capacity "
          f"{cli[0]['capacity']}, checkpoints {sorted(ckpts)}, K1/K2 launches by rank "
          f"{[c['launches'] for c in cli]} ({evals} eval views on rank 0), states equal "
          f"{cli[0]['hash'] == cli[1]['hash']}; render_torch.py of rank 0's checkpoint: "
          f"PSNR {mesh_psnr:.4f} dB")
    print(f"    the same command without --mesh: {plain['train_s']:.1f} s, "
          f"{plain['points']} points, PSNR {plain['psnr']:.4f} dB (blank image "
          f"{plain['blank_psnr']:.4f})")
    if cli[0]["hash"] != cli[1]["hash"]:
        failures.append("(c) the ranks' states differ")
    if cli[0]["capacity"] <= 2048:
        failures.append(f"(c) no capacity growth: {cli[0]['capacity']}")
    if ckpts != [f"chkpnt_fine_{iters}"]:
        failures.append(f"(c) checkpoints {ckpts}")
    if (cli[1]["launches"] != (steps, steps)
            or cli[0]["launches"] != (steps + evals, steps)):
        failures.append(f"(c) launches {[c['launches'] for c in cli]}")
    if not (math.isfinite(mesh_psnr) and mesh_psnr > plain["blank_psnr"]):
        failures.append(f"(c) PSNR {mesh_psnr}")
    secs["c"] = time.perf_counter() - t0

    # -- (d) NCCL: a world of one rank; (a) with one rank per GPU where there
    # are two or more
    (one,), r1, secs["d"] = run_grid((1, 1), "nccl", ["pre"], 1, 2, check_blend=False)
    d1 = one["modes"]["pre"]
    print(f"    (d) a world of one rank over nccl: ms/step {d1['ms']}, K1/K2 launches "
          f"{d1['launches']} over {d1['counted_steps']} steps of {d1['b_local']} cameras")
    failures += hold_grid([one], "pre", r1["pre"], ref,
                          "(d) one rank: step 1 against the single-process step")
    n_gpu = torch.cuda.device_count()
    if n_gpu >= 2:
        grid = (2, 2) if n_gpu >= 4 else (2, 1)
        many, rm, t_many = run_grid(grid, "nccl", ["pre"], SHARD_WARM, SHARD_TIMED,
                                    check_blend=False)
        secs["d"] += t_many
        print(f"    (d) {grid[0]}x{grid[1]} grid, one rank per GPU over nccl:")
        print_ranks(many, "pre")
        failures += hold_grid(many, "pre", rm["pre"], ref,
                              f"(d) {grid[0]}x{grid[1]} over nccl: step 1 against the "
                              "single-process step")
    else:
        print(f"    (d) one rank per GPU over nccl: not run, this host has {n_gpu} GPU "
              "(nccl needs a GPU per rank)")

    # -- (e) T_slab(1/N) on the card
    t0 = time.perf_counter()
    scaling = measure_scaling.run(dev, size=WIDTH, shards=(1, 2, 4, 10), iters=2, reps=2,
                                  n_points=N_POINTS, capacity=CAPACITY)
    print(f"    (e) measure_scaling: full step {scaling['full_step_ms']:.3f} ms, rest "
          f"{scaling['rest_ms']:.3f} ms; " + "; ".join(
              f"N={s['n_model']}: A {s['pre_fwd_bwd_ms']:.3f}, B {s['blend_fwd_bwd_ms']:.3f} "
              f"ms, demand {s['demand']}" for s in scaling["slabs"]))
    for s in scaling["slabs"]:
        if "pre_busy_ms" in s:
            print(f"    (e) N={s['n_model']} by torch.profiler: A busy {s['pre_busy_ms']:.3f} "
                  f"of {s['pre_wall_ms']:.3f} ms wall ({s['pre_launches']:.0f} device "
                  f"events, idle {s['pre_idle']:.3f}); B busy {s['blend_busy_ms']:.3f} of "
                  f"{s['blend_wall_ms']:.3f} ms ({s['blend_launches']:.0f}, idle "
                  f"{s['blend_idle']:.3f})")
    secs["e"] = time.perf_counter() - t0
    print("    phase 15 seconds: " + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items())
          + f", all {time.perf_counter() - t_phase:.1f}")
    if failures:
        raise AssertionError(f"phase 15: {failures}")
    return {"a": a0, "cli": cli[0], "scaling": scaling}


# -- phase 16: the repaired divergences and the last entry points -------------

PNG_MODES = (None, "L", "RGB", "RGBA")


def variant_decodes() -> dict:
    """Pillow's decodes of the committed variant fixtures: ``<stem>`` (a
    JPEG's, or a PNG's ``np.asarray``), ``<stem>.<mode>`` (a PNG's
    ``convert(mode)``), and ``capture_1352x1014.sha256``, the SHA-256 of
    the decode of the 1352×1014 picture (whose array alone would outweigh
    the committed files)."""
    with np.load(os.path.join(VARIANT_FIXTURES, "pillow_decode.npz")) as z:
        return {k: z[k] for k in z.files}


def decode_sha256(img: np.ndarray) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def check_decoders(reps: int = 10) -> dict:
    """Phase 16 (b) (module docstring): every committed variant fixture
    decoded on the host bit for bit against Pillow's committed decode (the
    progressive scene frames against the baseline frames' decodes, the
    1352×1014 picture by its decode's SHA-256), the progressive file whose
    scans leave coefficients unrefined against its decode in
    ``tests/torch_fixtures/rare`` (libjpeg smooths its blocks), the ms a
    1352×1014 frame progressive and baseline read in turns, and a
    MultipleView scene of the progressive frames through ``load_scene``.
    Returns the counts and the times."""
    from fourdgs_tpu_torch.configs.core import load_config
    from fourdgs_tpu_torch.data.scene import load_scene
    from fourdgs_tpu_torch.utils import png
    from fourdgs_tpu_torch.utils.jpeg import read_jpeg

    print("    (b) the decoders on the committed progressive JPEGs and PNG variants",
          flush=True)
    want = variant_decodes()
    with np.load(os.path.join(JPEG_FIXTURES, "pillow_decode.npz")) as z:
        baseline = {k: z[k] for k in z.files}

    same = assert_same_decode
    n_jpeg = n_png = 0
    for fname in sorted(os.listdir(VARIANT_FIXTURES)):
        stem, ext = os.path.splitext(fname)
        path = os.path.join(VARIANT_FIXTURES, fname)
        if ext == ".png":
            for mode in PNG_MODES:
                same(f"{stem} {mode}", png.read_png(path, mode),
                     want[stem if mode is None else f"{stem}.{mode}"])
            n_png += 1
        elif stem == "prog_unrefined":     # smoothed as libjpeg smooths it
            same(stem, read_jpeg(path), rare_decodes()[stem])
            n_jpeg += 1
        elif ext == ".jpg":
            got = read_jpeg(path)
            if stem.startswith(CAPTURE_FRAME):
                if decode_sha256(got) != str(want[CAPTURE_FRAME + ".sha256"]):
                    raise AssertionError(f"{fname}: the decode's SHA-256 is not Pillow's")
            else:
                same(stem, got, baseline[stem[len("prog_"):]] if stem.startswith("prog_frame")
                     else want[stem])
            n_jpeg += 1
    paths = {kind: os.path.join(VARIANT_FIXTURES, f"{CAPTURE_FRAME}_{kind}.jpg")
             for kind in ("progressive", "baseline")}
    times = {kind: [] for kind in paths}
    for _ in range(reps):
        for kind in ("progressive", "baseline", "baseline", "progressive"):
            t0 = time.perf_counter()
            read_jpeg(paths[kind])
            times[kind].append(1e3 * (time.perf_counter() - t0))
    ms = {kind: float(np.median(v)) for kind, v in times.items()}
    sizes = {kind: os.path.getsize(p) for kind, p in paths.items()}
    print(f"    the decoders on the committed variants: {n_jpeg} JPEG files (progressive "
          f"4:4:4, 4:2:2, 4:2:0, grey, restart intervals, Huffman tables per scan, the "
          f"1352x1014 picture both ways) and {n_png} PNG files (palette, 1/2/16-bit grey, "
          f"16-bit RGB, gray + alpha and RGBA, tRNS, Adam7), each read bit for bit as "
          f"Pillow reads it, the file of unrefined scans smoothed as libjpeg smooths it")
    print(f"    read_jpeg of the 1352x1014 picture, median of {2 * reps} reads in turns "
          f"(host): progressive {ms['progressive']:.4f} ms ({sizes['progressive']} B), "
          f"baseline {ms['baseline']:.4f} ms ({sizes['baseline']} B), ratio "
          f"{ms['progressive'] / ms['baseline']:.3f}")

    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_progressive_") as tmp:
        write_multipleview_scene(tmp, frame=progressive_frame)
        t0 = time.perf_counter()
        data = load_scene(load_config(), tmp)
        load_s = time.perf_counter() - t0
        lcs = data.train_cameras + data.test_cameras
        seen = set()
        for lc in lcs:
            cam_dir = os.path.basename(os.path.dirname(lc.image.path))       # camNN
            f = int(os.path.basename(lc.image.path)[len("frame_"):-4]) - 1
            seen.add(name := f"frame_c{int(cam_dir[3:]) - 1}_f{f}")
            same(lc.image.path, lc.image(), baseline[name])
    if data.dataset_type != "MultipleView" or len(seen) != JPEG_SCENE_CAMS * JPEG_SCENE_FRAMES:
        raise AssertionError(f"MultipleView of progressive frames: {data.dataset_type}, "
                             f"{len(seen)} frames")
    print(f"    MultipleView of the 12 progressive frames: load_scene {load_s:.4f} s, "
          f"{len(data.train_cameras)} train + {len(data.test_cameras)} test cameras over "
          f"{len(seen)} frames, every frame equal to the baseline frame's Pillow decode")
    return {"jpeg_files": n_jpeg, "png_files": n_png, "ms": ms, "bytes": sizes,
            "multipleview_frames": len(seen), "load_s": load_s}


# -- phase 17: the rarer JPEG codings -------------------------------------------

RARE_FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures", "rare")
# the codings of every one of the twelve committed frames in RARE_FIXTURES:
# the same picture, so the decodes of tests/torch_fixtures/jpeg
RARE_FRAME_KINDS = ("arith", "arithprog", "lossless")
# phase 17 (b)'s MultipleView scene: slot (c, f) holds the coding
# RARE_SCENE_KINDS[(4c + f) % 6]; the last three of a picture of their own
RARE_SCENE_KINDS = RARE_FRAME_KINDS + ("smooth", "s411", "cmyk")
RARE_CUT = 3                       # the scans of phase 17 (a)'s smoothed 1352x1014 file


def rare_kind(c, f):
    return RARE_SCENE_KINDS[(c * JPEG_SCENE_FRAMES + f) % len(RARE_SCENE_KINDS)]


def rare_frame(c, f):
    """Slot (c, f) of phase 17 (b)'s MultipleView scene: the committed file
    of coding :func:`rare_kind` (c, f)."""
    return os.path.join(RARE_FIXTURES, f"{rare_kind(c, f)}_frame_c{c}_f{f}.jpg")


def rare_decodes() -> dict:
    """Pillow's decodes of ``tests/torch_fixtures/rare`` by file stem (a CMYK
    or YCCK file's ``convert("RGB")`` as ``<stem>.RGB``; a 160×120 scene
    picture's as the SHA-256 ``<stem>[.RGB].sha256``), of the variants'
    ``prog_unrefined``, and the SHA-256 of the decode of the 1352×1014
    picture's progressive file cut after ``RARE_CUT`` scans. The re-encoded
    frames (:data:`RARE_FRAME_KINDS`) decode as the committed frames'
    ``tests/torch_fixtures/jpeg/pillow_decode.npz``."""
    with np.load(os.path.join(RARE_FIXTURES, "pillow_decode.npz")) as z:
        return {k: z[k] for k in z.files}


def rare_want(stem, rare, baseline, mode=None):
    """The committed decode of rare fixture ``stem`` (``mode`` "RGB": of
    ``Image.open(path).convert("RGB")``): an array, or its SHA-256."""
    kind, _, slot = stem.partition("_frame_")
    if kind in RARE_FRAME_KINDS and slot:
        return baseline["frame_" + slot]
    key = stem
    if mode == "RGB" and (stem + ".RGB" in rare or stem + ".RGB.sha256" in rare):
        key += ".RGB"
    if key + ".sha256" in rare:
        return str(rare[key + ".sha256"])
    want = rare[key]
    if mode == "RGB" and want.ndim == 2:
        return np.repeat(want[:, :, None], 3, axis=2)
    return want


def same_decode(got, want) -> bool:
    """Whether a decode equals a committed one (an array, or a SHA-256)."""
    if isinstance(want, str):
        return decode_sha256(got) == want
    return got.shape == want.shape and got.dtype == want.dtype and np.array_equal(got, want)


def assert_same_decode(name, got, want):
    if not same_decode(got, want):
        raise AssertionError(f"{name}: the port's decode is not Pillow's bit for bit")


def scans_cut(data: bytes, n_scans: int) -> bytes:
    """The first ``n_scans`` scans of a JPEG file, then EOI: a progressive
    file cut short by its writer."""
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    return data[:sos[n_scans]] + b"\xff\xd9"


def jpeg_writer():
    """``tests/jpeg_writer.py``, the fixtures' numpy JPEG writer, loaded by
    its path (another ``tests`` package may come first on ``sys.path``)."""
    import importlib.util

    if "jpeg_writer" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "jpeg_writer", os.path.join(ROOT, "tests", "jpeg_writer.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules["jpeg_writer"] = mod
        spec.loader.exec_module(mod)
    return sys.modules["jpeg_writer"]


def capture_codings(out_dir) -> dict:
    """The 1352×1014 picture of phase 16 (b) in each coding phase 17 (a)
    times, written into ``out_dir`` on this host: its progressive file cut
    after ``RARE_CUT`` scans (smoothed), and by ``tests/jpeg_writer.py``
    4:1:1, CMYK (Adobe transform 0) and YCCK (2h2v luma and K) files of
    its decode at libjpeg's quality 90, and its baseline file's
    coefficients arithmetic-coded, sequential and progressive, and its
    decode as lossless RGB. Returns the path of each by coding."""
    from fourdgs_tpu_torch.utils.jpeg import read_jpeg

    W = jpeg_writer()
    base = os.path.join(VARIANT_FIXTURES, f"{CAPTURE_FRAME}_baseline.jpg")
    with open(base, "rb") as f:
        base_data = f.read()
    with open(os.path.join(VARIANT_FIXTURES, f"{CAPTURE_FRAME}_progressive.jpg"), "rb") as f:
        prog_data = f.read()
    picture = read_jpeg(base)
    h, w = picture.shape[:2]
    planes = [p for p in W.rgb_to_ycc(picture).transpose(2, 0, 1)]
    qt = W.quality_tables(90)
    cmy = 255 - picture.astype(np.int64)
    k = cmy.min(axis=2)
    cmyk = [(cmy[:, :, i] - k).astype(np.uint8) for i in range(3)] + [k.astype(np.uint8)]
    frame = W.read_baseline(base_data)
    files = {
        "smooth": scans_cut(prog_data, RARE_CUT),
        "s411": W.write_dct(W.dct_frame(planes, [(4, 1), (1, 1), (1, 1)], qt)),
        "cmyk": W.write_dct(W.dct_frame(cmyk, [(1, 1)] * 4, qt, tqs=[0, 0, 0, 0],
                                        app=W.adobe(0))),
        "ycck": W.write_dct(W.dct_frame(planes + [255 - cmyk[3]], [(2, 2), (1, 1), (1, 1),
                                                                  (2, 2)], qt,
                                        tqs=[0, 1, 1, 0], app=W.adobe(2))),
        "arith": W.write_dct(frame, arithmetic=True),
        "arithprog": W.write_dct(frame, arithmetic=True, scans=W.simple_progression(3)),
        "lossless": W.write_lossless(w, h, [W.Component(ord(ch), 1, 1, samples=picture[:, :, i])
                                            for i, ch in enumerate("RGB")], app=W.adobe(0)),
    }
    paths = {}
    for kind, data in files.items():
        paths[kind] = os.path.join(out_dir, f"{CAPTURE_FRAME}_{kind}.jpg")
        with open(paths[kind], "wb") as f:
            f.write(data)
    return paths


def check_rare_decoders(reps: int = 5) -> dict:
    """Phase 17 (a) (module docstring): every committed file of
    ``tests/torch_fixtures/rare`` decoded on the host bit for bit against
    Pillow's committed decode (and its conversion to RGB through
    ``png.convert``), the variants' unrefined progressive file smoothed as
    libjpeg smooths it, then the 1352×1014 picture in each rarer coding
    (:func:`capture_codings`) read in turns with its baseline file: the
    arithmetic-coded and lossless files' decodes equal the baseline's
    (SHA-256), the smoothed one's Pillow's. Returns the counts, times and
    sizes."""
    from fourdgs_tpu_torch.utils import png
    from fourdgs_tpu_torch.utils.jpeg import read_jpeg

    print("    (a) the JPEG decoder on the committed files of the rarer codings", flush=True)
    rare = rare_decodes()
    with np.load(os.path.join(JPEG_FIXTURES, "pillow_decode.npz")) as z:
        baseline = {k: z[k] for k in z.files}

    same = assert_same_decode
    counts = {}
    for fname in sorted(os.listdir(RARE_FIXTURES)):
        stem, ext = os.path.splitext(fname)
        if ext != ".jpg":
            continue
        got = read_jpeg(os.path.join(RARE_FIXTURES, fname))
        same(stem, got, rare_want(stem, rare, baseline))
        if got.ndim == 3 and got.shape[2] == 4:
            same(stem + " RGB", png.convert(got, "RGB", "CMYK"),
                 rare_want(stem, rare, baseline, "RGB"))
        kind = stem.split("_")[0]
        counts[kind] = counts.get(kind, 0) + 1
    same("prog_unrefined", read_jpeg(os.path.join(VARIANT_FIXTURES, "prog_unrefined.jpg")),
         rare["prog_unrefined"])
    n_files = sum(counts.values()) + 1
    print(f"    {n_files} committed files, each read bit for bit as Pillow reads it: "
          f"{json.dumps(counts)} and the variants' prog_unrefined")

    sha = str(variant_decodes()[CAPTURE_FRAME + ".sha256"])
    base = os.path.join(VARIANT_FIXTURES, f"{CAPTURE_FRAME}_baseline.jpg")
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_rare_capture_") as tmp:
        t0 = time.perf_counter()
        paths = capture_codings(tmp)
        write_s = time.perf_counter() - t0
        times = {kind: [] for kind in paths}
        base_times = []
        for kind, path in paths.items():
            for _ in range(reps):
                for k in (kind, "baseline", "baseline", kind):
                    t0 = time.perf_counter()
                    img = read_jpeg(base if k == "baseline" else path)
                    (base_times if k == "baseline" else times[kind]).append(
                        1e3 * (time.perf_counter() - t0))
            if img.shape[:2] != (1014, 1352):
                raise AssertionError(f"{kind}: shape {img.shape}")
            img = read_jpeg(path)
            if kind in RARE_FRAME_KINDS and decode_sha256(img) != sha:
                raise AssertionError(f"{kind}: the 1352x1014 decode is not the baseline's")
            if kind == "smooth" and decode_sha256(img) != str(rare["capture_smooth.sha256"]):
                raise AssertionError("smooth: the 1352x1014 decode is not Pillow's")
        sizes = {kind: os.path.getsize(p) for kind, p in paths.items()}
    ms = {kind: float(np.median(v)) for kind, v in times.items()}
    ms["baseline"] = float(np.median(base_times))
    print(f"    the 1352x1014 picture in each coding, written on this host in {write_s:.1f} s "
          f"(arithmetic and lossless files decode as the baseline file, SHA-256; the "
          f"smoothed one as Pillow)")
    print("    read_jpeg, median of " + f"{2 * reps} reads in turns with the baseline file "
          f"(host), ms (bytes; / baseline): " + ", ".join(
              f"{kind} {ms[kind]:.4f} ({sizes[kind]}; {ms[kind] / ms['baseline']:.3f})"
              for kind in paths) + f"; baseline {ms['baseline']:.4f}")
    return {"files": n_files, "counts": counts, "ms": ms, "bytes": sizes, "write_s": write_s}


def check_rare_chain(dev, schedule=MULTIPLEVIEW_SCHEDULE, preset=MULTIPLEVIEW_PRESET) -> dict:
    """Phase 17 (b) (module docstring): a MultipleView scene of the rarer
    codings (:func:`rare_frame`), every frame ``load_scene`` gives equal to
    Pillow's committed decode converted to RGB, through
    ``train_torch.py`` → ``render_torch.py`` → ``metrics_torch.py``
    (:func:`run_cli_chain`), with K1 and K2's launches counted, then K1 and
    K2 at a train step of its model (train view 0) against their plain
    versions (:func:`check_step_blend`). Returns the launches and that
    check's fields."""
    import torch

    from fourdgs_tpu_torch.configs.core import load_config
    from fourdgs_tpu_torch.data.scene import load_scene
    from fourdgs_tpu_torch.render import CameraArrays
    from fourdgs_tpu_torch.utils import losses

    print("    (b) the MultipleView chain on frames of the rarer codings", flush=True)
    rare = rare_decodes()
    with np.load(os.path.join(JPEG_FIXTURES, "pillow_decode.npz")) as z:
        baseline = {k: z[k] for k in z.files}
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_rare_scene_") as tmp:
        data_dir, model_path = os.path.join(tmp, "data"), os.path.join(tmp, "model")
        write_multipleview_scene(data_dir, frame=rare_frame)
        data = load_scene(load_config(), data_dir)
        kinds = {}
        for lc in data.train_cameras + data.test_cameras:
            c = int(os.path.basename(os.path.dirname(lc.image.path))[3:]) - 1
            f = int(os.path.basename(lc.image.path)[len("frame_"):-4]) - 1
            stem = os.path.basename(rare_frame(c, f))[:-4]
            if not same_decode(lc.image(), rare_want(stem, rare, baseline, "RGB")):
                raise AssertionError(f"{stem}: the loader's frame is not Pillow's RGB")
            kinds[stem] = rare_kind(c, f)
        cli = run_cli_chain(data_dir, model_path, dev, schedule, preset)
        with open(os.path.join(model_path, "training_logs.json")) as f:
            logged = [r["loss"] for r in json.load(f)]
        cfg, state = cli["cfg"], cli["state"]
        lc0 = cli["scene"].train_cameras[0]
        cam0 = lc0.camera
        bg = torch.ones(3, device=dev) if cfg.model.white_background else torch.zeros(3, device=dev)
        gt0 = torch.tensor(lc0.image(), device=dev).to(torch.float32).permute(2, 0, 1) / 255.0
        fwd_args, bwd_args = step_blend_inputs(
            cfg, state, CameraArrays.from_camera(cam0, device=dev), cam0.width, cam0.height,
            losses.tile_image(gt0, pad_cols=2), bg, state.active_sh_degree, dev)
        trained = check_step_blend(
            fwd_args, bwd_args, dev,
            f"train view 0 of the MultipleView model of the rarer codings ({cam0.width}x"
            f"{cam0.height}, capacity {state.alive.shape[0]}, {int(state.alive.sum())} alive, "
            f"SH degree {state.active_sh_degree})")
    pf = cli["prefetch"]
    renders = cli["steps"] * cli["batch_size"]
    on_card = int(dev.type == "cuda")
    (k1_train, k2_train), (k1_render, _) = cli["train_launches"], cli["render_launches"]
    by_kind = {k: sum(v == k for v in kinds.values()) for k in RARE_SCENE_KINDS}
    print(f"    MultipleView ({JPEG_SCENE_CAMS} cams x {JPEG_SCENE_FRAMES} frames, codings "
          f"{json.dumps(by_kind)}): every loaded frame equal to Pillow's RGB; train wall "
          f"{cli['train_s']:.3f} s ({cli['steps']} steps, {cli['points']} points, losses "
          f"{logged[0]:.5f} -> {logged[-1]:.5f}), render FPS {cli['fps']:.3f}, held-out PSNR "
          f"{cli['psnr']:.4f} dB (blank {cli['blank_psnr']:.4f}); renders vs in-process render: "
          f"max {cli['render_max_level_diff']} levels; prefetcher {json.dumps(pf)}; K1/K2 "
          f"launches train {cli['train_launches']}, render {cli['render_launches']}")
    if len(kinds) != JPEG_SCENE_CAMS * JPEG_SCENE_FRAMES or min(by_kind.values()) == 0:
        raise AssertionError(f"the scene's frames: {by_kind}")
    if not all(math.isfinite(x) for x in logged):
        raise AssertionError(f"a logged loss is not finite: {logged}")
    if pf["submitted"] != renders or pf["to_ref"] != renders or pf["native"]:
        raise AssertionError(f"the prefetcher's counts {pf}: every JPEG frame goes to the "
                             f"ref ({renders})")
    if ((k2_train, k1_train) != (on_card * renders, on_card * (renders + cli["eval_renders"]))
            or k1_render != on_card * (cli["test_views"] + 1)):
        raise AssertionError(f"CLI launches: train {cli['train_launches']}, render "
                             f"{cli['render_launches']}")
    return {"cli": (k1_train + k1_render, k2_train), "blend": trained,
            "psnr": cli["psnr"], "blank_psnr": cli["blank_psnr"]}


# -- phase 18: the DyNeRF video extraction ------------------------------------

# the committed H.264 and MPEG-4 Part 2 streams and cv2's decode of each
# (tests/test_torch_h264.py::write_committed_fixtures,
# tests/test_torch_mpeg4.py::write_committed_fixtures)
H264_FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures", "h264")
MPEG4_FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures", "mpeg4")
VIDEO_SIZE = (2704, 2028)          # a Neu3D camera's cam*.mp4
VIDEO_HOST_FRAMES = 4              # phase 18 (b)'s stream: I, P, B, B in decoding order
VIDEO_SCENE_CAMS, VIDEO_SCENE_FRAMES = 2, 3   # phase 18 (c)'s scene (camera 0: MPEG-4
                                              # Part 2 I and P VOPs; camera 1: CABAC I/P
                                              # fields, then MBAFF P and B frames)
VIDEO_SCHEDULE = ("opt.coarse_iterations=2", "opt.iterations=4",
                  "opt.position_lr_max_steps=4", 'opt.custom_sampler="fine"')


def h264_writer(name="h264_writer"):
    """``tests/h264_writer.py``, the fixtures' H.264 writer (or another
    module of ``tests`` by ``name``), loaded by its path (another ``tests``
    package may come first on ``sys.path``)."""
    import importlib.util

    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "tests", name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def mpeg4_video(size=VIDEO_SIZE, frames=VIDEO_HOST_FRAMES, seed=0) -> bytes:
    """An MP4 of ``frames`` MPEG-4 Part 2 VOPs at ``size`` written by
    ``tests/mpeg4_writer.py`` on this host: an I-VOP then P-VOPs (the
    rounding type alternating, as FFmpeg's encoder writes it), one video
    packet a macroblock row whose data the writer codes once a VOP and
    repeats (a packet's data depends on no other packet). Not a camera
    file: random syntax (intra, inter, inter4v and not_coded macroblocks,
    AC prediction, DQUANT), levels quantised at QP 2-12 from the DCT of
    random pixel blocks."""
    W = h264_writer("mpeg4_writer")
    return W.video(W.Config(width=size[0], height=size[1], frames=frames, seed=seed,
                            row_repeat=True, qp=(2, 12)))


def row_video(size=VIDEO_SIZE, frames=VIDEO_HOST_FRAMES, seed=0, b_frames=0,
              cavlc=False, fields=False, mbaff=False) -> bytes:
    """An MP4 of ``frames`` pictures at ``size`` written by
    ``tests/h264_writer.py`` on this host (High profile): an IDR picture
    then P pictures (with ``b_frames``, runs of that many B pictures, each
    coded after the P picture that follows it, the first of a run of 2 or
    more a reference; spatial direct and implicit weights), each of one-row
    slices whose data the writer codes once and repeats (a slice's data
    depends on no other slice), with CABAC or, with ``cavlc``, CAVLC from
    the same draws (the same pictures). With ``fields`` each frame is coded
    as two fields, the top one first (frame_mbs_only_flag 0): the IDR frame
    an I field and a P field predicted from it, then P/P and B/B pairs. With
    ``mbaff`` the frames are MBAFF frames, each macroblock pair coded as
    frame or as field macroblocks with probability 0.5 (and with ``fields``
    too, the IDR frame as the I/P field pair, the others MBAFF). Not a
    camera file: random syntax, every macroblock type and partition,
    residuals at QP 12-44."""
    W = h264_writer()
    cfg = W.Config(width=size[0], height=size[1], frames=frames, seed=seed, row_repeat=True,
                   p_pcm=0.02, num_ref_default=2, max_refs=3, b_frames=b_frames,
                   b_full_runs=True, b_pyramid=True, weighted_bipred=2, cavlc=cavlc,
                   frame_mbs_only=not (fields or mbaff),
                   field_pics=float(fields and not mbaff), mbaff=mbaff,
                   idr_fields=fields and mbaff)
    sps, pps, aus = W.write(cfg)
    return W.mp4(sps, pps, aus, size[0], size[1])


def check_h264_fixtures() -> dict:
    """Phase 18 (a) (module docstring): every committed stream of
    ``tests/torch_fixtures/h264`` decoded on this host, frame by frame with
    the same count, equal to cv2's committed BGR decode. Returns the counts."""
    from fourdgs_tpu_torch.utils import video

    print("[18] the DyNeRF video extraction: (a) the H.264 decoder on the committed "
          "streams", flush=True)
    with np.load(os.path.join(H264_FIXTURES, "cv2_decode.npz")) as z:
        want = {k: z[k] for k in z.files}
    files = frames = 0
    t0 = time.perf_counter()
    for fname in sorted(os.listdir(H264_FIXTURES)):
        stem, ext = os.path.splitext(fname)
        if ext not in (".mp4", ".h264"):
            continue
        got = list(video.read_frames(os.path.join(H264_FIXTURES, fname), bgr=True))
        if len(got) != len(want[stem]) or not all(
                np.array_equal(g, w) for g, w in zip(got, want[stem])):
            raise AssertionError(f"{fname}: the port's decode is not cv2's bit for bit")
        files += 1
        frames += len(got)
    if files != len(want):
        raise AssertionError(f"{files} streams for {len(want)} committed decodes")
    print(f"    {files} streams, {frames} frames: each equal to cv2's committed decode "
          f"({time.perf_counter() - t0:.3f} s)")
    return {"files": files, "frames": frames}


def check_mpeg4_fixtures() -> dict:
    """Phase 18 (a) (module docstring): every committed stream of
    ``tests/torch_fixtures/mpeg4`` decoded on this host, frame by frame
    with the same count, equal to cv2's committed BGR decode. Returns the
    counts."""
    from fourdgs_tpu_torch.utils import video

    print("    (a) the MPEG-4 Part 2 decoder on the committed streams", flush=True)
    with np.load(os.path.join(MPEG4_FIXTURES, "cv2_decode.npz")) as z:
        want = {k: z[k] for k in z.files}
    files = frames = 0
    t0 = time.perf_counter()
    for fname in sorted(os.listdir(MPEG4_FIXTURES)):
        stem, ext = os.path.splitext(fname)
        if ext != ".mp4":
            continue
        got = list(video.read_frames(os.path.join(MPEG4_FIXTURES, fname), bgr=True))
        if len(got) != len(want[stem]) or not all(
                np.array_equal(g, w) for g, w in zip(got, want[stem])):
            raise AssertionError(f"{fname}: the port's decode is not cv2's bit for bit")
        files += 1
        frames += len(got)
    if files != len(want):
        raise AssertionError(f"{files} streams for {len(want)} committed decodes")
    print(f"    {files} streams, {frames} frames: each equal to cv2's committed decode "
          f"({time.perf_counter() - t0:.3f} s)")
    return {"files": files, "frames": frames}


def check_mpeg4_host_times(size=VIDEO_SIZE, frames=VIDEO_HOST_FRAMES) -> dict:
    """Phase 18 (b)'s MPEG-4 Part 2 stream (:func:`mpeg4_video`: I, P, P, P
    at ``size``): each VOP's decode as the decoder timed it (I and P apart)
    and the mean wall per frame out with the RGB conversion. Returns the
    ms and the stream's size."""
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_video_") as tmp:
        t0 = time.perf_counter()
        data = mpeg4_video(size, frames)
        write_s = time.perf_counter() - t0
        path = os.path.join(tmp, "rows_mpeg4.mp4")
        with open(path, "wb") as f:
            f.write(data)
        imgs, stats, decode_ms = _time_decode(path)
    kinds = " ".join(k for k, _ in stats)
    if len(imgs) != frames or imgs[0].shape != (size[1], size[0], 3) or \
            kinds != " ".join("I" + "P" * (frames - 1)):
        raise AssertionError(f"mpeg4: {len(imgs)} frames ({kinds}) of "
                             f"{imgs[0].shape if imgs else None}")
    per = {k: float(np.mean([ms[0] for kind, ms in stats if kind == k])) for k in "IP"}
    print(f"    MPEG4: {frames} VOPs out in the order {kinds} ({len(data) / 1e6:.3f} MB, "
          f"written in {write_s:.2f} s): decode I {per['I']:.2f} ms, P {per['P']:.2f} (each "
          f"timed as it was decoded); {np.mean(decode_ms):.2f} ms a frame out with the RGB "
          f"conversion", flush=True)
    return {"decode_mpeg4_ms": float(np.mean(decode_ms)), "decode_mpeg4_i_ms": per["I"],
            "decode_mpeg4_p_ms": per["P"], "mpeg4_mbytes": len(data) / 1e6,
            "mpeg4_write_s": write_s}


def _time_decode(path) -> tuple:
    """Decodes ``path`` frame by frame: the frames, each frame's (kinds,
    decode ms) of its coded pictures (one a frame, two a field pair) as the
    decoder timed them when it decoded them, and the wall ms of each frame
    out with the RGB conversion."""
    from fourdgs_tpu_torch.utils import video

    decode_ms, imgs, stats = [], [], []
    it = video.read_frames(path, stats=stats)
    while True:
        t0 = time.perf_counter()
        img = next(it, None)
        if img is None:
            break
        decode_ms.append(1e3 * (time.perf_counter() - t0))
        imgs.append(img)
    return imgs, stats, decode_ms


def check_video_host_times(size=VIDEO_SIZE, frames=VIDEO_HOST_FRAMES,
                           target=(1352, 1014)) -> dict:
    """Phase 18 (b) (module docstring): on this host, ms per frame of the
    :func:`row_video` stream at ``size`` (I, P, B, B in decoding order),
    coded with CABAC and then with CAVLC from the same draws, of one whose
    frames are coded as field pairs (I/P, P/P, B/B, B/B; CABAC) and of one
    of MBAFF frames (CABAC, pairs field-coded with probability 0.5): each
    picture's decode as the decoder timed it when it decoded it (I, P and B
    apart, each field apart and each pair of fields; a B picture leaves the
    reorder buffer before the P one it was decoded after), the mean wall
    per frame out with the RGB conversion, the LANCZOS resize to ``target``
    and the PNG write (of the CABAC frames), each timed over every frame.
    The CAVLC stream's frames equal the CABAC stream's. Returns the ms and
    the streams' sizes."""
    from fourdgs_tpu_torch.utils import png, resample

    print(f"    (b) the card's host: decode, resize and PNG write of a {size[0]}x{size[1]} "
          f"stream, coded with CABAC and with CAVLC, and of one coded as field pairs, one "
          f"of MBAFF frames and an MPEG-4 Part 2 one", flush=True)
    out, first = {}, None
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_video_") as tmp:
        for coding in ("cabac", "cavlc", "fields", "mbaff"):
            t0 = time.perf_counter()
            data = row_video(size, frames, b_frames=2, cavlc=coding == "cavlc",
                             fields=coding == "fields", mbaff=coding == "mbaff")
            write_s = time.perf_counter() - t0
            path = os.path.join(tmp, f"rows_{coding}.mp4")
            with open(path, "wb") as f:
                f.write(data)
            imgs, stats, decode_ms = _time_decode(path)
            kinds = " ".join(k for k, _ in stats)
            # the anchor after the IDR frame is P or, as the draws have it, I
            want = ("IP BB BB PP", "IP BB BB IP", "IP BB BB II") if coding == "fields" else \
                ("I B B P",)
            if len(imgs) != frames or imgs[0].shape != (size[1], size[0], 3) or kinds not in want:
                raise AssertionError(f"{coding}: {len(imgs)} frames ({kinds}) of "
                                     f"{imgs[0].shape if imgs else None}")
            if coding == "fields":
                # each field by its type, and each frame by its pair's types
                fld = {k: float(np.mean([m for ks, ms in stats for kk, m in zip(ks, ms)
                                         if kk == k])) for k in "IPB"}
                pair = {ks: float(np.mean([sum(ms) for k2, ms in stats if k2 == ks]))
                        for ks in sorted({k2 for k2, _ in stats})}
                out.update({"decode_fields_ms": float(np.mean(decode_ms)),
                            "fields_mbytes": len(data) / 1e6, "fields_write_s": write_s,
                            **{f"decode_field_{k.lower()}_ms": v for k, v in fld.items()},
                            **{f"decode_pair_{k.lower()}_ms": v for k, v in pair.items()}})
                print(f"    FIELDS: {frames} frames out in the order {kinds} "
                      f"({len(data) / 1e6:.3f} MB, written in {write_s:.2f} s): decode per field "
                      f"I {fld['I']:.2f} ms, P {fld['P']:.2f}, B {fld['B']:.2f}; per frame "
                      + ", ".join(f"{k[0]}/{k[1]} {v:.2f}" for k, v in pair.items()) + " (beside "
                      f"the CABAC frames' I {out['decode_i_ms']:.2f}, P {out['decode_p_ms']:.2f}, "
                      f"B {out['decode_b_ms']:.2f}); {np.mean(decode_ms):.2f} ms a frame out "
                      f"with the RGB conversion", flush=True)
                continue
            per = {k: float(np.mean([ms[0] for kind, ms in stats if kind == k])) for k in "IPB"}
            pre = {"cabac": "decode_", "cavlc": "decode_cavlc_", "mbaff": "decode_mbaff_"}[coding]
            out.update({pre + "ms": float(np.mean(decode_ms)), pre + "i_ms": per["I"],
                        pre + "p_ms": per["P"], pre + "b_ms": per["B"]})
            tag = "" if coding == "cabac" else coding + "_"
            out[tag + "mbytes"] = len(data) / 1e6
            out[tag + "write_s"] = write_s
            print(f"    {coding.upper()}: {frames} frames out in the order {kinds} "
                  f"({len(data) / 1e6:.3f} MB, written in {write_s:.2f} s): decode I "
                  f"{per['I']:.2f} ms, P {per['P']:.2f}, B {per['B']:.2f} (each timed as it "
                  f"was decoded); {np.mean(decode_ms):.2f} ms a frame out with the RGB "
                  f"conversion", flush=True)
            if first is None:
                first = imgs
            elif coding == "cavlc" and not all(np.array_equal(a, b) for a, b in zip(imgs, first)):
                raise AssertionError("the CAVLC stream's frames are not the CABAC stream's")
        out.update(check_mpeg4_host_times(size, frames))
        resize_ms, write_ms = [], []
        for i, img in enumerate(first):
            t0 = time.perf_counter()
            small = resample.resize(img, target, "lanczos")
            resize_ms.append(1e3 * (time.perf_counter() - t0))
            t0 = time.perf_counter()
            png.write_png(os.path.join(tmp, "%04d.png" % i), small)
            write_ms.append(1e3 * (time.perf_counter() - t0))
    out.update({"resize_ms": float(np.mean(resize_ms)), "png_ms": float(np.mean(write_ms))})
    print(f"    the same frames from both; LANCZOS to {target[0]}x{target[1]} "
          f"{out['resize_ms']:.2f} ms, PNG write {out['png_ms']:.2f} ms; decode_ms "
          + json.dumps({k: round(v, 3) for k, v in out.items() if k.startswith("decode")}))
    return out


def write_video_scene(root, dev, video_size=VIDEO_SIZE, target=(1352, 1014)) -> list:
    """A DyNeRF scene of videos only: :func:`write_dynerf_scene`'s
    ``poses_bounds.npy`` and point cloud for ``target`` frames, and
    ``VIDEO_SCENE_CAMS`` videos ``cam00.mp4…`` of ``VIDEO_SCENE_FRAMES``
    pictures at ``video_size`` (the first an MPEG-4 Part 2 stream of I and P
    VOPs, :func:`mpeg4_video`; the others H.264, :func:`row_video`, a seed a
    camera, an I/P field pair then MBAFF P and B frames coded with CABAC)
    and no ``cam*/images``. Returns the videos' paths."""
    write_dynerf_scene(root, dev, n_frames=0, size=target, n_cams=VIDEO_SCENE_CAMS)
    paths = []
    for ci in range(VIDEO_SCENE_CAMS):
        cam_dir = os.path.join(root, f"cam{ci:02d}")
        os.rmdir(os.path.join(cam_dir, "images"))
        os.rmdir(cam_dir)
        paths.append(cam_dir + ".mp4")
        with open(paths[-1], "wb") as f:
            f.write(mpeg4_video(video_size, VIDEO_SCENE_FRAMES, seed=2 * ci) if ci == 0 else
                    row_video(video_size, VIDEO_SCENE_FRAMES, seed=2 * ci, b_frames=2,
                              cavlc=False, fields=True, mbaff=True))
    return paths


def check_video_chain(dev, video_size=VIDEO_SIZE, schedule=VIDEO_SCHEDULE) -> dict:
    """Phase 18 (c) (module docstring): a scene of ``cam*.mp4`` only
    (:func:`write_video_scene`) loaded through ``load_dynerf_scene``, which
    extracts every camera's frames (each equal to the decode of its video
    resized with LANCZOS), then ``train_torch.py`` → ``render_torch.py`` →
    ``metrics_torch.py`` with the dynerf preset at full width
    (:func:`run_cli_chain`), K1 and K2's launches counted, then K1 and K2
    at a train step of its model (train view 0) against their plain
    versions (:func:`check_step_blend`). Returns the launches, the
    extraction's wall and that check's fields."""
    import torch

    import bench_quality_dynerf_torch as BD
    from fourdgs_tpu_torch.configs.core import load_config
    from fourdgs_tpu_torch.data import scene as tscene
    from fourdgs_tpu_torch.render import CameraArrays
    from fourdgs_tpu_torch.utils import losses, png, resample, video

    target = tscene.DYNERF_SIZE
    print(f"    (c) a DyNeRF scene of {VIDEO_SCENE_CAMS} cam*.mp4 at {video_size[0]}x"
          f"{video_size[1]} (camera 0 MPEG-4 Part 2 I and P VOPs, camera 1 a CABAC I/P field "
          f"pair then MBAFF P and B frames): load_scene "
          f"extracts, then the CLI chain", flush=True)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_video_scene_") as tmp:
        data_dir, model_path = os.path.join(tmp, "data"), os.path.join(tmp, "model")
        videos = write_video_scene(data_dir, dev, video_size, target)
        t0 = time.perf_counter()
        data = tscene.load_scene(load_config(), data_dir)
        extract_s = time.perf_counter() - t0
        for path in videos:
            img_dir = os.path.join(os.path.splitext(path)[0], "images")
            names = sorted(os.listdir(img_dir))
            frames = list(video.read_frames(path))
            if names != ["%04d.png" % i for i in range(len(frames))] or not frames:
                raise AssertionError(f"{img_dir}: {names}")
            for name, frame in zip(names, frames):
                if not np.array_equal(png.read_png(os.path.join(img_dir, name)),
                                      resample.resize(frame, target, "lanczos")):
                    raise AssertionError(f"{name}: not the resized decode of {path}")
        n_views = len(data.train_cameras) + len(data.test_cameras)
        cli = run_cli_chain(data_dir, model_path, dev, schedule, BD.PRESET)
        cfg, state = cli["cfg"], cli["state"]
        lc0 = cli["scene"].train_cameras[0]
        cam0 = lc0.camera
        bg = torch.ones(3, device=dev) if cfg.model.white_background else torch.zeros(3, device=dev)
        gt0 = torch.tensor(lc0.image(), device=dev).to(torch.float32).permute(2, 0, 1) / 255.0
        fwd_args, bwd_args = step_blend_inputs(
            cfg, state, CameraArrays.from_camera(cam0, device=dev), cam0.width, cam0.height,
            losses.tile_image(gt0, pad_cols=2), bg, state.active_sh_degree, dev)
        trained = check_step_blend(
            fwd_args, bwd_args, dev,
            f"train view 0 of the model of the extracted scene ({cam0.width}x{cam0.height}, "
            f"capacity {state.alive.shape[0]}, {int(state.alive.sum())} alive, SH degree "
            f"{state.active_sh_degree})")
    renders = cli["steps"] * cli["batch_size"]
    on_card = int(dev.type == "cuda")
    (k1_train, k2_train), (k1_render, _) = cli["train_launches"], cli["render_launches"]
    pf = cli["prefetch"]
    print(f"    extraction in load_scene {extract_s:.3f} s ({n_views} frames at {target[0]}x"
          f"{target[1]}, each the resized decode of its video); train wall "
          f"{cli['train_s']:.3f} s ({cli['steps']} steps, batch {cli['batch_size']}, "
          f"{cli['points']} points), held-out PSNR {cli['psnr']:.4f} dB; prefetcher "
          f"{json.dumps(pf)}; K1/K2 launches train {cli['train_launches']}, render "
          f"{cli['render_launches']}")
    if n_views != VIDEO_SCENE_CAMS * VIDEO_SCENE_FRAMES:
        raise AssertionError(f"{n_views} views for {VIDEO_SCENE_CAMS} cameras x "
                             f"{VIDEO_SCENE_FRAMES} frames")
    if pf["submitted"] != renders or pf["native"] != renders or pf["to_ref"]:
        raise AssertionError(f"the prefetcher decoded {pf}, expected {renders} natively")
    if ((k2_train, k1_train) != (on_card * renders, on_card * (renders + cli["eval_renders"]))
            or k1_render != on_card * (cli["test_views"] + 1)):
        raise AssertionError(f"CLI launches: train {cli['train_launches']}, render "
                             f"{cli['render_launches']}")
    return {"cli": (k1_train + k1_render, k2_train), "blend": trained,
            "extract_s": extract_s, "psnr": cli["psnr"]}


def check_video_extraction(dev) -> tuple:
    """Phase 18 (module docstring): (a) the committed H.264 and MPEG-4
    streams (the MPEG-4 decoder built in a thread while the H.264 one
    builds), (b) the host's times, (c) the scene of videos through the CLI
    chain. Returns (b)'s and (c)'s results."""
    import threading

    from fourdgs_tpu_torch.utils import video

    mpeg4_build = threading.Thread(target=video.get_lib, args=("mpeg4",))
    mpeg4_build.start()
    check_h264_fixtures()
    mpeg4_build.join()
    check_mpeg4_fixtures()
    return check_video_host_times(), check_video_chain(dev)


TIMELINE_TIMES = 10                # phase 16 (a)'s timestamps
VIEWER_MESH_SCHEDULE = ("opt.coarse_iterations=3", "opt.iterations=3",
                        "opt.position_lr_max_steps=3", "tpu.capacity_init=2048")
VIEWER_FRAMES = 3                  # phase 16 (c)'s frames, one before each coarse step
# phase 16 (d): 20 + 60 steps, cut to 10 + 30 (densifying at 5, 15 and 25)
# to pay for phase 18
SPREAD_SCHEDULE = ("opt.coarse_iterations=10", "opt.iterations=30",
                   "opt.position_lr_max_steps=30", "opt.densify_from_iter=5",
                   "opt.densification_interval=10", "tpu.capacity_init=2048")


def check_gradient_timeline(dev, data_dir, model_path, n_times=TIMELINE_TIMES):
    """Phase 16 (a) (module docstring): ``python -m
    fourdgs_tpu_torch.scripts.gradient_from_checkpoint`` on phase 10 (b)'s
    fine checkpoint and scene, K1 and K2 once per timestamp, finite records;
    then K1 and K2 against their plain versions at the timeline's shapes
    (the checkpoint's state at train camera 0 and the last timestamp, the
    timeline's L1 cotangent). Returns the launches, the wall and
    :func:`check_step_blend`'s fields."""
    import torch

    from fourdgs_tpu_torch import render as TR
    from fourdgs_tpu_torch.configs.core import config_from_dict
    from fourdgs_tpu_torch.data.scene import load_scene
    from fourdgs_tpu_torch.ops import blend
    from fourdgs_tpu_torch.scripts import gradient_from_checkpoint
    from fourdgs_tpu_torch.train import checkpoint
    from fourdgs_tpu_torch.utils import losses

    ckpt = checkpoint.find_stage_checkpoint(model_path, "fine")
    print(f"[16] the repairs and the last entry points: (a) gradient_from_checkpoint on "
          f"{os.path.basename(ckpt)}", flush=True)
    blend.blend_forward.launches = blend.blend_backward.launches = 0
    t0 = time.perf_counter()
    json_path, png_path = gradient_from_checkpoint.main([
        "--checkpoint", ckpt, "-s", data_dir, "--n_times", str(n_times),
        "--device", dev.type])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (blend.blend_forward.launches, blend.blend_backward.launches)
    with open(json_path) as f:
        records = json.load(f)
    print(f"    {n_times} timestamps in {wall:.3f} s (the scene's load included); K1/K2 "
          f"launches {launches}; loss {records[0]['loss']:.6f} (t = 0) .. "
          f"{records[-1]['loss']:.6f} (t = 1), |grad xyz| max "
          f"{max(r['grad_norm_max'] for r in records):.4g}, {records[0]['n_points']} "
          f"points; panel grid {'written' if png_path else 'skipped (no matplotlib)'}")
    on_card = int(dev.type == "cuda")
    if launches != (on_card * n_times, on_card * n_times):
        raise AssertionError(f"the timeline launched K1/K2 {launches} times over "
                             f"{n_times} timestamps")
    if len(records) != n_times or not all(
            math.isfinite(r[k]) for r in records
            for k in ("loss", "grad_norm_mean", "grad_norm_max")):
        raise AssertionError(f"the timeline's records: {records}")

    with open(os.path.join(model_path, "cfg_args.json")) as f:
        cfg = config_from_dict(json.load(f))
    cfg.opt.batch_size = 1          # the timeline's L1 is the mean over one image
    state, _, _ = checkpoint.load_checkpoint(ckpt, cfg, device=dev)
    lc = load_scene(cfg, data_dir).train_cameras[0]
    gt = torch.tensor(np.asarray(lc.image), device=dev).to(torch.float32).permute(
        2, 0, 1) / 255.0
    cam = TR.CameraArrays.from_camera(lc.camera, device=dev)
    cam = cam._replace(time=torch.full_like(cam.time, 1.0))
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.model.white_background else [0.0, 0.0, 0.0],
                      device=dev)
    res = check_step_blend(
        *step_blend_inputs(cfg, state, cam, lc.camera.width, lc.camera.height,
                           losses.tile_image(gt[:3], pad_cols=2), bg,
                           state.active_sh_degree, dev), dev,
        f"the timeline's last timestamp (capacity {state.alive.shape[0]}, "
        f"{int(state.alive.sum())} alive, SH degree {state.active_sh_degree})")
    return {"launches": launches, "wall_s": wall, "blend": res}


def viewer_cli_rank(data_dir: str, model_path: str, port: int) -> dict:
    """One rank of phase 16 (c): ``train_torch.main`` with ``--mesh
    data=1,model=2 --shard_primitives --port`` (the first rank serving the
    viewer) and ``--distributed --device cuda:0`` in the world this process
    opened (gloo)."""
    import torch

    import bench_quality_torch as BQ
    import train_torch
    from fourdgs_tpu_torch.data import scene as tscene
    from fourdgs_tpu_torch.ops import blend

    tscene.TARGET_SIZE = (WIDTH, HEIGHT)
    blend.blend_forward.launches = blend.blend_backward.launches = 0
    t0 = time.perf_counter()
    state, opt = train_torch.main([
        "-s", data_dir, "--configs", BQ.PRESET, "--model_path", model_path, "--quiet",
        "--test_iterations", "-1", "--save_iterations", "-1", "--port", str(port),
        "--mesh", "data=1,model=2", "--shard_primitives", "--distributed",
        "--device", "cuda:0", "--override", *VIEWER_MESH_SCHEDULE])
    torch.cuda.synchronize()
    return {"launches": (blend.blend_forward.launches, blend.blend_backward.launches),
            "hash": _state_hash(state, opt), "train_s": time.perf_counter() - t0}


def check_viewer_under_mesh(dev, data_dir):
    """Phase 16 (c) (module docstring): two ranks sharing the card over gloo
    train with ``--mesh data=1,model=2 --shard_primitives --port``; a SIBR
    client asks for train camera 0 before each of the first coarse steps.
    The first frame (the initial state, gathered from the two ranks' halves)
    must equal this process's render of the state ``build_scene`` makes
    from the same seed, bit for bit; the later ones must be frames of the
    trained state. Returns the frames' count and the wall."""
    import threading

    import torch

    from fourdgs_tpu_torch.configs.core import config_from_dict, load_config
    from fourdgs_tpu_torch.data.scene import build_scene, load_scene
    from fourdgs_tpu_torch.parallel.launch import run_ranks
    from fourdgs_tpu_torch.render import CameraArrays, render

    print("    (c) the viewer under --mesh data=1,model=2 --shard_primitives, two ranks "
          "sharing the card over gloo", flush=True)
    cam = load_scene(load_config(), data_dir).train_cameras[0].camera
    port = free_port()
    result: dict = {}
    client = threading.Thread(target=sibr_client, daemon=True, args=(
        port, [(cam, False)] * VIEWER_FRAMES, result, 600.0))
    client.start()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_viewer_mesh_") as tmp:
        ranks = run_ranks("chip_smoke:viewer_cli_rank", 2,
                          dict(data_dir=data_dir, model_path=os.path.join(tmp, "model"),
                               port=port),
                          os.path.join(tmp, "ranks"), backend="gloo", timeout=600, threads=4)
        with open(os.path.join(tmp, "model", "cfg_args.json")) as f:   # what it trained
            cfg = config_from_dict(json.load(f))
    wall = time.perf_counter() - t0
    client.join(timeout=60)
    if "error" in result or len(result.get("frames", [])) != VIEWER_FRAMES:
        raise AssertionError(f"the SIBR client: {result.get('error')}, "
                             f"{len(result.get('frames', []))} frames")
    # the state the first frame shows: train_torch's build_scene with its
    # default seed (6666), rendered here in one process
    state = build_scene(cfg, 6666, device=dev).state
    vcam = cam._replace(camera_center=np.linalg.inv(
        np.asarray(cam.world_view, np.float64)).T[:3, 3].astype(np.float32))
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.model.white_background else [0.0, 0.0, 0.0],
                      device=dev)
    with torch.no_grad():
        color = render(state.params, state, CameraArrays.from_camera(vcam, device=dev),
                       cfg, cam.width, cam.height, "coarse", bg, state.active_sh_degree,
                       device=dev).color
    want = (np.clip(color.cpu().numpy(), 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)
    frames = result["frames"]
    diff = int(np.abs(frames[0].astype(int) - want.astype(int)).max())
    moved = int(np.abs(frames[-1].astype(int) - frames[0].astype(int)).max())
    print(f"    {len(frames)} frames of {cam.width}x{cam.height} served by rank 0, the "
          f"primitives gathered from both ranks for each; the first against this "
          f"process's render of the seeded initial state: max {diff} levels; the last "
          f"{moved} levels from the first; ranks' states equal "
          f"{ranks[0]['hash'] == ranks[1]['hash']}; K1/K2 launches by rank "
          f"{[r['launches'] for r in ranks]}; {wall:.1f} s")
    if diff or not moved or ranks[0]["hash"] != ranks[1]["hash"]:
        raise AssertionError(f"(c) the served frame differs by {diff} levels, the last "
                             f"moved {moved}, or the ranks' states differ")
    if result["verify"] != [data_dir] * VIEWER_FRAMES:
        raise AssertionError(f"(c) verify strings {result['verify']}")
    steps = sum(int(o.split("=")[1]) for o in VIEWER_MESH_SCHEDULE[:2])
    on_card = int(dev.type == "cuda")
    if [r["launches"] for r in ranks] != [(on_card * (steps + VIEWER_FRAMES), on_card * steps),
                                          (on_card * steps, on_card * steps)]:
        raise AssertionError(f"(c) K1/K2 launches by rank {[r['launches'] for r in ranks]}: "
                             f"a step each, and rank 0 a render per frame")
    return {"frames": len(frames), "wall_s": wall,
            "launches": [r["launches"] for r in ranks]}


def check_seed_spread(dev, data_dir):
    """Phase 16 (d) (module docstring): ``train_torch.py`` twice on phase
    10 (b)'s scene with ``SPREAD_SCHEDULE`` (10 + 30 steps) and one
    ``--seed`` (its default): both held-out PSNRs (its last eval) and
    whether the two trained states are equal bit for bit. Returns them."""
    import bench_quality_torch as BQ
    import train_torch

    print("    (d) the same CLI schedule twice with one seed", flush=True)
    iters = next(int(o.split("=")[1]) for o in SPREAD_SCHEDULE
                 if o.startswith("opt.iterations="))
    runs = []
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_spread_") as tmp:
        for i in range(2):
            model_path = os.path.join(tmp, f"run{i}")
            t0 = time.perf_counter()
            state, opt = train_torch.main([
                "-s", data_dir, "--configs", BQ.PRESET, "--model_path", model_path,
                "--quiet", "--test_iterations", str(iters), "--save_iterations", "-1",
                "--device", dev.type, "--override", *SPREAD_SCHEDULE])
            train_s = time.perf_counter() - t0
            with open(os.path.join(model_path, "eval_log.jsonl")) as f:
                last = [json.loads(line) for line in f][-1]
            runs.append({"psnr": last["test"]["psnr"], "points": int(state.alive.sum()),
                         "hash": _state_hash(state, opt), "train_s": train_s})
            del state, opt
    bit_equal = runs[0]["hash"] == runs[1]["hash"]
    print(f"    {' + '.join(o.split('=')[1] for o in SPREAD_SCHEDULE[:2])} steps twice, "
          f"--seed 6666: held-out PSNR {runs[0]['psnr']:.4f} and {runs[1]['psnr']:.4f} dB "
          f"({runs[0]['points']} and {runs[1]['points']} points); trained states and Adam "
          f"moments bit-equal {bit_equal}; train wall {runs[0]['train_s']:.1f} and "
          f"{runs[1]['train_s']:.1f} s")
    if not all(math.isfinite(r["psnr"]) for r in runs):
        raise AssertionError(f"(d) PSNR {[r['psnr'] for r in runs]}")
    return {"psnr": [r["psnr"] for r in runs], "points": [r["points"] for r in runs],
            "bit_equal": bit_equal}


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
    """bench.py's scene: 60,000 live Gaussians in ``cfg.tpu.capacity`` rows
    (65,536 here), positions
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
    }, cfg.tpu.capacity)
    alive = np.arange(cfg.tpu.capacity) < n
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
    from fourdgs_tpu_torch import scripts
    from fourdgs_tpu_torch.scripts import time_ms
    from fourdgs_tpu_torch.train import checkpoint

    t_script = time.perf_counter()
    dev = torch.device("cuda")
    card = scripts.card()
    print("[1] card (nvidia-smi name, power.limit):")
    print(card)
    print(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[2] kernel build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(sorted(libs))})")
    for stem, log in _build.build_logs.items():
        for kernel, line in ptxas_report(log):
            print(f"    {stem} {kernel}: {line}")
            if "iota_px_kernel" in kernel and "Used" in line and (
                    "smem" in line or "used 0 barriers" not in line):
                raise AssertionError(f"K9 should use no shared memory and no barrier: {line}")
    print(f"    resident blocks per SM: K1 {blend.blocks_per_sm('blend_forward')}, "
          f"K2 {blend.blocks_per_sm('blend_backward')}")

    # -- 3. K1 against its plain version on synthetic edge cases
    feat, starts, stops, row_off, bg, gx = synthetic_blend_inputs(dev)
    out = blend.blend_forward(feat, starts, stops, row_off, bg, gx)
    torch.cuda.synchronize()
    ref = blend.blend_forward_plain(feat, starts, stops, row_off, bg, gx)
    syn = compare_blend(out, ref)
    print(f"[3] K1 vs plain, synthetic edge cases: {syn}")
    g_syn = torch.tensor(np.random.default_rng(1).uniform(-1, 1, tuple(out.shape)),
                         dtype=torch.float32, device=dev)
    d_k = blend.blend_backward(feat, starts, stops, row_off, bg, out, g_syn, gx)
    torch.cuda.synchronize()
    d_p = blend.blend_backward_plain(feat, starts, stops, row_off, bg, out, g_syn, gx)
    syn_work = blend_work(feat, starts, stops, row_off, gx)
    syn_b = compare_blend_backward(d_k, d_p, syn_work["instances"])
    print(f"    K2 vs plain, synthetic edge cases, random cotangent: {syn_b}")
    check_cull_exact(blend.blend_forward, feat, starts, stops, row_off, bg, gx)
    check_cull_exact(blend.blend_backward, feat, starts, stops, row_off, bg, out, g_syn, gx)
    print(f"    K1 and K2 with the cull equal their walk of every in-range "
          f"instance bit for bit, K2 twice the same bits, the kernels' strip masks "
          f"their plain mirror's; {work_line(syn_work)}")
    *edge, g_edge = cull_edge_inputs(dev)
    out_edge = blend.blend_forward(*edge)
    check_cull_exact(blend.blend_forward, *edge)
    check_cull_exact(blend.blend_backward, *edge[:5], out_edge, g_edge, edge[5])
    print(f"    the same on the cull's edge cases: {work_line(blend_work(*edge[:4], edge[5]))}")

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
    check_cull_exact(blend.blend_forward, *args)
    kernel_ms = time_ms(lambda: blend.blend_forward(*args), dev)[0]
    walk_ms = time_ms(lambda: blend.blend_forward(*args, _cull=False), dev)[0]
    plain_ms = time_ms(lambda: blend.blend_forward_plain(*args), dev, iters=1, reps=3)[0]
    work = blend_work(*args[:4], bi.grid_x)
    bound = blend_bound(work, bi.bins.tile_start.numel())
    print(f"    K1 at view {k_view} ({bi.bins.tile_start.numel()} tiles): kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound on reached pairs "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), kernel/bound "
          f"{kernel_ms / bound['bound_ms']:.2f}; on kept pairs "
          f"{bound['bound_kept_pairs_ms']:.4f} ms; on all in-range pairs "
          f"{bound['bound_all_pairs_ms']:.4f} ms; without the cull (test hook) "
          f"{walk_ms:.4f} ms")
    print(f"    {work_line(work)}")
    print(f"    {tile_lengths(args[1], args[2])}")
    print(f"    K1 vs plain at view {k_view}: {full}; the cull equals the walk of "
          f"every in-range instance bit for bit, the strip masks their plain mirror's")

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

    # -- 6. the fine-stage train step of the lego preset
    from fourdgs_tpu_torch.train import adam
    from fourdgs_tpu_torch.train.loop import make_train_step
    from fourdgs_tpu_torch.utils.losses import abs_, tile_image

    train_state = bench_scene(cfg, seed=0, device=dev)
    cam1 = TR.CameraArrays.from_camera(ring_camera(0, N_TIMED), device=dev)
    cams1 = TR.CameraArrays(*(x[None] for x in cam1))          # batch 1
    gt = tile_image(view(cam1, bench_scene(cfg, seed=1, device=dev)).color,
                    pad_cols=2)[None]                           # [1, T, 5, 256]
    step_fn = make_train_step(cfg, WIDTH, HEIGHT, "fine", cfg.model.sh_degree,
                              device=dev)
    params, opt = train_state.params, adam.init(train_state.params)
    K = -(-cfg.tpu.instance_budget // 128) * 128
    metrics = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    blend.blend_forward.launches = blend.blend_backward.launches = 0
    with torch.enable_grad():
        for it in range(1, N_WARM + 1):
            params, opt, train_state, m = step_fn(params, opt, train_state,
                                                  cams1, gt, it)
            metrics.append(m)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for it in range(N_WARM + 1, N_WARM + N_TIMED + 1):
            params, opt, train_state, m = step_fn(params, opt, train_state,
                                                  cams1, gt, it)
            metrics.append(m)
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    step_ms = elapsed * 1e3 / N_TIMED
    n_steps = N_WARM + N_TIMED
    train_launches = (blend.blend_forward.launches, blend.blend_backward.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m["loss"]) for m in metrics]
    n_rend = [int(m["num_rendered"]) for m in metrics]
    print(f"[6] train step {WIDTH}x{HEIGHT} lego fine stage, batch 1: "
          f"{N_TIMED} timed steps after {N_WARM} warm-up in {elapsed * 1e3:.3f} ms, "
          f"{elapsed * 1e3 / N_TIMED:.3f} ms/step, trained px/s "
          f"{WIDTH * HEIGHT * N_TIMED / elapsed:.1f}")
    print(f"    loss step 1 {losses[0]:.6f}, step {n_steps} {losses[-1]:.6f}; "
          f"psnr {float(metrics[0]['psnr']):.3f} -> {float(metrics[-1]['psnr']):.3f}; "
          f"num_rendered min/max {min(n_rend)}/{max(n_rend)}, K = {K}; "
          f"peak memory {peak_gib:.3f} GiB")
    print(f"    K1/K2 launches over {n_steps} steps: {train_launches}")
    if train_launches != (n_steps, n_steps):
        raise AssertionError(f"expected one K1 and one K2 launch per step, "
                             f"got {train_launches} over {n_steps} steps")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"loss not finite or not falling: {losses}")
    if max(n_rend) > K:
        raise AssertionError(f"instance demand {max(n_rend)} above the budget {K}")

    # K2 at the shapes and cotangent of the last step
    xyz, sc, rot, op, shs, _ = TR.activated_gaussians(params, train_state, cam1, "fine")
    bi = R.blend_inputs(xyz, sc, rot, op, shs, cam1.camera_center, cam1.world_view,
                        cam1.full_proj, cam1.tanfovx, cam1.tanfovy, WIDTH, HEIGHT,
                        cfg.model.sh_degree, cfg.tpu.instance_budget,
                        alive=train_state.alive)
    fwd_args = (bi.feat, bi.bins.tile_start, bi.bins.tile_stop, bi.row_off, bg_img)
    out5 = blend.blend_forward(*fwd_args, bi.grid_x)
    with torch.enable_grad():       # the tile-space L1's cotangent
        o = out5.clone().requires_grad_()
        diff = (o - gt[0]) * torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0], device=dev)[:, None]
        (g_out,) = torch.autograd.grad(abs_(diff).sum() / (3 * WIDTH * HEIGHT), o)
    bwd_args = (*fwd_args, out5, g_out, bi.grid_x)
    d_k = blend.blend_backward(*bwd_args)
    d_p = blend.blend_backward_plain(*bwd_args)
    bwd_work = blend_work(*fwd_args[:4], bi.grid_x)
    bwd_bound = blend_backward_bound(bwd_work, bi.bins.tile_start.numel(),
                                     bi.feat.shape[1])
    step_b = compare_blend_backward(d_k, d_p, bwd_work["instances"])
    check_cull_exact(blend.blend_forward, *fwd_args, bi.grid_x)
    check_cull_exact(blend.blend_backward, *bwd_args)
    bwd_ms = time_ms(lambda: blend.blend_backward(*bwd_args), dev)[0]
    bwd_walk_ms = time_ms(lambda: blend.blend_backward(*bwd_args, _cull=False), dev)[0]
    bwd_plain_ms = time_ms(lambda: blend.blend_backward_plain(*bwd_args), dev,
                           iters=1, reps=3)[0]
    print(f"    K2 at the last step ({bi.bins.tile_start.numel()} tiles): kernel "
          f"{bwd_ms:.4f} ms (with the wrapper's zeroing of dfeat), plain "
          f"{bwd_plain_ms:.4f} ms, bound on reached pairs {bwd_bound['bound_ms']:.4f} ms "
          f"({bwd_bound['bound_by']}), kernel/bound "
          f"{bwd_ms / bwd_bound['bound_ms']:.2f}; on kept pairs "
          f"{bwd_bound['bound_kept_pairs_ms']:.4f} ms; on all in-range pairs "
          f"{bwd_bound['bound_all_pairs_ms']:.4f} ms; without the cull (test hook) "
          f"{bwd_walk_ms:.4f} ms")
    print(f"    {work_line(bwd_work)}")
    print(f"    {tile_lengths(fwd_args[1], fwd_args[2])}")
    print(f"    K2 vs plain at the last step: {step_b}; K1 and K2 with the cull "
          f"equal their walk of every in-range instance bit for bit, the strip masks "
          f"their plain mirror's")
    P = xyz.shape[0]
    g1 = R.payload_grad(blend.blend_backward(*bwd_args), bi.bins, P)
    g2 = R.payload_grad(blend.blend_backward(*bwd_args), bi.bins, P)
    same_bits = bool(torch.equal(g1, g2)) and bool(torch.equal(d_k, blend.blend_backward(*bwd_args)))
    g_cpu = R.payload_grad(d_k.cpu(), type(bi.bins)(*(x.cpu() for x in bi.bins)), P)
    seg_err = float((g1.cpu() - g_cpu).abs().max() / g_cpu.abs().max())
    print(f"    per-Gaussian payload gradients of two backward passes "
          f"bit-identical = {same_bits}; against the CPU's segment sums: "
          f"max error / max |grad| = {seg_err:.3g}")
    if not same_bits:
        raise AssertionError("the payload gradients differ between two runs")
    if not seg_err <= 1e-5:
        raise AssertionError("the card's segment sums disagree with the CPU's")

    # -- 7. the cost experiments
    cost_kernels = check_cost_experiments(dev)

    # -- 9. training from a point cloud
    pcd, trained = check_training_from_pcd(dev)

    # phase 10 (b)'s D-NeRF scene, which phase 13 reuses
    scene_tmp = tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_scene_")
    dnerf_dir = os.path.join(scene_tmp.name, "bouncingballs")
    try:
        # -- 10. the user's entry points
        phase_s = {}
        t0 = time.perf_counter()
        entry = check_entry_points(dev, dnerf_dir, os.path.join(scene_tmp.name, "cli_model"))
        phase_s[10] = time.perf_counter() - t0

        # -- 11. the DyNeRF path
        t0 = time.perf_counter()
        dynerf = check_dynerf_path(dev)
        phase_s[11] = time.perf_counter() - t0

        # -- 12. the remaining loaders: HyperNeRF, then the JPEG ones
        t0 = time.perf_counter()
        hypernerf = check_hypernerf_path(dev)
        if not hypernerf["masked_psnr"] > hypernerf["blank_masked_psnr"]:
            raise AssertionError(f"masked held-out PSNR {hypernerf['masked_psnr']} not "
                                 f"above the blank image's {hypernerf['blank_masked_psnr']}")
        jpeg_path = check_jpeg_path(dev)
        phase_s[12] = time.perf_counter() - t0

        # -- 13. eval and tools
        t0 = time.perf_counter()
        tools = check_eval_tools(dev, dnerf_dir)
        phase_s[13] = time.perf_counter() - t0

        # -- 14. the remaining single-device options, at phase 4's view and
        #    phase 6's GT
        t0 = time.perf_counter()
        options = check_options(cfg, state, cams[k_view], gt, step_ms, dev)
        phase_s[14] = time.perf_counter() - t0

        # -- 15. the sharded trainer: phase 6's scene on a grid of ranks,
        #    the CLI on phase 10 (b)'s scene
        t0 = time.perf_counter()
        sharded = check_sharded_trainer(dev, dnerf_dir)
        phase_s[15] = time.perf_counter() - t0

        # -- 16. the repairs and the last entry points: the timeline of phase
        #    10 (b)'s checkpoint, the decoders, the viewer under sharded
        #    primitives, the seed's spread
        t0 = time.perf_counter()
        timeline = check_gradient_timeline(dev, dnerf_dir,
                                           os.path.join(scene_tmp.name, "cli_model"))
        check_decoders()
        viewer_mesh = check_viewer_under_mesh(dev, dnerf_dir)
        check_seed_spread(dev, dnerf_dir)
        phase_s[16] = time.perf_counter() - t0

        # -- 17. the rarer JPEG codings: the committed files and the
        #    1352x1014 picture in each, then the MultipleView chain on them
        t0 = time.perf_counter()
        check_rare_decoders()
        rare_chain = check_rare_chain(dev)
        phase_s[17] = time.perf_counter() - t0

        # -- 18. the DyNeRF video extraction: the committed H.264 and MPEG-4
        #    streams, the host's times per 2704x2028 frame, then a scene of
        #    videos through load_scene and the CLI chain (the MPEG-4 decoder
        #    builds while the H.264 one does)
        t0 = time.perf_counter()
        video_host, video_chain = check_video_extraction(dev)
        phase_s[18] = time.perf_counter() - t0
    finally:
        scene_tmp.cleanup()
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))

    # -- 8. kernels line, result line
    kernels = [{
        "name": "blend_forward",
        "route": "cuda",
        "source": "fourdgs_tpu_torch/csrc/blend_forward.cu",
        "replaces": "fourdgs_tpu/ops/pallas_blend.py:305",
        "launches": launches,
        "max_abs_err": full["max_abs_err"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"],
        "library_ms": None,   # no single PyTorch call computes this blend
        "bound_kept_pairs_ms": bound["bound_kept_pairs_ms"],
        "bound_all_pairs_ms": bound["bound_all_pairs_ms"],
        "gated_share": work["gated"] / work["in_range"],
        "train_from_pcd": {"launches": pcd["k1_launches"], **trained["blend_forward"]},
        "bench": {"launches": entry["bench"][0], **entry["bench_blend"]["blend_forward"]},
        "cli": {"launches": entry["cli"][0]},
        "dynerf": {"launches": dynerf["bench"][0], **dynerf["bench_blend"]["blend_forward"],
                   "padding": dynerf["padding"]},
        "dynerf_instant4d": {"launches": dynerf["instant4d"][0]},
        "dynerf_cli": {"launches": dynerf["cli"][0]},
        "hypernerf": {"launches": hypernerf["cli"][0], **hypernerf["blend"]["blend_forward"],
                      "padding": hypernerf["padding"]},
        "multipleview_cli": {"launches": jpeg_path["cli"][0]},
        "eval_tools": {"launches": tools["a"]["launches"][0],
                       "merge_launches": tools["c"]["launches"][0]},
        "ellipse_tile_cull": {
            "launches": options["a"]["on"]["launches"],
            "num_rendered": options["a"]["on"]["num_rendered"],
            "num_rendered_cull_off": options["a"]["off"]["num_rendered"],
            "ms": options["a"]["timing"]["on"]["k1_ms"],
            "ms_cull_off": options["a"]["timing"]["off"]["k1_ms"],
            "plain_ms": options["a"]["k1_plain_ms"],
            "max_abs_err": options["a"]["k1"]["max_abs_err"],
            **options["a"]["timing"]["on"]["k1_bound"]},
        "dssim_step": {"launches": options["b"]["launches"][0]},
        "sharded_step": {"launches": sharded["a"]["launches"][0],
                         **sharded["a"]["blend"]["blend_forward"]},
        "sharded_cli": {"launches": sharded["cli"]["launches"][0]},
        "gradient_timeline": {"launches": timeline["launches"][0],
                              **timeline["blend"]["blend_forward"]},
        "viewer_mesh": {"launches": viewer_mesh["launches"][0][0]},
        "multipleview_rare": {"launches": rare_chain["cli"][0],
                              **rare_chain["blend"]["blend_forward"]},
        "dynerf_video": {"launches": video_chain["cli"][0],
                         **video_chain["blend"]["blend_forward"],
                         "host_ms_per_frame": {k: video_host[k] for k in (
                             "decode_ms", "decode_i_ms", "decode_p_ms", "decode_b_ms",
                             "decode_cavlc_ms", "decode_cavlc_i_ms", "decode_cavlc_p_ms",
                             "decode_cavlc_b_ms", "decode_mbaff_ms", "decode_mbaff_i_ms",
                             "decode_mbaff_p_ms", "decode_mbaff_b_ms", "decode_mpeg4_ms",
                             "decode_mpeg4_i_ms", "decode_mpeg4_p_ms", "resize_ms",
                             "png_ms")}},
    }, {
        "name": "blend_backward",
        "route": "cuda",
        "source": "fourdgs_tpu_torch/csrc/blend_backward.cu",
        "replaces": "fourdgs_tpu/ops/pallas_blend.py:463",
        "launches": train_launches[1],
        "max_abs_err": step_b["max_abs_err"],
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
        "bound_ms": bwd_bound["bound_ms"],
        "bound_by": bwd_bound["bound_by"],
        "library_ms": None,   # no single PyTorch call computes this gradient
        "bound_kept_pairs_ms": bwd_bound["bound_kept_pairs_ms"],
        "bound_all_pairs_ms": bwd_bound["bound_all_pairs_ms"],
        "gated_share": bwd_work["gated"] / bwd_work["in_range"],
        "train_from_pcd": {"launches": pcd["k2_launches"], **trained["blend_backward"]},
        "bench": {"launches": entry["bench"][1], **entry["bench_blend"]["blend_backward"]},
        "cli": {"launches": entry["cli"][1]},
        "dynerf": {"launches": dynerf["bench"][1], **dynerf["bench_blend"]["blend_backward"]},
        "dynerf_instant4d": {"launches": dynerf["instant4d"][1]},
        "dynerf_cli": {"launches": dynerf["cli"][1]},
        "hypernerf": {"launches": hypernerf["cli"][1], **hypernerf["blend"]["blend_backward"]},
        "multipleview_cli": {"launches": jpeg_path["cli"][1]},
        "eval_tools": {"launches": tools["a"]["launches"][1]},
        "ellipse_tile_cull": {
            "ms": options["a"]["timing"]["on"]["k2_ms"],
            "ms_cull_off": options["a"]["timing"]["off"]["k2_ms"],
            "plain_ms": options["a"]["k2_plain_ms"],
            "max_abs_err": options["a"]["k2"]["max_abs_err"],
            **options["a"]["timing"]["on"]["k2_bound"]},
        "dssim_step": {"launches": options["b"]["launches"][1]},
        "sharded_step": {"launches": sharded["a"]["launches"][1],
                         **sharded["a"]["blend"]["blend_backward"]},
        "sharded_cli": {"launches": sharded["cli"]["launches"][1]},
        "gradient_timeline": {"launches": timeline["launches"][1],
                              **timeline["blend"]["blend_backward"]},
        "viewer_mesh": {"launches": viewer_mesh["launches"][0][1]},
        "multipleview_rare": {"launches": rare_chain["cli"][1],
                              **rare_chain["blend"]["blend_backward"]},
        "dynerf_video": {"launches": video_chain["cli"][1],
                         **video_chain["blend"]["blend_backward"]},
    }, *cost_kernels]
    print(f"chip_smoke.py took {time.perf_counter() - t_script:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
