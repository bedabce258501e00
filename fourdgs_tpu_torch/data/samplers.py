"""Camera-batch samplers.

The port's copy of ``fourdgs_tpu/data/samplers.py:19-51`` (JAX-free, copied
so the port imports nothing of the JAX package).

Parity target: utils/loader_utils.py in the reference:

- get_stamp_list (loader_utils.py:10-16): all cameras at a given timestamp,
  used for the zerostamp_init coarse stage (train.py:101-107) — assumes a
  camera-major, frame-minor ordering (frame_length frames per pose).
- FineSampler (loader_utils.py:23-52): temporally-correlated epoch ordering —
  for each frame index, 4 random permutations of the camera poses, with 2
  random replayed past indices injected after every 2 draws (the "replay"
  stabilizes the fine stage on multi-view video).
"""

from __future__ import annotations

import random as pyrandom


def get_stamp_list(n_cameras: int, n_poses: int, timestamp: int) -> list[int]:
    """Indices of all cameras at `timestamp` (camera-major layout)."""
    frame_length = n_cameras // n_poses
    if timestamp > frame_length:
        raise IndexError("input timestamp bigger than total timestamp.")
    return [i * frame_length + timestamp for i in range(n_poses)]


def fine_sampler_order(
    n_cameras: int, n_poses: int, rng: pyrandom.Random
) -> list[int]:
    """One FineSampler epoch of camera indices (loader_utils.py:27-48).

    Note: the reference builds 4 permutations per frame but (due to its own
    loop structure) only appends the last one; reproduced faithfully.
    """
    frame_length = n_cameras // n_poses
    sample_list: list[int] = []
    for i in range(frame_length):
        now_list: list[int] = []
        for _ in range(4):
            perm = list(range(n_poses))
            rng.shuffle(perm)
            idx = [p * frame_length + i for p in perm]
            now_list = []
            cnt = 0
            for item in idx:
                now_list.append(item)
                cnt += 1
                if cnt % 2 == 0 and len(sample_list) > 2:
                    now_list += rng.sample(sample_list, 2)
        sample_list += now_list
    return sample_list
