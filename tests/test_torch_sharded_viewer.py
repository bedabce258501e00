"""The SIBR viewer under ``shard_primitives`` with ``model`` > 1: the
frames the first rank of a ``data=1, model=2`` grid of CPU gloo ranks
serves (gathering the sharded primitives for each) against a one-process
render of the same whole state, bit for bit (uint8).

JAX's one controller sees whole arrays and serves the frame
(``fourdgs_tpu/train/loop.py:573-582``); the port's ranks each hold half of
the primitives, so every rank learns that the first rank serves a viewer
and joins each gather it announces. The client (a thread of the first
rank, ``chip_smoke.sibr_client``) sends the first camera before each of
iterations 1–3 of a 4-iteration coarse stage on
``tests/test_torch_multihost.py``'s scene; the frame before iteration k
shows the state after iteration k − 1, which ``log_fn`` renders in the
first rank's process without the mesh. Both ranks end with equal states.
"""

import numpy as np

from fourdgs_tpu_torch.parallel.launch import run_ranks
from tests.test_torch_cli import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_multihost import LOOP_KW, LOOP_OVERRIDES, _loop_scene

ITERS = 4
# no densify, prune or reset inside the window: the state ``log_fn`` sees
# after iteration k is the one the next frame renders
OVERRIDES = {**LOOP_OVERRIDES, "opt.densify_from_iter": 1000,
             "opt.pruning_from_iter": 1000, "opt.opacity_reset_interval": 1000}


def test_gathered_frames_equal_a_one_process_render(tmp_path):
    cams, state_np = _loop_scene()
    ranks = run_ranks("tests.torch_parallel_ranks:viewer_with_mesh", 2,
                      dict(overrides=OVERRIDES, state_np=state_np, cams_np=cams,
                           iters=ITERS, **LOOP_KW),
                      str(tmp_path / "ranks"), timeout=300)
    first = ranks[0]
    logs = [(tmp_path / "ranks" / f"rank_{r}.log").read_text()[-2000:] for r in range(2)]
    both = "\n".join(f"--- rank {r} ---\n{log}" for r, log in enumerate(logs))
    assert first["error"] is None, f"{first['error']}\n{both}"
    assert len(first["frames"]) == len(first["renders"]) == ITERS - 1
    for k, (frame, want) in enumerate(zip(first["frames"], first["renders"])):
        assert frame.shape == want.shape == (32, 32, 3)
        np.testing.assert_array_equal(frame, want, err_msg=f"frame {k}")
    # the state moved between frames, so each frame is a render of its own
    assert not np.array_equal(first["frames"][0], first["frames"][-1])
    assert ranks[0]["hash"] == ranks[1]["hash"]
