"""Start the ranks of a world on one host and join them.

:func:`spawn` starts commands as processes and waits for all of them
within a time limit; a rank that fails or outlives the limit stops every
process it started, and the call raises with each one's last output.
:func:`run_ranks` runs ``module:function(**kwargs)`` as the ranks of a
fresh world (a file store in ``workdir`` for the rendezvous), each in a
process of its own started with ``python -m fourdgs_tpu_torch.parallel.launch``,
and returns what each rank's function returned.
"""

from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import time
from datetime import timedelta

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + 10.0
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _tail(path: str | None, n: int = 4000) -> str:
    if path is None or not os.path.exists(path):
        return "(output not kept)"
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        f.seek(max(f.tell() - n, 0))
        return f.read().decode(errors="replace")


def spawn(commands: list[list[str]], timeout: float | None, log_dir: str,
          envs: list[dict] | None = None, cwd: str | None = None,
          inherit_first: bool = False) -> list[str]:
    """Run ``commands`` at once and wait for every one to exit 0 within
    ``timeout`` seconds (None: no limit). Output goes to
    ``log_dir/rank_<i>.log``, or, for the first with ``inherit_first``, to
    this process's. Returns the logs' paths (None for an inherited one)."""
    os.makedirs(log_dir, exist_ok=True)
    logs, files, procs = [], [], []
    try:
        for i, cmd in enumerate(commands):
            env = dict(os.environ, **(envs[i] if envs else {}))
            if inherit_first and i == 0:
                logs.append(None)
                procs.append(subprocess.Popen(cmd, env=env, cwd=cwd))
                continue
            path = os.path.join(log_dir, f"rank_{i}.log")
            f = open(path, "wb")
            files.append(f)
            logs.append(path)
            procs.append(subprocess.Popen(cmd, env=env, cwd=cwd, stdout=f,
                                          stderr=subprocess.STDOUT))
        start = time.monotonic()
        while True:
            codes = [p.poll() for p in procs]
            failed = [i for i, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                why = f"rank {failed[0]} exited with code {codes[failed[0]]}"
                break
            if all(c == 0 for c in codes):
                return logs
            if timeout is not None and time.monotonic() - start > timeout:
                why = f"ranks still running after {timeout:.0f} s"
                break
            time.sleep(0.05)
        _stop(procs)
        tails = "\n".join(f"--- rank {i} (exit {p.returncode}) ---\n{_tail(logs[i])}"
                          for i, p in enumerate(procs))
        raise RuntimeError(f"{why}; every rank stopped\n{tails}")
    finally:
        _stop(procs)
        for f in files:
            f.close()


def run_ranks(target: str, world: int, kwargs: dict, workdir: str,
              backend: str = "gloo", timeout: float = 600.0, threads: int = 1) -> list:
    """``target`` (``"module:function"``) called with ``kwargs`` in each of
    ``world`` new processes, the ranks of a world whose default group uses
    ``backend``; returns the ranks' results in rank order. ``threads``:
    ``torch.set_num_threads`` in each rank. The processes import the target
    from the repository's root."""
    os.makedirs(workdir, exist_ok=True)
    spec = os.path.join(workdir, "spec.pkl")
    with open(spec, "wb") as f:
        pickle.dump({"target": target, "world": world, "backend": backend,
                     "kwargs": kwargs, "threads": threads,
                     "store": os.path.join(workdir, "store")}, f)
    cmds = [[sys.executable, "-m", "fourdgs_tpu_torch.parallel.launch", workdir, str(r)]
            for r in range(world)]
    local = [dict(LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world)) for r in range(world)]
    spawn(cmds, timeout, workdir, envs=local, cwd=ROOT)
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"result_{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(workdir: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    with open(os.path.join(workdir, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(spec["threads"])
    dist.init_process_group(spec["backend"], init_method=f"file://{spec['store']}",
                            rank=rank, world_size=spec["world"],
                            timeout=timedelta(seconds=600))
    module, _, name = spec["target"].partition(":")
    result = getattr(importlib.import_module(module), name)(**spec["kwargs"])
    with open(os.path.join(workdir, f"result_{rank}.pkl.tmp"), "wb") as f:
        pickle.dump(result, f)
    os.replace(os.path.join(workdir, f"result_{rank}.pkl.tmp"),
               os.path.join(workdir, f"result_{rank}.pkl"))
    # every rank done with its collectives before any closes its connections
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
