"""Start an n-rank torch.distributed world of fresh processes.

    results = launch(n, "frave_tpu_torch.parallel.dryrun:run_legs",
                     {"legs": ..., "dp": ..., "tp": ...}, backend="gloo", device="cpu")

Each rank is a new interpreter (`python -m frave_tpu_torch.parallel.world
DIR RANK`) that imports only the port: the target is a function of the
port, named "module:function", called with the keyword arguments given
and the world's `device` (they and its return value cross as pickles in
DIR, a temporary directory). The ranks meet through a file:// store in DIR, never a fixed
TCP port, so several worlds can start at once on one host. The ranks run
on the card unless the caller asks for the CPU (device="cpu"): a child on
the card takes device rank % device_count (every rank the one card of a
one-card machine: the world must then be gloo, as NCCL refuses two ranks
on one GPU), and fails where CUDA is not available; a child on the CPU
runs torch with one thread. A child's
exception fails the launch with its traceback, and the other ranks are
stopped; nothing is swallowed.
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parent.parent.parent  # the directory holding the package


def launch(n: int, target: str, kwargs: Optional[dict] = None, backend: str = "gloo",
           device: str = "cuda", timeout: float = 600.0, env: Optional[dict] = None) -> List:
    """Run target(**kwargs, device=device) on every rank of a new n-rank
    world with `backend`, each rank's tensors on `device` ("cuda", the
    default, or "cpu": the one place the device is named, so kwargs name
    none); returns the ranks' return values in rank order. Raises
    RuntimeError with every failed rank's traceback (or its exit code) if
    any rank fails, and TimeoutError after `timeout` seconds; either way
    every child is stopped first."""
    if n < 1:
        raise ValueError(f"a world needs at least one rank, got {n}")
    if kwargs and "device" in kwargs:
        raise ValueError("launch gives the target its device: name it in launch(device=...), "
                         "not in the target's keyword arguments")
    _split(target)
    tmp = Path(tempfile.mkdtemp(prefix="frave_world_"))
    try:
        with open(tmp / "spec.pkl", "wb") as f:
            pickle.dump({"target": target, "kwargs": {**(kwargs or {}), "device": device},
                         "backend": backend,
                         "device": device, "world": n, "timeout": timeout}, f)
        child_env = dict(os.environ if env is None else env)
        child_env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + [p for p in child_env.get("PYTHONPATH", "").split(os.pathsep) if p])
        procs = []
        for r in range(n):
            with open(tmp / f"log_{r}.txt", "wb") as log:  # a pipe could fill and block
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "frave_tpu_torch.parallel.world", str(tmp), str(r)],
                    env=child_env, cwd=str(ROOT), stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        try:
            while True:
                codes = [p.poll() for p in procs]
                if all(c == 0 for c in codes) or any(c not in (None, 0) for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"world of {n} running {target} passed {timeout} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        failed = []
        for r, p in enumerate(procs):
            err = tmp / f"error_{r}.txt"
            if err.exists():
                failed.append(f"rank {r}:\n{err.read_text()}")
            elif p.returncode != 0:
                tail = (tmp / f"log_{r}.txt").read_text(errors="replace")[-2000:]
                failed.append(f"rank {r}: exit code {p.returncode}\n{tail}")
        if failed:
            raise RuntimeError(f"world of {n} running {target} failed:\n" + "\n".join(failed))
        out = []
        for r in range(n):
            with open(tmp / f"result_{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _split(target: str):
    """"module:function" -> (module, function); raises ValueError unless
    the module is the port's."""
    mod, _, name = target.partition(":")
    if not mod.startswith("frave_tpu_torch.") or not name:
        raise ValueError(f"a world's target is a function of the port, not {target!r}")
    return mod, name


def resolve(target: str):
    """"module:function" -> the function."""
    mod, name = _split(target)
    return getattr(importlib.import_module(mod), name)


def _child(tmp: Path, rank: int) -> int:
    import torch
    import torch.distributed as dist

    try:
        with open(tmp / "spec.pkl", "rb") as f:
            spec = pickle.load(f)
        if spec["device"] == "cpu":
            torch.set_num_threads(1)
        elif not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank} was asked for device {spec['device']!r}, but CUDA "
                               "is not available (pass device='cpu' for a CPU world)")
        else:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            spec["backend"], init_method=f"file://{tmp / 'store'}", world_size=spec["world"],
            rank=rank, timeout=datetime.timedelta(seconds=spec["timeout"]),
        )
        try:
            result = resolve(spec["target"])(**spec["kwargs"])
            dist.barrier()
        finally:
            dist.destroy_process_group()
        with open(tmp / f"result_{rank}.pkl.tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp / f"result_{rank}.pkl.tmp", tmp / f"result_{rank}.pkl")
        return 0
    except BaseException:
        (tmp / f"error_{rank}.txt").write_text(traceback.format_exc())
        return 1


if __name__ == "__main__":
    sys.exit(_child(Path(sys.argv[1]), int(sys.argv[2])))
