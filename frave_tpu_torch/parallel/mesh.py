"""Process-group meshes on torch.distributed: the port of
frave_tpu/parallel/mesh.py.

A JAX Mesh is a grid of devices inside one program; here it is a grid of
the ranks of an initialized torch.distributed world, row-major as JAX lays
out its devices: world rank r sits at (dp, tp) = divmod(r, tp). make_mesh
builds the dp and tp process groups (every rank builds every group, in the
same order, as torch.distributed requires) and the Mesh carries the
collectives the sharded codec issues:

  * sum — all_reduce(SUM) over an axis (lax.psum);
  * all_gather / gather — over an axis, stacked on a new leading axis
    (lax.all_gather, and the host's fetch of a sharded output);
  * ring — one halo ring: every rank sends to (r + d) % tp and receives
    from (r - d) % tp within its tp group, as batch_isend_irecv of
    P2POps (lax.ppermute);
  * all_gather_object — host objects (the containers) over the world.

The caller names the backend when it initializes the world. NCCL needs one
card per rank; several ranks on one card need gloo (NCCL refuses two ranks
on one GPU). Gloo takes CUDA tensors only in all_reduce and broadcast, so
on a gloo mesh every other collective of a CUDA tensor is STAGED: copied
to a pinned host buffer, run on the host, and copied back (Mesh._staged).
That is the design of a gloo mesh on a card, not a fallback: nothing
retries on another backend.

A Mesh can record every collective it issues (Mesh.record(): op, shape,
dtype, group, the phase named by Mesh.phase and the call's wall seconds,
the staging copies included), so tests can hold the traffic to the JAX
design and a run can read what each exchange costs. Recording costs a
clock read and a list append a collective; nothing when off.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("dp", "tp", "world")


def mesh_factorization(n: int) -> Tuple[int, int]:
    """Split n devices into (dp, tp): the largest power-of-two dp <= sqrt(n)
    that divides n, remainder to tp (tile/lane axis gets the larger share —
    intra-image collectives ride the faster contiguous axis)."""
    dp = 1
    while dp * 2 <= n // (dp * 2) and n % (dp * 2) == 0:
        dp *= 2
    return dp, n // dp


@dataclasses.dataclass(frozen=True)
class Collective:
    """One recorded collective: the op, the group axis, the local tensor's
    shape and dtype, the phase it ran in and its wall seconds."""

    op: str
    axis: str
    shape: Tuple[int, ...]
    dtype: str
    phase: str
    seconds: float


class Mesh:
    """The (dp, tp) grid of an initialized world, with its groups and
    collectives. Build with make_mesh."""

    def __init__(self, dp: int, tp: int, device, backend: str, groups: dict):
        self.dp, self.tp = dp, tp
        self.size = dp * tp
        self.rank = dist.get_rank()
        self.dp_index, self.tp_index = divmod(self.rank, tp)
        self.device = torch.device(device)
        self.backend = backend
        self._groups = groups  # axis -> this rank's process group (None: the world)
        self.shape = {"dp": dp, "tp": tp}
        self._records: Optional[List[Collective]] = None
        self._phase = ""

    # ---------------------------------------------------------------- record
    def record(self) -> List[Collective]:
        """Start recording (or clear the record): returns the list every
        collective from now on is appended to."""
        self._records = []
        return self._records

    @contextlib.contextmanager
    def phase(self, name: str):
        """Name the phase of the collectives issued inside the block."""
        prev, self._phase = self._phase, name
        try:
            yield
        finally:
            self._phase = prev

    @contextlib.contextmanager
    def _note(self, op: str, axis: str, t):
        """Record the collective run inside the block (when recording)."""
        if self._records is None:
            yield
            return
        t0 = time.perf_counter()
        yield
        shape = tuple(t.shape) if isinstance(t, torch.Tensor) else ()
        dtype = str(t.dtype).replace("torch.", "") if isinstance(t, torch.Tensor) else "object"
        self._records.append(Collective(op, axis, shape, dtype, self._phase,
                                        time.perf_counter() - t0))

    # ---------------------------------------------------------------- groups
    def group(self, axis: str):
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r}")
        return self._groups[axis]

    def axis_size(self, axis: str) -> int:
        return {"dp": self.dp, "tp": self.tp, "world": self.size}[axis]

    def axis_index(self, axis: str) -> int:
        return {"dp": self.dp_index, "tp": self.tp_index, "world": self.rank}[axis]

    def global_rank(self, axis: str, index: int) -> int:
        """The world rank of member `index` of this rank's group on `axis`."""
        g = self.group(axis)
        return index if g is None else dist.get_global_rank(g, index)

    def _staged(self, t: torch.Tensor) -> bool:
        """Whether a collective of t other than all_reduce / broadcast goes
        through a pinned host buffer: a CUDA tensor on a gloo mesh."""
        return self.backend == "gloo" and t.is_cuda

    @staticmethod
    def _host(t: torch.Tensor) -> torch.Tensor:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        return h

    # ---------------------------------------------------------------- collectives
    def sum(self, t: torch.Tensor, axis: str = "tp") -> torch.Tensor:
        """all_reduce(SUM) of t over `axis`, in place; returns t."""
        with self._note("all_reduce", axis, t):
            if self.axis_size(axis) > 1:
                dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group(axis))
        return t

    def sum_many(self, *ts: torch.Tensor, axis: str = "tp"):
        """sum of several tensors of one dtype in ONE all_reduce (flattened
        and joined); returns the summed tensors."""
        flat = torch.cat([t.reshape(-1) for t in ts])
        self.sum(flat, axis)
        out, o = [], 0
        for t in ts:
            out.append(flat[o:o + t.numel()].reshape(t.shape))
            o += t.numel()
        return tuple(out)

    def all_gather(self, t: torch.Tensor, axis: str = "tp") -> torch.Tensor:
        """Every member's t (one shape on all) stacked [n, *t.shape] in group
        order, on t's device."""
        with self._note("all_gather", axis, t):
            n = self.axis_size(axis)
            t = t.contiguous()
            if n == 1:
                return t[None].clone()
            src = self._host(t) if self._staged(t) else t
            outs = [torch.empty_like(src) for _ in range(n)]
            dist.all_gather(outs, src, group=self.group(axis))
            out = torch.stack(outs)
            return out.to(t.device) if out.device != t.device else out

    def gather(self, t: torch.Tensor, axis: str = "tp", dst: int = 0) -> Optional[torch.Tensor]:
        """Every member's t stacked [n, *t.shape] on member `dst` of the
        group, None on the others."""
        with self._note("gather", axis, t):
            n = self.axis_size(axis)
            t = t.contiguous()
            if n == 1:
                return t[None].clone()
            src = self._host(t) if self._staged(t) else t
            mine = self.axis_index(axis) == dst
            outs = [torch.empty_like(src) for _ in range(n)] if mine else None
            dist.gather(src, outs, dst=self.global_rank(axis, dst), group=self.group(axis))
            if not mine:
                return None
            out = torch.stack(outs)
            return out.to(t.device) if out.device != t.device else out

    def ring(self, t: torch.Tensor, delta: int, axis: str = "tp") -> torch.Tensor:
        """One halo ring: send t to member (i + delta) % n of the group and
        return what member (i - delta) % n sent (same shape and dtype), as
        one batch_isend_irecv of two P2POps."""
        with self._note("ring", axis, t):
            n = self.axis_size(axis)
            i = self.axis_index(axis)
            t = t.contiguous()
            if delta % n == 0:
                return t.clone()
            src = self._host(t) if self._staged(t) else t
            recv = torch.empty_like(src)
            g = self.group(axis)
            ops = [
                dist.P2POp(dist.isend, src, self.global_rank(axis, (i + delta) % n), g),
                dist.P2POp(dist.irecv, recv, self.global_rank(axis, (i - delta) % n), g),
            ]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            return recv.to(t.device) if recv.device != t.device else recv

    def all_gather_object(self, obj, axis: str = "world") -> list:
        """Every member's picklable obj, in group order."""
        with self._note("all_gather_object", axis, obj):
            out = [None] * self.axis_size(axis)
            dist.all_gather_object(out, obj, group=self.group(axis))
            return out

    def barrier(self) -> None:
        dist.barrier()


def make_mesh(dp: Optional[int] = None, tp: Optional[int] = None, device="cuda",
              backend: Optional[str] = None) -> Mesh:
    """The (dp, tp) mesh of the initialized world (dp * tp = its size;
    either or both may be left out: mesh_factorization of the size, or the
    size over the one given). `backend` must be the world's (default: the
    world's); `device` is where this rank's tensors live ("cuda": the
    current CUDA device)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed world")
    n = dist.get_world_size()
    if dp is None and tp is None:
        dp, tp = mesh_factorization(n)
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    if dp * tp != n:
        raise ValueError(f"mesh ({dp}, {tp}) does not cover a world of {n}")
    world_backend = dist.get_backend()
    backend = backend or world_backend
    if backend != world_backend:
        raise ValueError(f"the world runs {world_backend}, not {backend}")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but torch.cuda.is_available() is false")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    groups = {"world": None}
    # every rank creates every group, in one order
    for i in range(dp):
        g = dist.new_group(list(range(i * tp, (i + 1) * tp)))
        if rank // tp == i:
            groups["tp"] = g
    for j in range(tp):
        g = dist.new_group(list(range(j, n, tp)))
        if rank % tp == j:
            groups["dp"] = g
    return Mesh(dp, tp, dev, backend, groups)
