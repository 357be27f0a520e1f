"""Multi-rank dry run: the sharded codec on a small world (the port of
frave_tpu/parallel/dryrun.py).

    python -m frave_tpu_torch.parallel.dryrun [N] [--device cpu|cuda] [--backend gloo|nccl]

starts an N-rank world (world.launch; default 4 ranks, on the card, gloo:
several ranks share one card) and runs the JAX dry run's legs on tiny
shapes: a dp x tp grid encode with the halo ring, its dp decode, a tp
decode of a one-card container, the host (plain-version) decode of a
sharded container, and the parallel mode through the same paths.

run_legs is the ranks' target, here and wherever a world runs the sharded
codec on files (the tests, chip_smoke.py): each leg is a dict naming an op
and its inputs and outputs as .npy / .frv paths, so nothing but paths and
small results crosses between the processes.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import List

import numpy as np


def _opts(leg):
    from ..codec.options import EncoderOptions, EncoderQuality

    return EncoderOptions(mode=leg.get("mode", "grid"),
                          quality=EncoderQuality[leg.get("quality", "LOSSLESS")])


def _leg(mesh, leg: dict) -> dict:
    """Run one leg on this rank; returns its result (rank 0 writes the
    outputs)."""
    import torch

    from ..kernel_check import KERNELS, TP_KERNELS
    from ..ops import rans_torch as RT
    from .sharded import ShardedDecoder, ShardedEncoder, TPShardedDecoder

    op = leg["op"]
    rec = mesh.record()
    wrappers = {n: k[0] for n, k in {**KERNELS, **TP_KERNELS}.items()}
    for fn in wrappers.values():
        fn.launches = 0
    RT.decode_row.calls = 0
    res: dict = {"op": op}
    t0 = time.perf_counter()
    if op == "encode":
        batch = np.load(leg["images"])
        B, h, w, c = batch.shape
        enc = ShardedEncoder(height=h, width=w, channels=c, batch=B, mesh=mesh,
                             num_lanes=leg.get("num_lanes"), mode=leg.get("mode", "grid"))
        res["build_s"] = time.perf_counter() - t0
        if leg.get("planes"):  # this rank's analysis plane
            px, qdiv, tids = enc.inputs(batch, _opts(leg))[:3]
            plane = enc.planes(px, qdiv, tids).cpu().numpy()
            np.save(f"{leg['planes']}_{mesh.rank}.npy", plane)
            rec.clear()
        t1 = time.perf_counter()
        blobs = enc.encode_batch(batch, _opts(leg))
        res["encode_s"] = time.perf_counter() - t1
        res["halo"] = enc.halo_enabled
        res["nl"] = enc.nl
        if mesh.rank == 0:
            out = Path(leg["out"])
            out.mkdir(parents=True, exist_ok=True)
            for i, b in enumerate(blobs):
                (out / f"{i}.frv").write_bytes(b)
        res["sizes"] = [len(b) for b in blobs]
    elif op == "dp_decode":
        blobs = [Path(p).read_bytes() for p in leg["blobs"]]
        h, w, c = leg["shape"]
        dec = ShardedDecoder(height=h, width=w, channels=c, mesh=mesh)
        outs = dec.decode_batch(blobs)
        res["decode_s"] = time.perf_counter() - t0
        if mesh.rank == 0:
            np.save(leg["out"], np.stack([o.data for o in outs]))
    elif op == "tp_decode":
        blob = Path(leg["blob"]).read_bytes()
        h, w, c = leg["shape"]
        dec = TPShardedDecoder(height=h, width=w, channels=c, mesh=mesh)
        out = dec.decode(blob)
        res["decode_s"] = time.perf_counter() - t0
        if mesh.rank == 0:
            np.save(leg["out"], out.data)
        res["final_gptr"] = int(dec.final[1].cpu()[0])
    else:
        raise ValueError(f"unknown leg op {op!r}")
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    res["wall_s"] = time.perf_counter() - t0
    res["launches"] = {n: fn.launches for n, fn in wrappers.items()}
    res["plain_rows"] = RT.decode_row.calls
    mesh.barrier()  # rank 0's outputs are written before any rank reads them
    res["collectives"] = [(c.op, c.axis, c.shape, c.dtype, c.phase) for c in rec]
    res["collective_s"] = [c.seconds for c in rec]
    return res


def run_legs(legs: List[dict], dp: int, tp: int, device: str = "cuda") -> List[dict]:
    """A world's target: the legs in order on the (dp, tp) mesh of the
    world, tensors on `device`; returns each leg's result on this rank."""
    from .mesh import make_mesh

    mesh = make_mesh(dp, tp, device)
    return [_leg(mesh, leg) for leg in legs]


def run_dryrun(n_devices: int = 4, device: str = "cuda", backend: str = "gloo") -> dict:
    """The JAX dry run's legs on an n-rank world (tensors on `device`);
    raises if any output differs from its input. Returns the legs'
    results on rank 0."""
    import tempfile

    from .. import decode
    from .mesh import mesh_factorization
    from .world import launch
    from ..codec.encoder import encode

    dp, tp = mesh_factorization(n_devices)
    h = w = 32
    B = dp * 2  # two images per dp shard
    rng = np.random.default_rng(0)
    batch = rng.integers(0, 256, size=(B, h, w, 1), dtype=np.uint8)
    with tempfile.TemporaryDirectory(prefix="frave_dryrun_") as tmp:
        t = Path(tmp)
        np.save(t / "batch.npy", batch)
        from ..codec.options import EncoderOptions

        one = encode(batch[0], EncoderOptions(num_lanes=max(16, n_devices) * 8), device="cpu")
        (t / "one.frv").write_bytes(one)
        blobs = [str(t / "grid" / f"{i}.frv") for i in range(B)]
        pblobs = [str(t / "parallel" / f"{i}.frv") for i in range(B)]
        legs = [
            {"op": "encode", "images": str(t / "batch.npy"), "out": str(t / "grid")},
            {"op": "dp_decode", "blobs": blobs, "shape": (h, w, 1), "out": str(t / "dp.npy")},
            {"op": "tp_decode", "blob": str(t / "one.frv"), "shape": (h, w, 1),
             "out": str(t / "tp.npy")},
            {"op": "encode", "images": str(t / "batch.npy"), "out": str(t / "parallel"),
             "mode": "parallel"},
            {"op": "dp_decode", "blobs": pblobs, "shape": (h, w, 1), "out": str(t / "dpp.npy")},
        ]
        res = launch(n_devices, "frave_tpu_torch.parallel.dryrun:run_legs",
                     {"legs": legs, "dp": dp, "tp": tp}, backend=backend, device=device)
        np.testing.assert_array_equal(np.load(t / "dp.npy"), batch)
        np.testing.assert_array_equal(np.load(t / "tp.npy"), batch[0])
        np.testing.assert_array_equal(np.load(t / "dpp.npy"), batch)
        # the host oracle: the plain versions decode a sharded container
        out = decode(Path(blobs[0]).read_bytes(), device="cpu")
        np.testing.assert_array_equal(out.data, batch[0])
    return {"mesh": [dp, tp], "legs": res[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=4, help="ranks (default 4)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    a = ap.parse_args(argv)
    res = run_dryrun(a.n, a.device, a.backend)
    print(json.dumps({"ok": True, "mesh": res["mesh"],
                      "walls_s": [round(r["wall_s"], 3) for r in res["legs"]]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
