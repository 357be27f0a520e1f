"""Multi-host orchestration on torch.distributed: the port of
frave_tpu/parallel/multihost.py.

  * init_distributed initializes the world from explicit arguments or from
    torchrun's variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) and
    returns this process's rank (0 when single-host). Entropy-coded bytes
    are host data: the hosts meet only for orchestration.
  * CorpusRunner shards a corpus over hosts (round-robin over the sorted
    paths, by rank), encodes shape-bucketed batches through the one-card
    batch pipeline (or, given a mesh, the dp x tp ShardedEncoder) and
    writes one .frv an image: the host-side bitstream mux.
  * Progress goes to a JSON manifest a host after every batch (a temporary
    file and an atomic rename), so a stopped run resumes where it was; a
    failed batch is retried once and then recorded as failed instead of
    stopping the run.
  * merged_manifest gathers the hosts' manifests for corpus-level stats.

Images are read as .npy always and in PIL's formats where PIL imports (the
port's CLI loader); an image that cannot be read is recorded as failed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None,
                     backend: str = "gloo") -> int:
    """Initialize the torch.distributed world if a multi-process setup is
    requested, explicitly (coordinator_address "host:port") or by
    torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK; the caller
    names the backend (gloo, or nccl with one card a process). Returns the
    rank (0 when single-host)."""
    import torch.distributed as dist

    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address and num_processes and num_processes > 1:
        if not dist.is_initialized():
            dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                    world_size=num_processes, rank=process_id or 0)
        return dist.get_rank()
    return 0


def _world():
    """(size, rank) of the initialized world, or (1, 0)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclasses.dataclass
class CorpusRunner:
    """Shard-encode a corpus with checkpoint and resume.

    num_processes / process_id default to the initialized world's size and
    rank (1 and 0 without one) and may be passed explicitly (the tests
    simulate hosts so). `mesh` (parallel.mesh.Mesh, optional) routes each
    shape bucket through the dp x tp ShardedEncoder, one encoder cached a
    (shape, batch, mode): every rank of the mesh runs the same corpus
    shard, and the mesh's rank 0 writes the outputs and the manifest.
    `device` is where the one-card pipeline runs."""

    output_dir: str
    manifest_dir: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    batch_size: int = 8
    max_retries: int = 1
    mesh: Optional[object] = None
    device: str = "cuda"

    def __post_init__(self):
        size, rank = _world()
        if self.num_processes is None:
            self.num_processes = size
        if self.process_id is None:
            self.process_id = rank
        self.manifest_dir = self.manifest_dir or self.output_dir
        Path(self.output_dir).mkdir(parents=True, exist_ok=True)
        Path(self.manifest_dir).mkdir(parents=True, exist_ok=True)
        self._sharded_cache: Dict[tuple, object] = {}

    # ---------------- sharded (dp x tp) encode ----------------
    def _encode_sharded(self, imgs, opts) -> List[bytes]:
        """Encode one shape bucket through the dp x tp ShardedEncoder, built
        for a fixed global batch B (a multiple of the mesh's dp); short
        chunks are padded by repeating the first image and the padded
        outputs dropped."""
        import numpy as np

        from .sharded import ShardedEncoder

        h, w, c = imgs[0].data.shape
        dp = self.mesh.shape["dp"]
        B = -(-max(self.batch_size, 1) // dp) * dp
        key = (h, w, c, B, opts.mode)
        enc = self._sharded_cache.get(key)
        if enc is None:
            enc = ShardedEncoder(height=h, width=w, channels=c, batch=B, mesh=self.mesh,
                                 mode=opts.mode)
            self._sharded_cache[key] = enc
        out: List[bytes] = []
        for i in range(0, len(imgs), B):
            chunk = imgs[i : i + B]
            arrs = [im.data for im in chunk]
            while len(arrs) < B:
                arrs.append(arrs[0])
            out.extend(enc.encode_batch(np.stack(arrs), opts)[: len(chunk)])
        return out

    # ---------------- manifest ----------------
    @property
    def manifest_path(self) -> Path:
        return Path(self.manifest_dir) / f"manifest_host{self.process_id}.json"

    def _load_manifest(self) -> Dict:
        p = self.manifest_path
        if p.exists():
            try:
                return json.loads(p.read_text())
            except (OSError, json.JSONDecodeError):
                pass
        return {"host": self.process_id, "entries": {}}

    def _save_manifest(self, manifest: Dict) -> None:
        if self.mesh is not None and self.mesh.rank != 0:
            return
        p = self.manifest_path
        fd, tmp = tempfile.mkstemp(dir=str(p.parent), prefix=p.name)
        with os.fdopen(fd, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, p)  # atomic

    # ---------------- sharding ----------------
    def my_shard(self, files: Sequence[str]) -> List[str]:
        """Deterministic round-robin over the SORTED corpus, so every host
        agrees on the assignment without communication."""
        ordered = sorted(str(f) for f in files)
        return ordered[self.process_id :: self.num_processes]

    # ---------------- run ----------------
    def run(self, files: Sequence[str], opts=None) -> Dict:
        """Encode this host's shard; returns the final manifest."""
        from ..cli.main import _load_image
        from ..codec.container import serialize
        from ..codec.options import EncoderOptions
        from ..codec.pipeline_torch import encode_pipeline_torch_batch

        opts = opts or EncoderOptions()
        if self.mesh is not None:
            self.mesh.barrier()  # every rank reads the manifest its rank 0 wrote
        manifest = self._load_manifest()
        entries = manifest["entries"]
        shard = [f for f in self.my_shard(files) if entries.get(f, {}).get("status") != "done"]

        # bucket by shape and colorspace, so a batch shares one program
        buckets: Dict[tuple, List[str]] = defaultdict(list)
        for fp in shard:
            try:
                im = _load_image(fp)
                buckets[im.data.shape].append(fp)
            except Exception as e:
                entries[fp] = {"status": "failed", "error": f"read: {e}"}
        self._save_manifest(manifest)

        for _, paths in sorted(buckets.items()):
            for i in range(0, len(paths), self.batch_size):
                chunk = paths[i : i + self.batch_size]
                imgs = [_load_image(fp) for fp in chunk]
                blobs = None
                for attempt in range(self.max_retries + 1):
                    try:
                        if self.mesh is not None:
                            blobs = self._encode_sharded(imgs, opts)
                        else:
                            blobs = [serialize(c) for c in
                                     encode_pipeline_torch_batch(imgs, opts, self.device)]
                        break
                    except Exception as e:
                        if attempt >= self.max_retries:
                            for fp in chunk:
                                entries[fp] = {"status": "failed", "error": str(e)}
                if blobs is None:
                    self._save_manifest(manifest)
                    continue
                for fp, blob, img in zip(chunk, blobs, imgs):
                    out = Path(self.output_dir) / (Path(fp).stem + ".frv")
                    if self.mesh is None or self.mesh.rank == 0:
                        out.write_bytes(blob)
                    entries[fp] = {
                        "status": "done",
                        "frif_bytes": len(blob),
                        "raw_bytes": int(img.data.size),
                        "output": str(out),
                        "ts": time.time(),
                    }
                self._save_manifest(manifest)
        if self.mesh is not None:
            self.mesh.barrier()
        return manifest


def merged_manifest(manifest_dir: str) -> Dict:
    """Host-side gather of all per-host manifests (corpus-level stats)."""
    merged: Dict = {"entries": {}, "hosts": []}
    for p in sorted(Path(manifest_dir).glob("manifest_host*.json")):
        m = json.loads(p.read_text())
        merged["hosts"].append(m.get("host"))
        merged["entries"].update(m.get("entries", {}))
    done = [e for e in merged["entries"].values() if e.get("status") == "done"]
    merged["num_done"] = len(done)
    merged["num_failed"] = len(merged["entries"]) - len(done)
    merged["total_raw_bytes"] = sum(e.get("raw_bytes", 0) for e in done)
    merged["total_frif_bytes"] = sum(e.get("frif_bytes", 0) for e in done)
    return merged


def run_corpus(corpus_dir: str, output_dir: str, batch_size: int = 4, device: str = "cuda",
               hosts: int = 0, dp: int = 0, tp: int = 0, mode: str = "grid") -> dict:
    """A world's target: CorpusRunner over the images of corpus_dir (.npy,
    and PIL's formats). hosts 0: this rank is one host of the live world;
    hosts > 0: simulated hosts 0 .. hosts - 1 one after another, each
    through the (dp, tp) mesh of the whole world (every rank takes part).
    Returns {"rank", "world", "done" (a host), "ts" (each entry's time
    stamp), "cached" (whether the mesh route ran), "run_s"}."""
    from ..cli.main import PIL_EXTS
    from ..codec.options import EncoderOptions
    from .mesh import make_mesh

    exts = set(PIL_EXTS) | {".npy"}
    files = sorted(str(p) for p in Path(corpus_dir).iterdir() if p.suffix.lower() in exts)
    opts = EncoderOptions(mode=mode)
    t = time.perf_counter()
    if hosts:
        mesh = make_mesh(dp, tp, device)
        runners = [CorpusRunner(output_dir=output_dir, num_processes=hosts, process_id=h,
                                batch_size=batch_size, mesh=mesh, device=device)
                   for h in range(hosts)]
    else:
        runners = [CorpusRunner(output_dir=output_dir, batch_size=batch_size, device=device)]
    done, ts, cached = [], {}, []
    for r in runners:
        entries = r.run(files, opts)["entries"]
        done.append(sum(e["status"] == "done" for e in entries.values()))
        ts.update({k: e.get("ts") for k, e in entries.items()})
        cached.append(bool(r._sharded_cache))
    size, rank = _world()
    return {"rank": rank, "world": size, "done": done, "ts": ts, "cached": cached,
            "run_s": time.perf_counter() - t}
