"""The sharded codec on torch.distributed (the port of frave_tpu/parallel):

  * dp — a batch of images over the mesh's dp axis;
  * tp — the fractal tiles, schedule slices and rANS lanes of one image
    over its tp axis: float64 Gram partials and histograms summed over tp,
    cross-band taps shipped by halo rings of point-to-point sends;
  * tp decode — one image's lanes over every rank, one kernel launch a
    row (3T) or step (DT) and a collective between;
  * multi-host — torch.distributed init, corpus shards a host with
    checkpoint and resume, and the host-side bitstream mux.

Ranks are processes of a torch.distributed world (world.launch starts one
on a host); mesh.make_mesh lays out (dp, tp) over its ranks.
"""

from .mesh import Mesh, make_mesh, mesh_factorization
from .sharded import ShardedDecoder, ShardedEncoder, TPShardedDecoder

__all__ = ["Mesh", "make_mesh", "mesh_factorization", "ShardedEncoder", "ShardedDecoder",
           "TPShardedDecoder"]
