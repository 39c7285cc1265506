"""Batched and sharded execution over the frame axis (port of
vcf_tpu/parallel).

A `Mesh` is a tuple of torch devices, one per shard, with an optional
`torch.distributed` process group; `BatchCodec` codes a batch of frames on
one device or sharded over a mesh, and `parallel.dist` holds the
collectives (process start-up, psum, broadcast, the ordered stream
gather) over Gloo or NCCL.
"""

from vcf_tpu_torch.parallel.mesh import (BatchCodec, Mesh, make_mesh,
                                         shard_batch)

__all__ = ["Mesh", "make_mesh", "shard_batch", "BatchCodec"]
