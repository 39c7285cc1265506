"""Batched execution over the frame axis (port of vcf_tpu/parallel; the
one-device part).

vcf_tpu shards frames over a `jax.sharding.Mesh`; the port codes a
batch of frames as one tensor on one torch device.  The mesh, sharding
and the distribution layer wait for ROADMAP A15.
"""

from vcf_tpu_torch.parallel.mesh import BatchCodec

__all__ = ["BatchCodec"]
