"""Sharded self, pair and ray contact over a ``torch.distributed`` device
mesh (``sharding.py``), the counterpart of ``implicitbvh_tpu.parallel``.
As in the JAX package, the top-level package does not re-export these
names."""

from .sharding import (make_mesh, sharded_rays, sharded_rebuild_traverse_step,
                       sharded_self_contact, sharded_tile_pair,
                       sharded_tile_self_contact)

__all__ = ["make_mesh", "sharded_self_contact", "sharded_tile_self_contact",
           "sharded_tile_pair", "sharded_rays",
           "sharded_rebuild_traverse_step"]
