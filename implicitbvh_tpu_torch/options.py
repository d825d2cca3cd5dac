"""BVHOptions — the frozen configuration object.

Counterpart of ``implicitbvh_tpu/options.py``.  Torch has int64 on every
device, so ``index_bits=64`` needs no guard like the JAX package's
``jax_enable_x64`` check.
"""

from __future__ import annotations

import dataclasses

import torch

from .morton import DefaultMortonAlgorithm, MortonAlgorithm


@dataclasses.dataclass(frozen=True)
class BVHOptions:
    """Options for building and traversing BVHs.

    - ``index_bits``: width of the user indices and skips (32 or 64).
    - ``morton``: the Morton encoding algorithm object.
    - ``capacity_growth``: factor by which the traversal wrappers grow an
      overflowing buffer before re-running.
    - ``min_capacity``: smallest contact-buffer capacity.
    - ``block_size``, ``num_threads`` and the four ``min_*_per_thread``
      fields: the reference's GPU block size and CPU threading knobs,
      accepted as the JAX package accepts them (positive, else
      ``ValueError``) and otherwise ignored: the kernels size their own
      grids.
    """

    index_bits: int = 32
    morton: MortonAlgorithm = DefaultMortonAlgorithm(bits=32)
    capacity_growth: float = 2.0
    min_capacity: int = 64
    block_size: int = 256
    num_threads: int = 1
    min_mortons_per_thread: int = 100
    min_sorts_per_thread: int = 100
    min_boundings_per_thread: int = 100
    min_traversals_per_thread: int = 100

    def __post_init__(self):
        if self.index_bits not in (32, 64):
            raise ValueError("index_bits must be 32 or 64")
        if self.capacity_growth <= 1.0:
            raise ValueError("capacity_growth must be > 1")
        if self.min_capacity <= 0 or self.block_size <= 0:
            raise ValueError("min_capacity and block_size must be positive")
        for f in ("num_threads", "min_mortons_per_thread",
                  "min_sorts_per_thread", "min_boundings_per_thread",
                  "min_traversals_per_thread"):
            if getattr(self, f) <= 0:
                raise ValueError(f"{f} must be positive")

    @property
    def index_dtype(self):
        return torch.int64 if self.index_bits == 64 else torch.int32


DEFAULT_OPTIONS = BVHOptions()
