"""Hand-written CUDA kernels of the build (T1), of the tile engine (B1-B6,
the ray query's phase 1, R1, and the leader packing, L1), with their plain
versions, and of the walks (W1, W2), whose plain versions are the traverse
layer's torch-op loops."""

from .. import tracing
from .compaction import (compact_flat, compact_flat_plain, finish_compact,
                         tile_compact, tile_compact_plain)
from .grouping import leader_group, leader_group_plain
from .subtile import (ray_band_bits, ray_band_bits_plain, subtile_band_bits,
                      subtile_band_bits_plain)
from .tile_contact import (emit_plan, emit_plan_plain, run_live_pairs,
                           tile_group_contacts,
                           tile_group_contacts_plain,
                           tile_group_emit, tile_group_emit_plain,
                           tile_pair_contacts, tile_pair_contacts_plain,
                           tile_run_counts, tile_run_counts_plain)
from .tree_build import tree_build, tree_build_plain
from .walk import dfs_lanes, walk_lanes

KERNELS = (subtile_band_bits, tile_run_counts, tile_group_emit,
           tile_group_contacts, tile_compact, tile_pair_contacts,
           compact_flat, emit_plan, walk_lanes, dfs_lanes, ray_band_bits,
           leader_group, tree_build)


def reset_launch_counts():
    """Set every kernel wrapper's launch count to 0."""
    tracing.reset("launches.")


def launch_count(kernel) -> int:
    """Launches of the kernel wrapper ``kernel`` (one of ``KERNELS``) since
    the last :func:`reset_launch_counts`: the counter
    ``launches.<name>`` of ``tracing``."""
    return tracing.counter("launches." + kernel.__name__)


__all__ = ["KERNELS", "compact_flat", "compact_flat_plain", "dfs_lanes",
           "emit_plan",
           "emit_plan_plain", "finish_compact", "launch_count",
           "leader_group", "leader_group_plain",
           "ray_band_bits", "ray_band_bits_plain", "reset_launch_counts",
           "run_live_pairs", "subtile_band_bits", "subtile_band_bits_plain",
           "tile_compact", "tile_compact_plain", "tile_group_contacts",
           "tile_group_contacts_plain", "tile_group_emit",
           "tile_group_emit_plain", "tile_pair_contacts",
           "tile_pair_contacts_plain", "tile_run_counts",
           "tile_run_counts_plain", "tree_build", "tree_build_plain",
           "walk_lanes"]
