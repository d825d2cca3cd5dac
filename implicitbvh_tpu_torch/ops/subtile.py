"""Sub-band bits: the CUDA kernels and their plain PyTorch versions.

- B1 ``subtile_band_bits``, phase 1b of self-contact and of the two-tree
  query.  Replaces ``implicitbvh_tpu/ops/subtile.py:subtile_band_bits``
  (``_bits_kernel``).  For every live supertile pair ``p`` the result
  holds, for a-tile ``si[p]*32+i`` and b-tile ``sj[p]*32+j``, an NB-bit
  word whose bit ``r`` is set iff sub-band ``r`` of the a-tile overlaps the
  b-tile's AABB.  The count kernel skips the dead bands, and ``bits > 0``
  is the pair filter.  The kernel (``csrc/band_bits.cu``) is bound by bytes
  on the H100: a persistent grid of warps, one slot per warp, 16-byte
  stores.
- R1 ``ray_band_bits``, phase 1 of the tile ray query: for every (ray tile,
  leaf tile) an NB-bit word whose bit ``r`` is set iff a ray of sub-band
  ``r`` of the ray tile hits the leaf tile's AABB.  The JAX package has no
  Pallas kernel for it (``implicitbvh_tpu/traverse/ray_tiles.py:
  _ray_tile_hits`` is jnp, fused by XLA).  The kernel
  (``csrc/ray_band_bits.cu``) is bound by the instruction rate: one block a
  ray tile and chunk of leaf tiles, the rays in shared memory, a thread's
  leaf tiles in registers, no reduction across threads.

The values are float32 or float64, both inputs of one type, and the kernels
are templates on it.
"""

from __future__ import annotations

import torch

from .. import tracing
from ..volumes import _ray_box_test, _reciprocal
from . import _build

SS = 32  # tiles per supertile
_HIT_CHUNK = 1 << 24  # ray x leaf-tile slab tests per batch of the plain R1


def subtile_band_bits_plain(sub, tiles, si, sj, nsp, *, triangle=True):
    """Plain PyTorch version of :func:`subtile_band_bits`."""
    SP_cap = si.shape[0]
    _, Ta, NB = sub.shape
    Tb = tiles.shape[1]
    ar = torch.arange(SS, device=si.device)
    tii = si.long()[:, None] * SS + ar                       # (SP, SS)
    tjj = sj.long()[:, None] * SS + ar
    a = sub[:, tii.clamp(max=Ta - 1)]                        # (6, SP, SS, NB)
    b = tiles[:, tjj.clamp(max=Tb - 1)][:, :, None, :, None]  # (6, SP, 1, SS, 1)
    a = a[:, :, :, None, :]                                  # (6, SP, SS, 1, NB)
    ov = (a[3] >= b[0]) & (a[0] <= b[3])
    ov &= (a[4] >= b[1]) & (a[1] <= b[4])
    ov &= (a[5] >= b[2]) & (a[2] <= b[5])                    # (SP, SS, SS, NB)
    weights = 1 << torch.arange(NB, device=si.device, dtype=torch.int32)
    bits = (ov.int() * weights).sum(-1, dtype=torch.int32)
    valid = (tii < Ta)[:, :, None] & (tjj < Tb)[:, None, :]
    valid &= (torch.arange(SP_cap, device=si.device) < nsp)[:, None, None]
    if triangle:
        valid &= tii[:, :, None] <= tjj[:, None, :]
    return torch.where(valid, bits, 0)


def subtile_band_bits(sub, tiles, si, sj, nsp, *, triangle=True):
    """Band-bit words for every candidate supertile pair.

    - ``sub``: (6, Ta, NB) float32 or float64 sub-band bounds of the a
      side, rows ``lo0, lo1, lo2, up0, up1, up2``; NB in {4, 8, 16}.
    - ``tiles``: (6, Tb) tile bounds of the b side, same rows and dtype
      (the caller widens a float32 side against a float64 one).
    - ``si``/``sj``: (SP_cap,) int32 supertile rows/columns.
    - ``nsp``: (1,) int32 number of live slots (read on the device).

    Returns ``(SP_cap, 32, 32)`` int32; entries past ``Ta``/``Tb``, below
    the diagonal under ``triangle``, or in slots ``>= nsp`` are 0.

    Replaces ``implicitbvh_tpu/ops/subtile.py:subtile_band_bits``
    (``_bits_kernel``).  On the H100 it is bound by bytes;
    ``csrc/band_bits.cu`` runs a persistent grid of warps, one slot per
    warp, each lane storing 4 columns of a row as one ``int4``, and writes
    only the 32 live columns of each row.
    """
    dev = sub.device
    value_bits = _build.check_values(sub, "sub")
    if sub.dim() != 3 or sub.shape[0] != 6 or sub.shape[2] not in (4, 8, 16):
        raise ValueError(f"sub must be (6, Ta, 4|8|16), got {tuple(sub.shape)}")
    _build.check_values(tiles, "tiles", like=sub, device=dev)
    if tiles.dim() != 2 or tiles.shape[0] != 6:
        raise ValueError(f"tiles must be (6, Tb), got {tuple(tiles.shape)}")
    SP_cap = si.shape[0]
    _build.check(si, "si", torch.int32, (SP_cap,), dev)
    _build.check(sj, "sj", torch.int32, (SP_cap,), dev)
    _build.check(nsp, "nsp", torch.int32, (1,), dev)
    if not _build.cuda_device(sub):
        return subtile_band_bits_plain(sub, tiles, si, sj, nsp,
                                       triangle=triangle)
    P, I = _build.P, _build.I
    fn = _build.kernel_fn("band_bits", "band_bits_launch",
                          [P] * 6 + [I] * 6 + [P])
    out = torch.empty((SP_cap, SS, SS), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _build.launch(fn, "band_bits", sub.data_ptr(), tiles.data_ptr(),
                      si.data_ptr(), sj.data_ptr(), nsp.data_ptr(),
                      out.data_ptr(), SP_cap, sub.shape[1], tiles.shape[1],
                      sub.shape[2], int(triangle), value_bits)
    tracing.count("launches.subtile_band_bits")
    return out


def ray_band_bits_plain(rfields, tiles, NB: int = 4):
    """Plain PyTorch version of :func:`ray_band_bits`, batched over ray
    tiles, ``_HIT_CHUNK`` slab tests at a time."""
    _, RT, G = rfields.shape
    T = tiles.shape[1]
    BH = G // NB
    lo, up = tiles[:3, None, :], tiles[3:, None, :]            # (3, 1, T)
    wts = (1 << torch.arange(NB, device=rfields.device)).view(1, NB, 1)
    step = max(1, _HIT_CHUNK // (G * T))
    out = []
    for r0 in range(0, RT, step):
        blk = rfields[:, r0:r0 + step].reshape(6, -1, 1)       # (6, C*G, 1)
        hit = _ray_box_test(blk[:3], _reciprocal(blk[3:]), lo, up)
        hb = hit.view(-1, NB, BH, T).any(2)                    # (C, NB, T)
        out.append((hb * wts).sum(1, dtype=torch.int32))
    return torch.cat(out)


def ray_band_bits(rfields, tiles, NB: int = 4):
    """(RT, T) int32 band bits of phase 1 of the tile ray query.

    - ``rfields``: (6, RT, G) float32 or float64 ray tiles, rows ``p0, p1,
      p2, d0, d1, d2``, NaN-padded past the last ray; G a multiple of 32 up
      to 1024.
    - ``tiles``: (6, T) leaf-tile bounds ``lo0, lo1, lo2, up0, up1, up2``,
      same dtype and device.
    - ``NB``: sub-bands of a ray tile, 4, 8 or 16 (G/NB rays each).

    Bit ``r`` of entry ``(rt, t)`` is set iff a ray of sub-band ``r`` of ray
    tile ``rt`` hits the AABB of leaf tile ``t`` (the slab test of
    ``volumes.isintersection``).  A CUDA tensor takes one launch of
    ``csrc/ray_band_bits.cu``, a CPU tensor the plain version; both give
    the same bits.
    """
    dev = rfields.device
    value_bits = _build.check_values(rfields, "rfields")
    if rfields.dim() != 3 or rfields.shape[0] != 6:
        raise ValueError(f"rfields must be (6, RT, G), got "
                         f"{tuple(rfields.shape)}")
    RT, G = rfields.shape[1], rfields.shape[2]
    if G % 32 or not 0 < G <= 1024:
        raise ValueError(f"tile size {G} must be a multiple of 32, <= 1024")
    if NB not in (4, 8, 16):
        raise ValueError(f"NB must be 4, 8 or 16, got {NB}")
    _build.check_values(tiles, "tiles", like=rfields, device=dev)
    if tiles.dim() != 2 or tiles.shape[0] != 6:
        raise ValueError(f"tiles must be (6, T), got {tuple(tiles.shape)}")
    if not _build.cuda_device(rfields):
        return ray_band_bits_plain(rfields, tiles, NB)
    T = tiles.shape[1]
    P, I = _build.P, _build.I
    fn = _build.kernel_fn("ray_band_bits", "ray_band_bits_launch",
                          [P] * 3 + [I] * 5 + [P])
    out = torch.empty((RT, T), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _build.launch(fn, "ray_band_bits", rfields.data_ptr(),
                      tiles.data_ptr(), out.data_ptr(), RT, G, T, NB,
                      value_bits)
    tracing.count("launches.ray_band_bits")
    return out
