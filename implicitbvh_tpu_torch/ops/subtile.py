"""Phase-1b sub-band bits: the CUDA kernel and its plain PyTorch version.

Replaces ``implicitbvh_tpu/ops/subtile.py:subtile_band_bits``
(``_bits_kernel``).  For every live supertile pair ``p`` the result holds,
for a-tile ``si[p]*32+i`` and b-tile ``sj[p]*32+j``, an NB-bit word whose
bit ``r`` is set iff sub-band ``r`` of the a-tile overlaps the b-tile's
AABB.  The count kernel skips the dead bands, and ``bits > 0`` is the pair
filter.  The bounds are float32 or float64, both of one type.  The kernel
(``csrc/band_bits.cu``, a template on the value type) is bound by bytes on
the H100: a persistent grid of warps, one slot per warp, 16-byte stores.
"""

from __future__ import annotations

import torch

from .. import tracing
from . import _build

SS = 32  # tiles per supertile


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

