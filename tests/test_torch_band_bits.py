"""The band-bit kernel B1 (``subtile_band_bits``) on synthetic edge cases.

On the CPU: the plain version against a loop over the slots (numpy, each
word built bit by bit from the six comparisons), at NB 4, 8 and 16, tile
counts ``Ta``/``Tb`` that are not multiples of 32 or of 4, ``nsp`` of 0,
between 0 and ``SP_cap``, equal to it and above it, and ``triangle`` on and
off, in float32 and in float64 (the same lattice values; a bound of one
type against tiles of the other is refused).  ``gpu``-marked tests hold
the CUDA kernel against the plain version, bit for bit, on the same cases
in both types, on an ``SP_cap`` past the persistent grid's warps, and on
inputs whose pointers are not 16-byte aligned (the kernel's scalar loads);
they skip without a card.  Every comparison is exact: the words are
integers built from comparisons of the same values.  Bounds lie on a lattice of halves, so ties (``lo == up``) occur.
No JAX here: ``tests/test_torch_kernels.py`` holds the plain version
against the Pallas kernel.
"""

import numpy as np
import pytest
import torch

from implicitbvh_tpu_torch import ops

SS = 32

# case -> (NB, Ta, Tb, SP_cap, nsp, triangle)
CASES = {
    "nb4_ragged_triangle": (4, 70, 45, 12, 7, True),
    "nb8_full_nsp_cap": (8, 70, 70, 12, 12, False),
    "nb16_nsp_zero": (16, 33, 97, 12, 0, True),
    "nb4_nsp_above_cap": (4, 64, 66, 12, 20, False),
    "nb16_odd_tiles": (16, 31, 3, 10, 6, False),
    "nb8_diagonal_triangle": (8, 100, 100, 16, 16, True),
}


def band_inputs(NB, Ta, Tb, SP_cap, nsp, seed, offset=0,
                dtype=torch.float32):
    """Sub-band bounds (6, Ta, NB), tile bounds (6, Tb), superpair slots and
    the live count, the bounds in ``dtype``.  ``offset`` > 0 places ``sub``
    and ``tiles`` that many values into larger buffers (contiguous, not
    16-byte aligned)."""
    rng = np.random.default_rng(seed)
    span = 6.0

    def boxes(*shape):
        lo = np.round(rng.random((3, *shape)) * span * 2) / 2
        up = lo + np.round(rng.random((3, *shape)) * 4) / 2
        return np.concatenate([lo, up]).astype(np.float32)

    def placed(a):
        buf = torch.zeros(a.size + offset, dtype=dtype)
        view = buf[offset:].view(a.shape)
        view.copy_(torch.from_numpy(a))
        return view

    S1, S2 = -(-Ta // SS), -(-Tb // SS)
    si = rng.integers(0, S1, SP_cap).astype(np.int32)
    sj = rng.integers(0, S2, SP_cap).astype(np.int32)
    si[::3] = np.minimum(sj[::3], S1 - 1)     # diagonal supertiles too
    return (placed(boxes(Ta, NB)), placed(boxes(Tb)), torch.from_numpy(si),
            torch.from_numpy(sj), torch.tensor([nsp], dtype=torch.int32))


def bits_loop(sub, tiles, si, sj, nsp, triangle):
    """The words slot by slot: bit r of word (i, j) from the six
    comparisons of sub-band r of a-tile si*32+i with b-tile sj*32+j."""
    sub, tiles = sub.numpy(), tiles.numpy()
    _, Ta, NB = sub.shape
    Tb = tiles.shape[1]
    out = np.zeros((si.shape[0], SS, SS), np.int32)
    for p in range(min(int(nsp[0]), si.shape[0])):
        tii = int(si[p]) * SS + np.arange(SS)
        tjj = int(sj[p]) * SS + np.arange(SS)
        a = sub[:, np.minimum(tii, Ta - 1)][:, :, None, :]    # (6, SS, 1, NB)
        b = tiles[:, np.minimum(tjj, Tb - 1)][:, None, :, None]
        ov = np.ones((SS, SS, NB), bool)
        for k in range(3):
            ov &= (a[3 + k] >= b[k]) & (a[k] <= b[3 + k])
        words = (ov.astype(np.int64) << np.arange(NB)).sum(-1)
        valid = (tii < Ta)[:, None] & (tjj < Tb)[None, :]
        if triangle:
            valid &= tii[:, None] <= tjj[None, :]
        out[p] = np.where(valid, words, 0)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_loop(case):
    NB, Ta, Tb, SP_cap, nsp, triangle = CASES[case]
    args = band_inputs(NB, Ta, Tb, SP_cap, nsp, seed=len(case))
    got = ops.subtile_band_bits(*args, triangle=triangle)   # CPU: plain
    assert got.shape == (SP_cap, SS, SS) and got.dtype == torch.int32
    want = bits_loop(*args, triangle)
    assert np.array_equal(got.numpy(), want)
    live = want[:min(nsp, SP_cap)]
    if nsp:        # the scene has both set and clear bits, and ties
        assert (live > 0).any() and (live == 0).any()
    assert not want[min(nsp, SP_cap):].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_loop_float64(case):
    """The same words from float64 bounds."""
    NB, Ta, Tb, SP_cap, nsp, triangle = CASES[case]
    args = band_inputs(NB, Ta, Tb, SP_cap, nsp, seed=len(case),
                       dtype=torch.float64)
    got = ops.subtile_band_bits(*args, triangle=triangle)   # CPU: plain
    assert np.array_equal(got.numpy(), bits_loop(*args, triangle))
    f32 = band_inputs(NB, Ta, Tb, SP_cap, nsp, seed=len(case))
    assert torch.equal(got, ops.subtile_band_bits(*f32, triangle=triangle))


def test_wrapper_takes_one_value_type():
    """float32 or float64 bounds, both of one type: the caller widens."""
    sub, tiles, si, sj, nsp = band_inputs(4, 40, 40, 4, 2, seed=0)
    with pytest.raises(TypeError, match="tiles must be torch.float32"):
        ops.subtile_band_bits(sub, tiles.double(), si, sj, nsp)
    with pytest.raises(TypeError, match="tiles must be torch.float64"):
        ops.subtile_band_bits(sub.double(), tiles, si, sj, nsp)
    with pytest.raises(TypeError, match="sub must be torch.float32 or"):
        ops.subtile_band_bits(sub.half(), tiles.half(), si, sj, nsp)


def test_wrapper_checks():
    args = band_inputs(4, 40, 40, 4, 2, seed=0)
    sub, tiles, si, sj, nsp = args
    with pytest.raises(ValueError, match="sub must be"):
        ops.subtile_band_bits(sub[:, :, :3].contiguous(), tiles, si, sj, nsp)
    with pytest.raises(TypeError, match="si must be"):
        ops.subtile_band_bits(sub, tiles, si.long(), sj, nsp)
    with pytest.raises(ValueError, match="nsp must have shape"):
        ops.subtile_band_bits(sub, tiles, si, sj, nsp.reshape(()))
    with pytest.raises(ValueError, match="contiguous"):
        ops.subtile_band_bits(sub, tiles.t().contiguous().t(), si, sj, nsp)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_equals_plain(dev, args, triangle):
    args = tuple(t.to(dev) for t in args)
    before = ops.launch_count(ops.subtile_band_bits)
    got = ops.subtile_band_bits(*args, triangle=triangle)
    torch.cuda.synchronize()
    assert ops.launch_count(ops.subtile_band_bits) == before + 1
    want = ops.subtile_band_bits_plain(*args, triangle=triangle)
    return torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("offset", [0, 1])
def test_kernel_matches_plain_on_card(cuda, case, offset):
    """Every edge case, with aligned inputs (the float4 loads) and with
    inputs one float off alignment (the scalar loads)."""
    NB, Ta, Tb, SP_cap, nsp, triangle = CASES[case]
    args = band_inputs(NB, Ta, Tb, SP_cap, nsp, seed=len(case),
                       offset=offset)
    assert _card_equals_plain(cuda, args, triangle), case


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("offset", [0, 1])
def test_kernel_matches_plain_on_card_float64(cuda, case, offset):
    """The double kernel on every edge case: aligned (double2 loads) and
    one value off alignment (scalar loads)."""
    NB, Ta, Tb, SP_cap, nsp, triangle = CASES[case]
    args = band_inputs(NB, Ta, Tb, SP_cap, nsp, seed=len(case),
                       offset=offset, dtype=torch.float64)
    assert _card_equals_plain(cuda, args, triangle), case


@pytest.mark.gpu
@pytest.mark.parametrize("NB", [4, 16])
@pytest.mark.parametrize("triangle", [True, False])
def test_kernel_past_the_persistent_grid_on_card(cuda, NB, triangle):
    """More slots than the persistent grid has warps (132 SMs hold at most
    8,448 warps of 32), so a warp takes several; nsp cuts them midway."""
    SP_cap = 20011
    for dtype in (torch.float32, torch.float64):
        args = band_inputs(NB, 400, 390, SP_cap, 15000, seed=NB,
                           dtype=dtype)
        assert _card_equals_plain(cuda, args, triangle), dtype
