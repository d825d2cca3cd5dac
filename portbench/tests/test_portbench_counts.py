"""The roofline arithmetic of ``portbench/counts`` against counts made by
hand on tiny inputs."""

from types import SimpleNamespace

import pytest
import torch

from portbench.counts import b2, peaks, w1


def test_popcount():
    x = torch.tensor([0, 1, 0b1011, 0xFFFF, -1, 0x80000000], dtype=torch.int64)
    assert b2.popcount(x).tolist() == [0, 1, 3, 16, 32, 1]


def b2_call():
    """Two steps of two slots (W = 2), one live step, R = 8, NB = 4: one
    word row of band bits per slot."""
    a_idx = torch.zeros(2, dtype=torch.int32)
    run_idx = torch.zeros(4, dtype=torch.int32)
    bm = torch.tensor([[0b1011, 0xF0, 0xFFFF, 0x1]], dtype=torch.int32)
    nsteps = torch.tensor([1], dtype=torch.int32)
    fields = torch.zeros((4, 2, 128))
    return (a_idx, run_idx, bm, nsteps, fields), dict(
        mask_kind="sphere", R=8, NB=4)


def test_b2_by_hand():
    args, kw = b2_call()
    bound, by, bytes_ms, ops_ms = b2.bound(args, kw)
    # live slots 0 and 1: 3 + 4 band bits, each 128 / 4 rows of 128 tests
    tests = 7 * 32 * 128
    assert ops_ms == pytest.approx(tests * 11 / 67e12 * 1e3)
    # inputs 8 + 16 + 16 + 4 + 4096 bytes, two (4 * 8,) int32 outputs
    assert bytes_ms == pytest.approx((8 + 16 + 16 + 4 + 4096 + 256)
                                     / 3.35e12 * 1e3)
    assert by == "operations" and bound == ops_ms


def test_b2_moments_and_two_field_sets():
    args, kw = b2_call()
    a_idx, run_idx, bm, nsteps, fields = args
    both = (a_idx, run_idx, bm, nsteps, fields, fields.clone())
    one = b2.bound(args, kw)[2]
    assert b2.bound(both, kw)[2] == pytest.approx(
        one + 4096 / 3.35e12 * 1e3)
    # live rows with moments: slot 0 tiles 0, 1 (nibbles 0b1011, 0);
    # slot 1 tiles 1 (0xF0 -> nibble 1 is 0xF); b-tiles below Tb = 2
    rows = b2.live_rows(run_idx, bm, nsteps, 2, 2, 8, 4)
    assert rows == 2
    moments = b2.bound(args, dict(kw, moments=True))[2]
    assert moments == pytest.approx(one + 2 * 128 * 4 / 3.35e12 * 1e3)


class BBox:
    batch_shape = (7,)
    dtype = torch.float32


class BSphere:
    batch_shape = (4,)
    dtype = torch.float32


def test_w1_by_hand():
    leaves = SimpleNamespace(volume=BSphere(),
                             index=torch.zeros(4, dtype=torch.int32))
    target = SimpleNamespace(nodes=BBox(), leaves=leaves,
                             skips=torch.zeros(11, dtype=torch.int32))
    count = w1.bound(target, leaves, 10, 6, 0, False, True)
    write = w1.bound(target, leaves, 10, 6, 3, True, True)
    # nodes 7 boxes, leaves 4 spheres, leaf index, skips, counts, dedup
    count_bytes = 7 * 24 + 4 * 16 + (4 + 11 + 4) * 4 + 4 * 4
    assert count[2] == pytest.approx(count_bytes / 3.35e12 * 1e3)
    # the write pass adds the offsets and three rows of two indices
    assert write[2] == pytest.approx((count_bytes + 16 + 24)
                                     / 3.35e12 * 1e3)
    # sphere lanes: 6 operations against a box node, 11 against a sphere
    assert count[3] == pytest.approx((10 * 6 + 6 * 11) / 67e12 * 1e3)
    assert count[1] == "bytes" and count[0] == count[2]


def test_peaks_take_the_larger_term():
    assert peaks.bound_ms(3.35e9, 0, torch.float32)[:2] == (1.0, "bytes")
    assert peaks.bound_ms(0, 34e9, torch.float64)[:2] == (1.0, "operations")
