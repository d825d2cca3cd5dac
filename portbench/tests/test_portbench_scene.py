"""The traffic generator: a closed surface is a closed, consistently
oriented mesh of exactly the faces asked for; particles, motion and rays
come from the seed alone."""

import pytest
import torch

from portbench import scene
from portbench.reference import contacts as ref


@pytest.mark.parametrize("n", [6, 8, 10, 1500, 4098])
def test_a_closed_surface_is_closed(n):
    s = scene.surface(n, scene.generator(7, "cpu"), "cpu", edge=1.0)
    f, v = s.faces, s.points.shape[1]
    assert f.shape == (3, n) and n == 2 * v - 4
    assert torch.unique(f).shape[0] == v
    # every directed edge once, and its reverse once: closed and oriented
    e = torch.cat([f[[0, 1]], f[[1, 2]], f[[2, 0]]], 1)
    key, rkey = e[0] * v + e[1], e[1] * v + e[0]
    assert torch.unique(key).shape[0] == key.shape[0]
    assert torch.isin(rkey, key).all()


def test_a_surface_shares_its_vertices():
    """Each triangle's sphere touches those of its vertex neighbours, as on
    a scanned mesh: about 13 contacts a triangle, none isolated."""
    s = scene.surface(4000, scene.generator(0, "cpu"), "cpu", edge=1.0)
    x, r = ref.spheres(s.leaves(s.points)["tris"])
    keys = ref.self_contact_keys(x, r)
    per = torch.bincount(torch.cat([keys // 4000, keys % 4000]),
                         minlength=4000)
    assert 11 < 2 * keys.shape[0] / 4000 < 15 and per.min() >= 3


def test_odd_faces_are_refused():
    with pytest.raises(ValueError):
        scene.surface(1001, scene.generator(0, "cpu"), "cpu", edge=1.0)


@pytest.mark.parametrize("kind", ["closed surface", "particles"])
def test_the_seed_alone_draws_the_traffic(kind):
    conf = {"scene": kind, "scene_seed": 0, "triangles": 600,
            "particles": 600, "edge": 1.0, "spacing": 1.0,
            "radius": [0.1, 0.2]}
    a, ga = scene.configured(conf, 2 ** 33 + 1, "cpu")
    b, gb = scene.configured(conf, 2 ** 33 + 1, "cpu")
    c, _ = scene.configured(conf, 2 ** 33 + 2, "cpu")
    la, lb, lc = (s.leaves(s.points) for s in (a, b, c))
    for k in la:
        assert torch.equal(la[k], lb[k]) and not torch.equal(la[k], lc[k])
    assert torch.equal(scene.motion(a.points.shape[1], ga, "cpu")[1],
                       scene.motion(b.points.shape[1], gb, "cpu")[1])
