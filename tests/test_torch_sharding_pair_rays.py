"""Sharded two-tree contact, rays and the moving-geometry step of the
port against the JAX package's ``implicitbvh_tpu.parallel``, on the CPU,
and the public functions in process-group worlds.

As in ``test_torch_sharding.py`` (whose scenes and helpers this file
shares), the local functions at 8 ranks are held exactly against the JAX
package's 8 virtual devices: totals, per-rank counts, the overflow bool,
the ray walk's buffer row by row and the tile engines' rank slices as
sorted lists.  The public functions, with their one all-reduce and their
``DTensor`` results, run in a gloo world of 4 subprocess ranks (each
imports only ``torch`` and the port) against the local functions at 4
ranks, brute forces and the totals of the JAX package's multichip dry run
(``MULTICHIP_r05.json``: 157 contacts, 32 hits, 319 pairs).  The ``gpu``
cases hold the local functions on the card against the CPU and run a NCCL
world of 1.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import implicitbvh_tpu_torch as tb
from implicitbvh_tpu_torch import parallel as tpar
from implicitbvh_tpu_torch.parallel import sharding as ts

# jax_out and the autouse reference are fixtures: imported to be registered
from test_torch_sharding import (TILE32_WIDE, brute_force, dryrun_scene,  # noqa: F401
                                 jax_out, per_rank, port_bvh, rank_rows,
                                 ray_scene, reference, same_tiles, same_walk,
                                 spheres)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_tile_pair_matches_jax(jax_out):
    xs1, rs1 = spheres(300, 21)
    xs2, rs2 = spheres(200, 22)
    got = per_rank(ts._local_sharded_tile_pair, port_bvh(xs1, rs1),
                   port_bvh(xs2, rs2), 512,
                   alg=tb.TileTraversal(**TILE32_WIDE))
    assert same_tiles(jax_out("pair"), got, 512) == \
        brute_force(xs1, rs1, xs2, rs2)
    assert not any(got[2])


@pytest.mark.parametrize("engine", ["tiles", "walk"])
def test_rays_match_jax(jax_out, engine):
    xs, rs, p, d = ray_scene()
    bvh = port_bvh(xs, rs)
    got = per_rank(ts._local_sharded_rays, bvh, p, d, 128, engine=engine)
    jout = jax_out(f"rays_{engine}")
    if engine == "walk":
        same_walk(jout, got, 128)
        hits = {tuple(r) for c, n in zip(got[1], got[0])
                for r in c[:n].tolist()}
    else:
        hits = same_tiles(jout, got, 128)
    single = tb.traverse_rays(bvh, p, d, tb.LVTTraversal())
    assert hits == set(single.contacts_list()) and not any(got[2])


def test_rebuild_step_matches_jax(jax_out):
    """The full step before and after moving the geometry."""
    xs, rs = spheres(128, 3)
    for jout, x in zip(jax_out("step"), (xs, xs + 0.1)):
        got = per_rank(ts._local_sharded_rebuild_traverse_step,
                       torch.as_tensor(x), torch.as_tensor(rs),
                       capacity_per_device=256,
                       alg=tb.TileTraversal(**TILE32_WIDE))
        assert same_tiles(jout, got, 256) == brute_force(x, rs)


# --------------------------------------------------------------------------
# the public functions in a gloo world of 4
# --------------------------------------------------------------------------

WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
try:
    import implicitbvh_tpu_torch as tb
    from implicitbvh_tpu_torch.parallel import (
        make_mesh, sharded_rays, sharded_rebuild_traverse_step,
        sharded_self_contact, sharded_tile_pair, sharded_tile_self_contact)
    s = {k: torch.as_tensor(v) for k, v in np.load(out + "/scene.npz").items()}
    mesh = make_mesh("cpu")
    alg = tb.TileTraversal(tile=32, row_cap=8, pair_cap=64)
    bvh = tb.build(tb.BSphere(s["x"], s["r"]), tb.BBox)
    bvh2 = tb.build(tb.BSphere(s["x2"], s["r2"]), tb.BBox)
    step = sharded_rebuild_traverse_step(mesh, capacity_per_device=512,
                                         alg=alg)
    runs = {
        "step": step(s["x"], s["r"]),
        "moved": step(s["x"] + 0.05, s["r"]),
        "tile_over": sharded_tile_self_contact(mesh, bvh, 16, alg=alg),
        "walk": sharded_self_contact(mesh, bvh, 512),
        "rays": sharded_rays(mesh, bvh, s["p"], s["d"], 256),
        "rays_walk": sharded_rays(mesh, bvh, s["p"], s["d"], 256,
                                  engine="walk"),
        "pair": sharded_tile_pair(mesh, bvh, bvh2, 512, alg=alg),
    }
    torch.save({name: dict(total=t, full=c.full_tensor(), local=c.to_local(),
                           counts=n.full_tensor(), overflow=o,
                           shapes=(tuple(c.shape), tuple(n.shape)))
                for name, (t, c, n, o) in runs.items()},
               f"{out}/rank{rank}.pt")
finally:
    dist.destroy_process_group()
"""


def run_world(tmp_path, world, timeout=180):
    """Start ``world`` gloo ranks running WORKER on ``tmp_path``'s scene;
    returns each rank's saved results."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(rank), str(world),
         str(tmp_path / "store"), str(tmp_path)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, f"rank {rank}:\n{logs[rank]}"
    return [torch.load(tmp_path / f"rank{rank}.pt") for rank in range(world)]


def test_public_functions_in_a_gloo_world_of_4(tmp_path):
    """Through ``make_mesh("cpu")`` and the public functions on 4 processes:
    every rank's ``total``, ``overflow``, ``counts.full_tensor()``,
    ``contacts.full_tensor()`` and ``.to_local()`` equal the local
    functions at 4 ranks in this process; the sets equal brute forces; the
    dry run's scene gives its 157 contacts, 32 hits and 319 pairs."""
    world, alg = 4, tb.TileTraversal(**TILE32_WIDE)
    s = dryrun_scene()
    np.savez(tmp_path / "scene.npz", **s)
    results = run_world(tmp_path, world)
    x, r = torch.as_tensor(s["x"]), torch.as_tensor(s["r"])
    bvh, bvh2 = port_bvh(s["x"], s["r"]), port_bvh(s["x2"], s["r2"])
    local = {
        "step": (ts._local_sharded_rebuild_traverse_step, (x, r, ),
                 dict(capacity_per_device=512, alg=alg)),
        "moved": (ts._local_sharded_rebuild_traverse_step, (x + 0.05, r),
                  dict(capacity_per_device=512, alg=alg)),
        "tile_over": (ts._local_sharded_tile_self_contact, (bvh, 16),
                      dict(alg=alg)),
        "walk": (ts._local_sharded_self_contact, (bvh, 512), {}),
        "rays": (ts._local_sharded_rays, (bvh, s["p"], s["d"], 256), {}),
        "rays_walk": (ts._local_sharded_rays, (bvh, s["p"], s["d"], 256),
                      dict(engine="walk")),
        "pair": (ts._local_sharded_tile_pair, (bvh, bvh2, 512),
                 dict(alg=alg)),
    }
    sets = {}
    for name, (fn, args, kw) in local.items():
        totals, contacts, overflows = per_rank(fn, *args, n_dev=world, **kw)
        full = torch.cat(contacts)
        cap = contacts[0].shape[0]
        for rank, res in enumerate(results):
            got = res[name]
            assert int(got["total"]) == sum(totals), (name, rank)
            assert bool(got["overflow"]) == any(overflows), (name, rank)
            assert got["overflow"].dtype == torch.bool
            assert got["counts"].tolist() == totals, (name, rank)
            assert got["shapes"] == ((world * cap, 2), (world,))
            assert torch.equal(got["full"], full), (name, rank)
            assert torch.equal(got["local"], contacts[rank]), (name, rank)
        sets[name] = {tuple(row) for c, n in zip(contacts, totals)
                      for row in c[:min(n, cap)].tolist()}
        sets[name + " total"] = sum(totals)
    assert sets["tile_over"] != sets["step"] and \
        bool(results[0]["tile_over"]["overflow"])
    assert sets["step"] == sets["walk"] == brute_force(s["x"], s["r"])
    assert sets["moved"] == brute_force(s["x"] + np.float32(0.05), s["r"])
    assert sets["pair"] == brute_force(s["x"], s["r"], s["x2"], s["r2"])
    single = tb.traverse_rays(bvh, s["p"], s["d"], tb.LVTTraversal())
    assert sets["rays"] == sets["rays_walk"] == set(single.contacts_list())
    assert (sets["step total"], sets["rays total"], sets["pair total"]) == \
        (157, 32, 319)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("n_dev", [1, 4])
def test_local_functions_on_card_match_cpu(n_dev):
    """Tile self, pair and rays (both engines) at 4 ranks and 1: the
    card's CUDA kernels give the CPU's counts, overflow and sorted rank
    slices."""
    needs_card()
    s = dryrun_scene()
    alg = tb.TileTraversal(**TILE32_WIDE)
    runs = [
        lambda dv: (ts._local_sharded_tile_self_contact,
                    (port_bvh(s["x"], s["r"], dv), 512), dict(alg=alg)),
        lambda dv: (ts._local_sharded_tile_pair,
                    (port_bvh(s["x"], s["r"], dv),
                     port_bvh(s["x2"], s["r2"], dv), 512), dict(alg=alg)),
        lambda dv: (ts._local_sharded_rays,
                    (port_bvh(s["x"], s["r"], dv), s["p"], s["d"], 256), {}),
        lambda dv: (ts._local_sharded_rays,
                    (port_bvh(s["x"], s["r"], dv), s["p"], s["d"], 256),
                    dict(engine="walk")),
    ]
    for run in runs:
        res = []
        for dv in ("cuda", "cpu"):
            fn, args, kw = run(dv)
            totals, contacts, overflows = per_rank(fn, *args, n_dev=n_dev,
                                                   **kw)
            res.append((totals, overflows, [rank_rows(c.cpu(), n, 512)
                                            for c, n in zip(contacts,
                                                            totals)]))
        assert res[0] == res[1] and sum(res[0][0]) > 0


@pytest.mark.gpu
def test_nccl_world_of_one_matches_local(tmp_path):
    """A NCCL world of 1 through ``make_mesh()`` and the public functions:
    the local functions' results at 1 rank, the dry run's totals."""
    needs_card()
    import torch.distributed as dist
    s = dryrun_scene()
    alg = tb.TileTraversal(**TILE32_WIDE)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = tpar.make_mesh()
        x = torch.as_tensor(s["x"], device="cuda")
        r = torch.as_tensor(s["r"], device="cuda")
        bvh = port_bvh(s["x"], s["r"], "cuda")
        bvh2 = port_bvh(s["x2"], s["r2"], "cuda")
        runs = [
            (tpar.sharded_rebuild_traverse_step(
                mesh, capacity_per_device=512, alg=alg)(x, r),
             ts._local_sharded_rebuild_traverse_step(
                 x, r, 0, 1, capacity_per_device=512, alg=alg), 157),
            (tpar.sharded_rays(mesh, bvh, s["p"], s["d"], 256),
             ts._local_sharded_rays(bvh, s["p"], s["d"], 256, 0, 1), 32),
            (tpar.sharded_tile_pair(mesh, bvh, bvh2, 512, alg=alg),
             ts._local_sharded_tile_pair(bvh, bvh2, 512, 0, 1, alg=alg),
             319),
        ]
        for (total, contacts, counts, overflow), (lt, lc, lo), want in runs:
            assert int(total) == int(lt) == want and not bool(overflow)
            assert counts.full_tensor().tolist() == [want]
            assert torch.equal(contacts.to_local(), lc)
            assert torch.equal(contacts.full_tensor(), lc)
    finally:
        dist.destroy_process_group()
