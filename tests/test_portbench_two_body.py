"""The benchmark's two-body cell, ``bed1m-tool250k-pair-graph``, in parts:
its answer kind ``two_body`` (``portbench/reference/two_body.py``) against
the test fixture's brute force (``portbench/tests/pair_cell/pair.py``) on
small scenes of particles against particles and against triangles; its
step driver (``portbench/steps/pair_graph.py``) reading the program's
spans into ``layer_ms``, and reading nothing, and raising nothing, from a
program without them; and (``gpu``) the step captured inside
``tracing.enabled()`` timing its spans after a replay.  No JAX: the
``gpu`` case runs on the card with ``--noconftest``."""

import importlib.util
import sys

import pytest
import torch

import implicitbvh_tpu_torch as ibt
from portbench import check, harness, scene
from portbench.reference.contacts import spheres
from portbench.tests.cell_checks import run
from portbench.tests.small import small_cell

CELL = "bed1m-tool250k-pair-graph"
PAIR = harness.HERE / "tests" / "pair_cell" / "pair.py"
STAGES = {"tiles.fields", "tiles.phase1", "tiles.count", "tiles.regroup",
          "tiles.emit", "tiles.merge", "tiles.finish"}


def brute_force():
    """The fixture's answer kind ``pair``: a brute force over every pair of
    particles, one of each body."""
    spec = importlib.util.spec_from_file_location("pair_fixture", PAIR)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def two_bodies(body2: str, seed: int):
    """Body 1, 700 particles, and body 2, 400 particles or a closed surface
    of 600 triangles, overlapping: ``(inputs, (x2, r2))``, body 2's
    spheres beside the inputs."""
    g = scene.generator(seed, "cpu")
    one = scene.particles(700, g, "cpu", spacing=1.0, radius=[0.1, 0.2])
    inputs = {"kind": "two_body", "x1": one.points, "r1": one.radii}
    centre = 0.5 * 700 ** (1.0 / 3.0)
    if body2 == "particles":
        two = scene.particles(400, g, "cpu", spacing=0.8,
                              radius=[0.05, 0.3])
        inputs.update(x2=two.points + 1.5, r2=two.radii)
        return inputs, (inputs["x2"], inputs["r2"])
    two = scene.surface(600, g, "cpu", edge=0.4)
    pts = two.points - two.points.mean(1, keepdim=True) + centre
    inputs["tris2"] = two.leaves(pts)["tris"]
    return inputs, spheres(inputs["tris2"])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("body2", ["particles", "triangles"])
def test_two_body_equals_the_brute_force(body2, seed):
    kind = check.kind("two_body")
    inputs, (x2, r2) = two_bodies(body2, seed)
    want = brute_force().reference_keys(
        {"x1": inputs["x1"], "r1": inputs["r1"], "x2": x2, "r2": r2})
    got = kind.reference_keys(inputs)
    assert want.shape[0] > 0 and torch.equal(got, want)
    rows = kind.rows_of(got, inputs)
    keys, invalid = kind.keys_of(rows, inputs)
    assert torch.equal(keys, got) and invalid == 0
    n1, n2 = 700, r2.shape[0]
    bad = torch.tensor([[0, 1], [n1 + 1, 1], [1, 0], [1, n2 + 1]])
    assert kind.keys_of(bad, inputs)[1] == 4
    assert check.pairs_off(got.shape[0], rows, inputs, want) == 0


def test_the_driver_reads_the_programs_spans_by_name():
    """A traced small run reads the stages' spans of each step into
    ``layer_ms`` until the layers are taken, never the program's
    ``build`` span under the layer's name; the readers find them."""
    cell = small_cell(CELL)
    drv = harness.step_driver(cell.traffic)(cell.config, cell.traffic, 7,
                                            torch.device("cpu"), True)
    drv.setup()
    for i in range(2):
        total, overflow, checks = drv.run(i)
        assert total > 0 and overflow == 0 and checks > 0
    layers = drv.layer_ms()
    assert STAGES <= set(layers) and "build" not in layers
    assert all(len(layers[name]) == 2 and min(layers[name]) > 0
               for name in STAGES)
    drv.run(2)
    assert len(drv.layer_ms()["tiles.fields"]) == 2
    res, compared = run(small_cell(CELL), trace=True)
    assert res["correct"]
    for name in ("fields_ms", "pair_phase1_ms"):
        assert res["metrics"][name]["value"] > 0


def test_a_program_without_spans_reads_nothing(monkeypatch):
    """On a program that has no ``tracing`` module the run is correct and
    the span metrics are left out."""
    monkeypatch.delattr(ibt, "tracing")
    monkeypatch.setitem(sys.modules, "implicitbvh_tpu_torch.tracing", None)
    res, compared = run(small_cell(CELL), trace=True)
    assert res["correct"]
    assert not {"fields_ms", "pair_phase1_ms"} & set(res["metrics"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_the_captured_step_times_its_spans_after_a_replay(cuda):
    cell = small_cell(CELL, leaves=20_000)
    drv = harness.step_driver(cell.traffic)(cell.config, cell.traffic,
                                            2 ** 33 + 5, cuda, True)
    drv.setup()
    total, overflow, _ = drv.run(0)
    assert total > 0 and overflow == 0
    layers = drv.layer_ms()
    assert len(layers["build"]) == len(layers["traverse"]) == 1
    for name in STAGES:
        assert len(layers[name]) == 1 and layers[name][0] > 0, name
    drv.release()

