"""Static-quality gate of the PyTorch/CUDA port, the counterpart of
``tests/test_quality.py``: every module of ``implicitbvh_tpu_torch``
imports, every advertised export resolves, public callables are
documented, and the public API holds the JAX package's ``__all__``.

The JAX package's ``__all__`` is read from its source with ``ast``, so this
file imports no JAX and runs where only the port is installed.
"""

import ast
import importlib
import inspect
import pathlib
import pkgutil

import implicitbvh_tpu_torch as tb

ROOT = pathlib.Path(__file__).resolve().parents[1]

# exported by the port and not in the JAX package's __all__: the tile
# names it imports at its top level but does not list, and the two-tree
# tile entry points
TILE_NAMES = {"TileTraversal", "traverse_tiles", "traverse_tiles_fixed",
              "traverse_tiles_pair", "traverse_tiles_pair_fixed"}


def _iter_modules():
    pkg_dir = pathlib.Path(tb.__file__).parent
    for mod in pkgutil.walk_packages([str(pkg_dir)],
                                     prefix="implicitbvh_tpu_torch."):
        yield mod.name


def _jax_all():
    """The JAX package's ``__all__``, from its ``__init__.py`` source."""
    tree = ast.parse((ROOT / "implicitbvh_tpu" / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return set(ast.literal_eval(node.value))
    raise AssertionError("implicitbvh_tpu/__init__.py has no __all__")


def test_all_modules_import():
    names = list(_iter_modules())
    assert "implicitbvh_tpu_torch.ops.compaction" in names
    for name in names:
        importlib.import_module(name)


def test_all_exports_resolve():
    assert tb.__all__, "package must advertise its API"
    assert len(set(tb.__all__)) == len(tb.__all__)
    for name in tb.__all__:
        assert getattr(tb, name, None) is not None, name


def test_public_api_documented():
    for name in tb.__all__:
        obj = getattr(tb, name)
        if callable(obj) or inspect.isclass(obj):
            assert (obj.__doc__ or "").strip(), f"{name} lacks a docstring"


def test_submodule_alls_resolve():
    for name in _iter_modules():
        mod = importlib.import_module(name)
        for export in getattr(mod, "__all__", []):
            assert getattr(mod, export, None) is not None, (name, export)


def test_exports_hold_the_jax_api():
    """Every name of the JAX package's ``__all__``, and besides them only
    the five tile names."""
    jax_all = _jax_all()
    ours = set(tb.__all__)
    assert ours == jax_all | TILE_NAMES
    assert not jax_all & TILE_NAMES
