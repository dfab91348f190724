"""The port's flat namespace against the reference's, for the modules the
port has.

``fastmath_tpu/__init__.py`` is read by AST, not imported: its module
aliases (``from . import core, layouts``, ``from .ops import sym, ...``),
its star imports (``from .ops.sym import *``: each module's ``__all__``,
also read by AST) and its kernel entries (``from .kernels import
sym_solve_cf, ...``). Each of them whose module exists in
``fastmath_tpu_torch`` must be a top-level name of the port, the same
object as in the port's own module, and listed in its ``__all__``.
"""
import ast
import importlib
import importlib.util
import pathlib

import pytest

import fastmath_tpu_torch as T

REF = pathlib.Path(__file__).resolve().parents[1] / "fastmath_tpu"


def _module_all(path):
    """The literal ``__all__`` of a module's source."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__"
                                                for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path} has no literal __all__")


def _ported(dotted):
    """Whether the port has ``fastmath_tpu_torch.<dotted>``."""
    try:
        return importlib.util.find_spec(f"fastmath_tpu_torch.{dotted}") is not None
    except ModuleNotFoundError:
        return False


def _reference_imports():
    """(aliases, stars, entries) of the reference's top-level imports:
    (name, dotted module) pairs, dotted modules, (name, dotted module)."""
    aliases, stars, entries = [], [], []
    for node in ast.parse((REF / "__init__.py").read_text()).body:
        if not (isinstance(node, ast.ImportFrom) and node.level == 1):
            continue
        for a in node.names:
            if a.name == "*":
                stars.append(node.module)
            elif node.module is None:
                aliases.append((a.asname or a.name, a.name))
            elif node.module == "ops":
                aliases.append((a.asname or a.name, f"ops.{a.name}"))
            elif not (a.asname or a.name).startswith("_"):
                entries.append((a.asname or a.name, node.module))
    return aliases, stars, entries


_ALIASES, _STARS, _ENTRIES = _reference_imports()
REF_ALL = set(_module_all(REF / "__init__.py"))
ALIASES = [(n, m) for n, m in _ALIASES if _ported(m)]
STARS = [m for m in _STARS if _ported(m)]
ENTRIES = [(n, m) for n, m in _ENTRIES if _ported(m)]


def test_the_ported_part_is_found():
    # the AST reading finds what the port has: not a vacuous restriction
    assert {n for n, _ in ALIASES} >= {"core", "layouts", "kernels", "sym", "batched", "lie",
                                       "qr", "sugar"}
    assert set(STARS) >= {"ops.sym", "ops.batched", "ops.lie", "ops.qr", "ops.sugar"}
    assert {n for n, _ in ENTRIES} >= {"sym_solve_cf", "sym_matvec_cf", "sym_invert_cf"}


@pytest.mark.parametrize("name,dotted", ALIASES, ids=[n for n, _ in ALIASES])
def test_module_alias(name, dotted):
    assert getattr(T, name) is importlib.import_module(f"fastmath_tpu_torch.{dotted}")
    if name in REF_ALL:
        assert name in T.__all__


@pytest.mark.parametrize("dotted", STARS)
def test_star_names(dotted):
    names = _module_all(REF / (dotted.replace(".", "/") + ".py"))
    mod = importlib.import_module(f"fastmath_tpu_torch.{dotted}")
    missing = [n for n in names if not hasattr(T, n)]
    assert not missing, missing
    assert all(getattr(T, n) is getattr(mod, n) for n in names)
    assert set(names) <= set(T.__all__)


@pytest.mark.parametrize("name,dotted", ENTRIES, ids=[n for n, _ in ENTRIES])
def test_kernel_entry(name, dotted):
    mod = importlib.import_module(f"fastmath_tpu_torch.{dotted}")
    assert getattr(T, name) is getattr(mod, name)
    assert name in T.__all__


def test_all_resolves():
    assert len(set(T.__all__)) == len(T.__all__)
    assert [n for n in T.__all__ if not hasattr(T, n)] == []
