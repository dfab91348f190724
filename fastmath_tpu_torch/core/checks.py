"""Numerical tripwires: ``assert_finite``, ``debug_nans`` and ``checked``.

PyTorch counterpart of ``fastmath_tpu/core/checks.py``. JAX's
``jax_debug_nans`` and ``checkify`` become a
``torch.overrides.TorchFunctionMode`` that checks every torch function
called inside it: it raises ``FloatingPointError`` on the first one that
returns NaN (with ``div``, also +-inf) from inputs that held none, and
names it. The port's CUDA kernels write their outputs through ``ctypes``,
which no torch function sees, so the mode also checks each kernel launch
(:func:`fastmath_tpu_torch.kernels._launch.launch`): the output buffers
it wrote, against the inputs the mode has seen.

The mode reads every floating result on the host, so each torch function
waits for the device: it is for debugging, and nothing on the ops' own
path enters it.
"""
from __future__ import annotations

import contextlib
import functools
import weakref
from typing import Callable

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_leaves

__all__ = ["checked", "debug_nans", "assert_finite"]

# factories whose buffers hold whatever the memory held: a kernel writes them
_EMPTY = frozenset({"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"})


def _floats(tree):
    return [t for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())]


def _has(ts, nan: bool, inf: bool) -> bool:
    """Whether any of ``ts`` holds NaN (``nan``) or +-inf (``inf``)."""
    for t in ts:
        if t.numel() == 0:
            continue
        if nan and bool(torch.isnan(t).any()):
            return True
        if inf and bool(torch.isinf(t).any()):
            return True
    return False


def _made(outs, ins, nan: bool, div: bool) -> str:
    """What ``outs`` hold that ``ins`` did not: "NaN", "inf" or ""."""
    if nan and _has(outs, True, False) and not _has(ins, True, False):
        return "NaN"
    if div and _has(outs, False, True) and not _has(ins, True, True):
        return "inf"
    return ""


class _NanMode(TorchFunctionMode):
    """The tripwire of :func:`debug_nans` and :func:`checked`."""

    def __init__(self, nan: bool = True, div: bool = False):
        super().__init__()
        self.nan, self.div = nan, div
        # tensors that torch functions returned, by data pointer: the
        # inputs a kernel launch can name only by pointer
        self.seen = weakref.WeakValueDictionary()
        self.empties = []  # weak references to unwritten buffers

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", repr(func))
        outs = _floats(out)
        if not outs:
            return out
        if name in _EMPTY:
            self.empties = [r for r in self.empties if r() is not None][-63:]
            self.empties += [weakref.ref(t) for t in outs]
            return out
        for t in outs:
            self.seen[t.data_ptr()] = t
        leaves = tree_leaves((args, kwargs))
        if not any(isinstance(t, torch.Tensor) for t in leaves):
            return out  # made from Python data (torch.tensor, torch.full): not computed
        made = _made(outs, _floats(leaves), self.nan, self.div)
        if made:
            raise FloatingPointError(
                f"debug_nans: torch function {name} returned {made} from inputs that held none")
        return out

    def launched(self, name: str, args) -> None:
        """Check the buffers a kernel launch wrote (the unwritten ones whose
        pointers it took) against its inputs (the seen ones it took)."""
        ptrs = {a for a in args if isinstance(a, int)}
        with torch._C.DisableTorchFunction():  # not the mode's own reads
            outs = [t for t in (r() for r in self.empties)
                    if t is not None and t.data_ptr() in ptrs]
            written = {t.data_ptr() for t in outs}
            ins = [t for p, t in list(self.seen.items()) if p in ptrs and p not in written]
            made = _made(outs, ins, self.nan, self.div)
        if made:
            raise FloatingPointError(
                f"debug_nans: CUDA kernel {name} returned {made} from inputs that held none")


@contextlib.contextmanager
def _tripwire(nan: bool, div: bool):
    from ..kernels import _launch

    mode, watch = _NanMode(nan, div), _launch._watch
    _launch._watch = mode
    try:
        with mode:
            yield
    finally:
        _launch._watch = watch


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Context manager: while on, the first torch function (or CUDA kernel
    of the port) that returns NaN from inputs that held none raises
    ``FloatingPointError`` naming it (the eager analog of JAX's
    ``jax_debug_nans``). ``enable=False`` runs the block unchecked."""
    if not enable:
        yield
        return
    with _tripwire(True, False):
        yield


def checked(fn: Callable, *, nan: bool = True, div: bool = True,
            oob: bool = False) -> Callable:
    """Wrap ``fn`` so that NaN (``nan``) or +-inf from finite inputs
    (``div``: a division by zero or an overflow) raise
    ``FloatingPointError`` naming the torch function or kernel that made
    them, and check ``fn``'s outputs against its inputs as well. ``oob``
    is accepted for the JAX package's signature: torch checks indices
    itself and raises ``IndexError`` whatever it is."""
    if not (nan or div):
        return fn

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _tripwire(nan, div):
            out = fn(*args, **kwargs)
        made = _made(_floats(out), _floats((args, kwargs)), nan, div)
        if made:
            raise FloatingPointError(
                f"checked: {getattr(fn, '__name__', fn)!s} returned {made} from inputs that "
                "held none")
        return out

    return wrapped


def _tracing() -> bool:
    return torch.compiler.is_compiling() or torch.jit.is_tracing()


def assert_finite(x, name: str = "input"):
    """Raise ``ValueError`` if ``x`` holds NaN or +-inf; return ``x``. One
    read on the host, so not under ``torch.compile`` or tracing (raises
    ``TypeError`` there): use :func:`checked`."""
    if _tracing():
        raise TypeError("assert_finite reads on the host; use checked() under "
                        "torch.compile or tracing")
    if not bool(torch.isfinite(torch.as_tensor(x)).all()):
        raise ValueError(f"{name} has non finite values.")
    return x
