"""The port's routing policy: whether a public op call runs its CUDA
kernel or its plain PyTorch version.

PyTorch counterpart of ``fastmath_tpu/ops/_routing.py``. Every public op
that has a kernel takes ``backend``:

* ``"auto"``: the kernel for supported input on a CUDA device, at a size
  in the family's n-range and a batch of at least its threshold there
  (:data:`MIN_BATCH`, :func:`threshold`); otherwise the plain version, on the tensors'
  device;
* ``"cuda"``: the kernel at any batch and any size it serves; raises
  ``ValueError`` outside the kernel's domain or on CPU tensors;
* ``"torch"``: the plain version, never the kernel.

Every threshold here is the crossover that ``chip_smoke.py``'s routing
sweep (phase 13) measured on an NVIDIA H100: the public call per call,
host launches included, through the kernel and through the plain
version, at batches 1 to 16,384 (and on to 1,048,576 where the kernel was
still slower); ``PERF.md`` §5 gives the times. A threshold is the
largest crossover the sweep found among the sizes it covers, over the
runs recorded there. The
n-ranges that choose between a kernel and the plain path are here too
(the products' last steps, :func:`logm_eig_route`), each measured by the
sweep its comment names.

The tiers inside a kernel (the staged n <= 8 solve, the lane groups, the
compact inverse's one-thread tier) are chosen by the kernels' launchers,
not here.
"""
from __future__ import annotations

import math

__all__ = ["BACKENDS", "use_kernel", "threshold", "nbatch", "logm_eig_route"]

BACKENDS = ("auto", "cuda", "torch")

#: family: its steps, (largest size, least batch) in increasing size:
#: ``auto`` launches the family's kernel at size n on a CUDA batch of at
#: least the least batch of the first step that reaches n, and never
#: above the last step's size. The kernel of every family not named here
#: won at every swept batch from 1 at every swept size. Phase 13's sweep
#: on an NVIDIA H100 80GB HBM3 at 700 W, two runs: these two lose at small
#: batches to one ``torch.matmul`` launch above their plain versions'
#: unrolled tiers (n <= 4; every dim <= 6). From 262,144 problems each
#: kernel's call won at every swept size in both runs (the matvec at
#: n = 8: 0.1700 against 0.2693 ms; the product at n = 32: 1.3379 against
#: 1.3643 ms). At 65,536 only the matvec at n = 12 won in both; the
#: product's two sides were within 10% there and the winner changed
#: between runs at n = 8, 24 and 32. The matvec kernel's device time lost
#: to torch.matmul's from n = 16 (chip_smoke.py phase 8's routing sweep):
#: its last step ends at 12.
MIN_BATCH = {
    "batchmatvec": ((4, 1), (12, 262_144)),
    "batchmatmul": ((6, 1), (32, 262_144)),
}
#: the products' n-ranges under ``auto``, the last steps' sizes (the
#: kernels serve 32 under ``backend="cuda"``)
MATVEC_KERNEL_MAX = MIN_BATCH["batchmatvec"][-1][0]
MATMUL_KERNEL_MAX = MIN_BATCH["batchmatmul"][-1][0]
#: lower bound of ``logm``'s symmetric eig route on the card: on SPD input
#: on 15,625 problems per call the logm kernel was faster up to d = 16
#: (1.2014 against 3.1384 ms at 16) and the eig route from 17 on (1.9788
#: against 5.4420 ms at 17, 5.4067 against 8.3142 at 32): NVIDIA H100 80GB
#: HBM3 at 700 W, chip_smoke.py phase 10
LOGM_SYM_EIG_MIN_D = 17
#: upper bound of that route: the eig kernel's rolled tier serves d <= 32
LOGM_SYM_EIG_MAX_D = 32


def nbatch(*operands, core: int = 1) -> int:
    """Broadcast batch size of ``(..., C)`` operands (``core=2``: of
    ``(..., n, n)`` ones): the product of the broadcast of their leading
    dims. An operand given as a tuple is a batch shape already. Reads
    shapes only; equal shapes (the common case) take no broadcast."""
    shapes = [t if isinstance(t, tuple) else t.shape[:-core] for t in operands]
    if not shapes:
        return 0
    first = shapes[0]
    for s in shapes:
        if s != first:
            return math.prod(_broadcast(shapes))
    return math.prod(first)


def _broadcast(shapes):
    width = max(len(s) for s in shapes)
    out = [1] * width
    for s in shapes:
        for i, d in enumerate(s, width - len(s)):
            if d != 1:
                if out[i] not in (1, d):
                    raise ValueError(f"batch shapes {[tuple(s) for s in shapes]} do not "
                                     "broadcast")
                out[i] = d
    return out


def use_kernel(backend: str, *, family: str, n: int, batch: int, supported: bool,
               on_card: bool, why_unsupported: str = "") -> bool:
    """Whether a public op call launches its kernel (see the module
    docstring). ``family``: the op whose n-range and threshold apply;
    ``n``: the problem size (the largest dim of a product); ``batch``: the
    broadcast batch (:func:`nbatch`); ``supported``: the kernel takes this
    input (size, dtype, storage); ``on_card``: the tensors are on a CUDA
    device; ``why_unsupported`` words the error of a forced
    ``backend="cuda"`` outside the domain."""
    if backend == "torch":
        return False
    if backend == "cuda":
        if not supported:
            raise ValueError(f"backend='cuda': {why_unsupported}" if why_unsupported
                             else "backend='cuda' is not supported for this input")
        if not on_card:
            raise ValueError("backend='cuda' needs CUDA tensors")
        return True
    if backend != "auto":
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if not (supported and on_card):
        return False
    least = threshold(family, n)
    return least is not None and batch >= least


def threshold(family: str, n: int):
    """The least batch at which ``auto`` launches ``family``'s kernel at
    size ``n`` on supported CUDA input; None outside its n-range."""
    steps = MIN_BATCH.get(family)
    if steps is None:
        return 1
    for size, least in steps:
        if n <= size:
            return least
    return None


def logm_eig_route(d: int) -> bool:
    """Whether a symmetric ``logm`` batch of size ``d`` that takes a kernel
    takes the eig kernel's ``V log|w| Vᵀ`` instead of the logm kernel."""
    return LOGM_SYM_EIG_MIN_D <= d <= LOGM_SYM_EIG_MAX_D
