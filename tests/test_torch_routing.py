"""The port's routing policy, ``ops/_routing.py``.

* the decision table of ``use_kernel``: ``"torch"`` never, ``"cuda"``
  always or a ``ValueError`` (outside the domain, on CPU tensors),
  ``"auto"`` within its family's n-range at or above its threshold on
  the card, an unknown backend raises;
* every public op with a kernel asks the policy, with its family, its
  size and its batch, and on CPU tensors ``auto`` launches no kernel (the
  launch counters stay 0);
* ``nbatch`` against ``fastmath_tpu.ops._routing.nbatch`` on broadcast
  shapes;
* the names the policy took over stay importable where they were, as the
  same objects.

Inputs are small float64 batches made from a numpy seed; outputs are not
compared here (each op's own test file does that).
"""
import numpy as np
import pytest
import torch

from fastmath_tpu.ops import _routing as J

import fastmath_tpu_torch as T
from fastmath_tpu_torch import kernels as K
from fastmath_tpu_torch.kernels import eig as KEIG
from fastmath_tpu_torch.kernels import expm as KE
from fastmath_tpu_torch.kernels import logm as KL
from fastmath_tpu_torch.ops import _routing as R

from _torch_cpu import one_thread  # noqa: F401  (autouse)

B = 5  # problems in each batch


def _spd(rng, b, n):
    a = rng.standard_normal((b, n, n))
    return torch.tensor(a @ a.transpose(0, 2, 1) + n * np.eye(n))


def test_decision_table(monkeypatch):
    kw = dict(supported=True, batch=100, family="sym_solve", n=4)
    for on_card in (False, True):
        assert R.use_kernel("torch", on_card=on_card, **kw) is False
    assert R.use_kernel("cuda", on_card=True, **kw) is True
    with pytest.raises(ValueError, match="CUDA"):
        R.use_kernel("cuda", on_card=False, **kw)
    with pytest.raises(ValueError, match="the op kernel serves N <= 32"):
        R.use_kernel("cuda", supported=False, batch=100, on_card=True, family="sym_solve",
                     n=33, why_unsupported="the op kernel serves N <= 32")
    for bad in ("pallas", "xla", "CUDA", ""):
        with pytest.raises(ValueError, match="backend must be one of"):
            R.use_kernel(bad, on_card=True, **kw)
    assert R.use_kernel("auto", on_card=False, **kw) is False
    assert R.use_kernel("auto", supported=False, batch=100, on_card=True,
                        family="sym_solve", n=4) is False
    # a family named in MIN_BATCH: each step's least batch up to its size,
    # nothing above the last; the others at every batch
    monkeypatch.setitem(R.MIN_BATCH, "sym_solve", ((4, 1), (16, 64)))
    for n, batch, want in ((4, 1, True), (5, 63, False), (5, 64, True), (16, 100, True),
                           (17, 1 << 40, False)):
        assert R.use_kernel("auto", supported=True, batch=batch, on_card=True,
                            family="sym_solve", n=n) is want
    assert R.use_kernel("auto", supported=True, batch=1, on_card=True, family="batchinv",
                        n=32) is True


@pytest.mark.parametrize("family, cap", [("batchmatvec", "MATVEC_KERNEL_MAX"),
                                         ("batchmatmul", "MATMUL_KERNEL_MAX")])
def test_product_n_ranges(family, cap):
    """Each step of a product's policy from its least batch on, not below;
    above its cap torch.matmul under auto at any batch, while ``"cuda"``
    still takes the kernel there."""
    steps = R.MIN_BATCH[family]
    top = getattr(R, cap)
    assert top == steps[-1][0] <= 32 and steps[0][1] == 1
    assert [s for s, _ in steps] == sorted({s for s, _ in steps})
    kw = dict(family=family, supported=True, on_card=True)
    lo = 1
    for size, least in steps:
        for n in (lo, size):
            assert R.threshold(family, n) == least
            assert R.use_kernel("auto", n=n, batch=least, **kw) is True
            assert R.use_kernel("auto", n=n, batch=least - 1, **kw) is False
        lo = size + 1
    assert R.threshold(family, top + 1) is None
    assert R.use_kernel("auto", n=top + 1, batch=1 << 40, **kw) is False
    assert R.use_kernel("cuda", n=top + 1, batch=1, **kw) is True


def test_logm_eig_route():
    lo, hi = R.LOGM_SYM_EIG_MIN_D, R.LOGM_SYM_EIG_MAX_D
    assert not R.logm_eig_route(lo - 1) and R.logm_eig_route(lo)
    assert R.logm_eig_route(hi) and not R.logm_eig_route(hi + 1)
    assert R.BACKENDS == ("auto", "cuda", "torch")


def _calls(rng, n):
    """(family, call) of every public op with a kernel on a CPU batch of B
    problems of size n."""
    full = _spd(rng, B, n)
    mat = T.full_to_sym(full)
    vec = torch.tensor(rng.standard_normal((B, n)))
    rnd = torch.tensor(rng.standard_normal((B, n, n)))
    small = 0.25 * rnd
    return [
        ("sym_solve", lambda: T.sym_solve(mat, vec)),
        ("sym_solve_chain", lambda: T.sym_solve_chain(mat, vec, 3)),
        ("sym_matvec", lambda: T.sym_matvec(mat, vec)),
        ("sym_submatvec", lambda: T.sym_submatvec(vec, mat, vec)),
        ("sym_outer", lambda: T.sym_outer(vec)),
        ("sym_matmul", lambda: T.sym_matmul(rnd, mat)),
        ("sym_matvec_chain", lambda: T.sym_matvec_chain(0.1 * mat, vec, 3)),
        ("sym_maxeig", lambda: T.sym_maxeig(mat, iters=3)),
        ("sym_det", lambda: T.sym_det(mat)),
        ("sym_invert", lambda: T.sym_invert(mat)),
        ("batchinv", lambda: T.batchinv(full)),
        ("batchdet", lambda: T.batchdet(full)),
        ("batchlogdet", lambda: T.batchlogdet(full)),
        ("batchlmdiv", lambda: T.batchlmdiv(full, vec)),
        ("batchchol", lambda: T.batchchol(full)),
        ("batchmatvec", lambda: T.batchmatvec(rnd, vec)),
        ("batchmatmul", lambda: T.batchmatmul(rnd, full)),
        ("eig_sym", lambda: T.eig_sym(rnd + rnd.mT)),
        ("expm", lambda: T.expm(small)),
        ("logm", lambda: T.logm(T.expm(small, backend="torch"))),
    ]


def _counters():
    names = ["sym_solve_cf", "sym_solve_chain_cf", "sym_matvec_cf", "sym_addmatvec_cf",
             "sym_submatvec_cf", "sym_outer_cf", "sym_matmul_cf", "sym_matvec_chain_cf",
             "sym_maxeig_cf", "sym_det_cf", "sym_invert_cf", "inv_cf", "det_cf", "logdet_cf",
             "chol_cf", "solve_full_cf", "matvec_full_cf", "matmul_cf"]
    return [getattr(K, n) for n in names] + [KEIG.eig_unrolled, KEIG.eig_rolled,
                                             KE.expm_unrolled, KE.expm_warp,
                                             KL.logm_unrolled, KL.logm_warp]


@pytest.mark.parametrize("n", [3, 6])
def test_public_ops_ask_the_policy(rng, monkeypatch, n):
    """Each op asks ``use_kernel`` with its family, its size and its
    batch; on CPU tensors the answer is no and nothing launches."""
    asked = []

    def spy(backend, **kw):
        asked.append((kw["family"], kw["batch"], kw["n"], kw["on_card"]))
        return R.use_kernel(backend, **kw)

    from fastmath_tpu_torch.ops import lie, sym
    monkeypatch.setattr(sym, "use_kernel", spy)
    monkeypatch.setattr(lie, "use_kernel", spy)
    before = [c.launches for c in _counters()]
    for family, call in _calls(rng, n):
        asked.clear()
        call()
        mine = [a for a in asked if a[0] == family]
        assert mine, (family, asked)
        assert all(a[1] == B and a[2] == n and a[3] is False for a in mine), (family, mine)
    assert [c.launches for c in _counters()] == before


@pytest.mark.parametrize("call", [
    lambda m, v, f: T.sym_solve(m, v, backend="cuda"),
    lambda m, v, f: T.sym_matvec(m, v, backend="cuda"),
    lambda m, v, f: T.batchinv(f, backend="cuda"),
    lambda m, v, f: T.batchchol(f, backend="cuda"),
    lambda m, v, f: T.batchmatvec(f, v[..., :f.shape[-1]], backend="cuda"),
    lambda m, v, f: T.eig_sym(f, backend="cuda"),
    lambda m, v, f: T.expm(f, backend="cuda"),
], ids=["sym_solve", "sym_matvec", "batchinv", "batchchol", "batchmatvec", "eig_sym", "expm"])
def test_cuda_backend_errors(rng, call):
    full = _spd(rng, B, 4)
    mat, vec = T.full_to_sym(full), torch.tensor(rng.standard_normal((B, 4)))
    with pytest.raises(ValueError, match="CUDA"):
        call(mat, vec, full)
    big = _spd(rng, 2, 33)
    with pytest.raises(ValueError, match="kernel serves"):
        call(T.full_to_sym(big), torch.ones(2, 33, dtype=big.dtype), big)
    with pytest.raises(ValueError, match="backend must be one of"):
        T.sym_solve(mat, vec, backend="pallas")


@pytest.mark.parametrize("shapes", [
    [(7, 3)], [(2, 5, 3), (5, 4)], [(1, 6, 10), (3, 1, 4)], [(4,), (9, 4)], [(8, 2, 1, 6), (3, 6)],
])
def test_nbatch_against_jax(shapes):
    got = R.nbatch(*(torch.empty(s) for s in shapes))
    assert got == J.nbatch(*(np.empty(s) for s in shapes))
    # the same from batch shapes, and from (..., n, n) matrices with core=2
    assert R.nbatch(*(s[:-1] for s in shapes)) == got
    assert R.nbatch(*(torch.empty(*s, 2) for s in shapes), core=2) == got


def test_nbatch_rejects_shapes_that_do_not_broadcast():
    with pytest.raises(ValueError, match="broadcast"):
        R.nbatch(torch.empty(3, 4), torch.empty(5, 4))


def test_old_names_are_the_policys():
    from fastmath_tpu_torch.ops import batched, lie, sym

    assert batched.MATVEC_KERNEL_MAX is R.MATVEC_KERNEL_MAX
    assert batched.MATMUL_KERNEL_MAX is R.MATMUL_KERNEL_MAX
    assert lie._LOGM_SYM_EIG_MIN_D is R.LOGM_SYM_EIG_MIN_D
    assert lie._LOGM_SYM_EIG_MAX_D is R.LOGM_SYM_EIG_MAX_D
    assert sym.BACKENDS is R.BACKENDS
    # the products take their kernels at every batch where their plain
    # versions are unrolled
    assert batched._MATMUL_UNROLL_MAX == R.MIN_BATCH["batchmatmul"][0][0]
    assert batched._CLOSED_FORM_MAX == R.MIN_BATCH["batchmatvec"][0][0]
