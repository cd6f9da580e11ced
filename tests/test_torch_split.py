"""The card's potrf/trsm split and strided-operand copies, on the CPU.

The kernel wrappers (``repro_torch.kernels.ops``) split ``potrf``/``trsm``
of ``n`` over 256 into fixed tiles, and copy an operand the kernels cannot
read, only on the kernel path — for CUDA tensors. Here ``ops.on_cuda`` is
made to answer True for CPU tensors, and a stub kernel library stands in
for the kernels: it records every launch (name, operand shapes and
layouts) and computes it with the kernel's plain version, as the
operators' CPU implementation looks the plain functions up at each call.
So the tests see the split's order, tile sizes, launch counts
(``ops.split_launches``) and copies, and hold its values against the
unsplit plain factor and float64.
"""

import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.obs import metrics

# the kernel modules (the package binds their names to the ops wrappers)
gemm_mod, potrf_mod, syrk_mod, trsm_mod = (
    importlib.import_module(f"repro_torch.kernels.{name}")
    for name in ("gemm_tn", "potrf", "syrk", "trsm"))


class StubLibrary:
    """Records each kernel call, then runs the plain version."""

    def __init__(self, monkeypatch):
        self.calls = []
        for mod, name in ((potrf_mod, "potrf_plain"), (trsm_mod, "trsm_plain"),
                          (syrk_mod, "syrk_plain"), (gemm_mod, "gemm_tn_plain")):
            monkeypatch.setattr(mod, name, self._recorder(name[:-6], getattr(mod, name)))
        monkeypatch.setattr(ops, "on_cuda", lambda *tensors: True)

    def _recorder(self, kernel, plain):
        def call(*args, **kw):
            tensors = [x for x in args if isinstance(x, torch.Tensor)]
            self.calls.append((kernel, [tuple(x.shape) for x in tensors],
                               [x.stride() for x in tensors], kw.get("transpose")))
            return plain(*args, **kw)
        return call

    def counts(self):
        out = {}
        for kernel, *_ in self.calls:
            out[kernel] = out.get(kernel, 0) + 1
        return out


def _spd(n, batch=(), seed=0):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((*batch, n + 16, n))
    return np.einsum("...kn,...km->...nm", g, g) / n + 0.5 * np.eye(n)


def _tile_contiguous(shape, stride):
    n = shape[-1]
    return stride[-1] == 1 and (len(shape) < 2 or shape[-2] <= 1 or stride[-2] == n)


@pytest.mark.parametrize("n", [384, 512])
def test_potrf_splits_into_fixed_tiles_in_order(monkeypatch, n):
    a64 = _spd(n)
    stub = StubLibrary(monkeypatch)
    a = torch.as_tensor(a64, dtype=torch.float32)
    got = ops.potrf(a)
    r = n - ops.TILE
    assert [(k, shapes) for k, shapes, _, _ in stub.calls] == [
        ("potrf", [(256, 256)]),
        ("trsm", [(256, 256), (r, 256)]),
        ("syrk", [(256, r)]),            # the once-copied L21ᵀ: 256 rows, unsplit
        ("potrf", [(r, r)]),
    ]
    assert stub.counts() == ops.split_launches("potrf", n)
    for kernel, shapes, strides, _ in stub.calls:   # every kernel operand as a kernel reads it
        assert all(_tile_contiguous(s, st) for s, st in zip(shapes, strides)), kernel
    whole = potrf_mod.potrf_plain(a)
    exact = np.linalg.cholesky(a64)
    assert torch.allclose(got, whole, rtol=0, atol=1e-5 * float(whole.abs().max()))
    assert np.abs(got.double().numpy() - exact).max() < 1e-5 * np.abs(exact).max()
    assert torch.equal(got, torch.tril(got))


def test_potrf_split_recurses_over_three_tiles_and_keeps_the_batch(monkeypatch):
    n = 700
    stub = StubLibrary(monkeypatch)
    a = torch.as_tensor(_spd(n, (2,)), dtype=torch.float32)
    got = ops.potrf(a)
    assert [k for k, *_ in stub.calls] == ["potrf", "trsm", "syrk", "potrf", "trsm", "syrk",
                                           "potrf"]
    assert all(shapes[0][0] == 2 for _, shapes, _, _ in stub.calls)   # one launch a stack
    assert stub.counts() == ops.split_launches("potrf", n) == {"potrf": 3, "trsm": 2,
                                                                 "syrk": 2}
    assert [shapes[0][-1] for k, shapes, _, _ in stub.calls if k == "potrf"] == [256, 256, 188]
    exact = np.linalg.cholesky(_spd(n, (2,)))
    assert np.abs(got.double().numpy() - exact).max() < 1e-5 * np.abs(exact).max()


@pytest.mark.parametrize("transpose", [True, False])
@pytest.mark.parametrize("n", [384, 512])
def test_trsm_splits_forward_or_backward(monkeypatch, n, transpose):
    rng = np.random.default_rng(1)
    l64 = np.linalg.cholesky(_spd(n))
    b64 = rng.standard_normal((40, n))
    stub = StubLibrary(monkeypatch)
    l = torch.as_tensor(l64, dtype=torch.float32)
    b = torch.as_tensor(b64, dtype=torch.float32)
    got = ops.trsm(l, b, transpose=transpose)
    r = n - ops.TILE
    first, last = ((256, 256), (r, r)) if transpose else ((r, r), (256, 256))
    assert [(k, shapes[0]) for k, shapes, _, _ in stub.calls] == [
        ("trsm", first), ("gemm_tn", (first[0], 40)), ("trsm", last)]
    assert all(t == transpose for k, _, _, t in stub.calls if k == "trsm")
    assert stub.counts() == ops.split_launches("trsm", n)
    for kernel, shapes, strides, _ in stub.calls:
        if kernel == "trsm":
            assert all(_tile_contiguous(s, st) for s, st in zip(shapes, strides))
        else:
            assert all(st[-1] == 1 for st in strides)
    # X·Lᵀ = B  ⇔  X = B·L⁻ᵀ;   X·L = B  ⇔  X = B·L⁻¹
    exact = b64 @ np.linalg.inv(l64.T if transpose else l64)
    whole = trsm_mod.trsm_plain(l, b, transpose=transpose)
    assert np.abs(got.double().numpy() - exact).max() < 1e-4 * np.abs(exact).max()
    assert torch.allclose(got, whole, rtol=0, atol=1e-4 * float(whole.abs().max()))


def test_the_cpu_path_does_not_split(monkeypatch):
    """A CPU tensor runs the plain version whole, as before."""
    calls = []
    plain = potrf_mod.potrf_plain
    monkeypatch.setattr(potrf_mod, "potrf_plain",
                        lambda a, **kw: calls.append(tuple(a.shape)) or plain(a, **kw))
    ops.potrf(torch.as_tensor(_spd(512), dtype=torch.float32))
    assert calls == [(512, 512)]


def test_a_strided_operand_is_copied_once_and_counted(monkeypatch):
    stub = StubLibrary(monkeypatch)
    rng = np.random.default_rng(2)
    a = torch.as_tensor(rng.standard_normal((64, 32)), dtype=torch.float32)
    bt = torch.as_tensor(rng.standard_normal((8, 64)), dtype=torch.float32).T   # column stride 64
    before = metrics.get("kernels.copy.gemm_tn")
    got = ops.gemm_tn(a, bt)
    assert metrics.get("kernels.copy.gemm_tn") == before + 1
    assert stub.calls[0][2][1] == (8, 1)                 # the kernel read the copy
    assert torch.equal(got, gemm_mod.gemm_tn_plain(a, bt.contiguous()))
    # a row-strided view (unit column stride) is read in place: no copy
    ops.gemm_tn(a[::2], bt[::2].contiguous())
    assert metrics.get("kernels.copy.gemm_tn") == before + 1
    # potrf of a transposed (non-contiguous) tile, trsm of a strided panel
    s = torch.as_tensor(_spd(64), dtype=torch.float32).T
    p0, t0 = metrics.get("kernels.copy.potrf"), metrics.get("kernels.copy.trsm")
    l = ops.potrf(s)
    assert metrics.get("kernels.copy.potrf") == p0 + 1
    ops.trsm(l, torch.as_tensor(rng.standard_normal((64, 8)), dtype=torch.float32).T)
    assert metrics.get("kernels.copy.trsm") == t0 + 1
    # an expanded factor (batch stride 0, each tile contiguous) is not copied
    ops.trsm(l.expand(3, 64, 64), torch.zeros((3, 5, 64)))
    assert metrics.get("kernels.copy.trsm") == t0 + 1


@pytest.mark.parametrize("bn", [384, 512])
def test_shampoo_p2_split_against_unsplit(monkeypatch, bn):
    """What the split alone does to Shampoo p = 2 at ``gram_block`` over
    256 (the card's path, ``test_torch_cuda.py::
    test_shampoo_p2_at_wide_gram_blocks``), on the plain versions: every
    refresh splits its 384- or 512-wide tiles, each split factor lies
    within 1e-5 (normwise) of the float64 factor of its ridged stats, and
    the updates move against the unsplit run by less than the card-vs-CPU
    band of 2e-3 (normwise; 1.70e-3 and 1.65e-3 at step 1 for 384 and 512,
    1.1–1.3e-3 after: the preconditioner of a rank-deficient stat
    amplifies the factor's rounding)."""
    from repro_torch.optim import _tree, constant, shampoo

    rng = np.random.default_rng(bn + 1)
    params = {"w": torch.as_tensor(rng.standard_normal((768, 640)), dtype=torch.float32)}
    grads = [{"w": torch.as_tensor(rng.standard_normal((768, 640)), dtype=torch.float32)}
             for _ in range(3)]

    def run():
        opt = shampoo(constant(1e-2), block=1024, update_every=1, precond_p=2,
                      packed_grams=True, gram_block=bn, n_base=512)
        st = opt.init(params)
        us = []
        for g in grads:
            u, st = opt.update(g, st, params)
            us.append(u["w"])
        return us, st["shampoo"]["w"]

    # one thread: the walk is thousands of small ops, which thread pools
    # oversubscribed by parallel test workers slow a hundredfold
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        whole, _ = run()
        stub = StubLibrary(monkeypatch)
        split, w = run()
    finally:
        torch.set_num_threads(threads)
    assert stub.counts()["potrf"] >= 3 * ops.split_launches("potrf", bn)["potrf"]
    assert max(shapes[0][-1] for k, shapes, _, _ in stub.calls if k == "potrf") <= ops.TILE
    for stat, factor in ((w["l"], w["pl"]), (w["r"], w["pr"])):
        g = stat.to_dense().double()
        d = g.shape[-1]
        ridge = 1e-6 * (torch.diagonal(g, dim1=-2, dim2=-1).sum(-1) / d + 1e-30) + 1e-30
        l64 = torch.linalg.cholesky(g + ridge[:, None, None] * torch.eye(d, dtype=torch.float64))
        diff = factor.to_dense().double() - l64
        assert float(torch.linalg.norm(diff) / torch.linalg.norm(l64)) <= 1e-5
    for x, y in zip(split, whole):
        assert torch.isfinite(x).all()
        rel = float(torch.linalg.norm(x.double() - y.double()) / torch.linalg.norm(y.double()))
        assert 0 < rel <= 2e-3
