"""PyTorch port: the 2-D MG-CG carries both displacement planes as one
stacked (2, nnX, nnY) tensor.  Two guards of that layout on a 64 x 64 mesh
(4 levels, the dense bottom at 8 x 8): the operations one CG iteration
dispatches, and the calls of kernel B (``stencil.k_apply``) it makes,
which the benchmark's roofline of B counts call by call."""
import functools

import pytest
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from pylabfea_tpu_torch import convert
from pylabfea_tpu_torch.ops import fe_kernels as tfek
from pylabfea_tpu_torch.ops import multigrid as tmg
from pylabfea_tpu_torch.ops import stencil as tst

torch.set_num_threads(1)

N = 64

#: operations (B counted as one) of the second CG iteration of
#: ``_solve_iterations`` when the solver carried the planes as a (ux, uy)
#: tuple, counted by ``_OpCount`` at commit e8bf28c
TUPLE_OPS = 302


def _problem():
    CV = convert.elastic_cv(200.e3, 0.3)
    md = tfek.rect_mesh(N, N, uniax='y', eps_tot=0.001, dtype=torch.float64,
                        device='cpu')
    els = torch.as_tensor(CV).reshape(36, 1, 1).expand(36, N, N).contiguous()
    levels = tmg.build_hierarchy(md, els)
    b = torch.randn((2, N + 1, N + 1), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    return levels, b.masked_fill(md.fixed, 0.), torch.zeros_like(b)


def _storages(obj):
    return {t.untyped_storage().data_ptr()
            for t in _pytree.tree_leaves(obj) if isinstance(t, torch.Tensor)}


class _OpCount(TorchDispatchMode):
    """Counts the dispatched ATen operations that write in place or return
    a tensor on new storage (no views); kernel B counts as the one launch
    it is on the card, its plain CPU version's operations not at all."""

    def __init__(self):
        super().__init__()
        self.n = 0
        self.inside_b = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        writes = any(r.alias_info is not None and r.alias_info.is_write
                     for r in func._schema.returns)
        if not self.inside_b and (
                writes or _storages(out) - _storages((args, kwargs))):
            self.n += 1
        return out

    def k_apply(self, orig):
        @functools.wraps(orig)
        def wrapper(Kp, u0, u1):
            self.n += 1
            self.inside_b = True
            try:
                return orig(Kp, u0, u1)
            finally:
                self.inside_b = False
        return wrapper


def _solve_iterations(levels, b, x0, it):
    x, _, done = tmg.mg_cg_solve(levels, b, x0, tol=0., maxiter=it)
    assert done == it and x.shape == b.shape


def test_cg_iteration_ops_at_most_half_of_the_tuple_layout(monkeypatch):
    """One CG iteration after the first dispatches at most half the
    operations it did with the planes as a tuple: each elementwise step,
    mask, transfer and reduction is one operation for both planes."""
    levels, b, x0 = _problem()
    assert len(levels) == 4
    counts = []
    for it in (1, 2):
        mode = _OpCount()
        monkeypatch.setattr(tst, 'k_apply', mode.k_apply(tst.k_apply))
        with mode:
            _solve_iterations(levels, b, x0, it)
        monkeypatch.undo()
        counts.append(mode.n)
    per_iter = counts[1] - counts[0]
    assert 0 < per_iter <= TUPLE_OPS // 2, per_iter


@pytest.mark.parametrize('smoother, per_level', [('jacobi', 4),
                                                 ('chebyshev', 6)])
def test_cg_iteration_calls_kernel_b_once_a_launch(monkeypatch, smoother,
                                                   per_level):
    """Every apply of an iteration is one call of ``stencil.k_apply`` with
    contiguous planes, as the benchmark's probe counts B's work: 1 (the CG
    apply) + 4 a level above the bottom under Jacobi, + 6 under Chebyshev
    (nu = 2), and one more for the start's residual."""
    monkeypatch.setattr(tmg, 'SMOOTHER', smoother)
    levels, b, x0 = _problem()
    calls = []
    orig = tst.k_apply

    @functools.wraps(orig)
    def probe(Kp, u0, u1):
        assert u0.is_contiguous() and u1.is_contiguous()
        assert u0.shape == u1.shape == (Kp.shape[2] + 1, Kp.shape[3] + 1)
        calls.append(Kp.shape[2])
        return orig(Kp, u0, u1)

    monkeypatch.setattr(tst, 'k_apply', probe)
    counts = []
    for it in (1, 2):
        calls.clear()
        _solve_iterations(levels, b, x0, it)
        counts.append(len(calls))
    per_iter = 1 + per_level * (len(levels) - 1)
    assert counts == [1 + per_iter, 1 + 2 * per_iter]
