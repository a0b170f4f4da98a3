"""PyTorch port: the CUDA kernels on the card (marker ``cuda``).

These skip without an NVIDIA card.  On the card (where JAX is absent, so
the suite's conftest cannot load) run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from pylabfea_tpu_torch.ops import fe_kernels as fek
from pylabfea_tpu_torch.ops import stencil
from pylabfea_tpu_torch.ops import svc_kernels as sk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card with CUDA')
    return torch.device('cuda', 0)


def _kp(NX, NY, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    md = fek.rect_mesh(NX, NY, LX=1., LY=1.5, dtype=dtype, device=device)
    els = torch.as_tensor(rng.uniform(0.5, 2., (36, NX, NY)) * 1e5,
                          dtype=dtype, device=device)
    u = [torch.as_tensor(rng.normal(size=(NX + 1, NY + 1)), dtype=dtype,
                         device=device) for _ in range(2)]
    return fek.element_stiffness_planes(md, els), u[0], u[1]


@pytest.mark.parametrize('dtype,rtol', [(torch.float32, 2e-6),
                                        (torch.float64, 1e-14)])
@pytest.mark.parametrize('NX,NY', [(33, 17), (1, 1), (64, 128)])
def test_k_apply_kernel_matches_plain(cuda, NX, NY, dtype, rtol):
    Kp, u0, u1 = _kp(NX, NY, dtype, cuda)
    n0 = stencil.k_apply.launches
    out = stencil.k_apply(Kp, u0, u1)
    torch.cuda.synchronize()
    assert stencil.k_apply.launches == n0 + 1
    for o, r in zip(out, stencil.k_apply_plain(Kp, u0, u1)):
        assert float((o - r).abs().max()) <= rtol * float(r.abs().max())


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 2e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize('n,nsv', [(1, 3), (1000, 300)])
def test_svc_kernel_matches_plain(cuda, n, nsv, dtype, tol):
    rng = np.random.default_rng(1)
    x, sv = (torch.as_tensor(rng.normal(size=s) * 0.7, dtype=dtype,
                             device=cuda) for s in ((n, 6), (nsv, 6)))
    dc = torch.as_tensor(rng.uniform(-1., 1., nsv), dtype=dtype, device=cuda)
    m0 = sk.svc_f_grad.launches
    f, g = sk.svc_f_grad(x, sv, dc, 2.5, 0.3)
    f0, g0 = sk.svc_f_grad(x, sv, dc, 2.5, 0.3, with_grad=False)
    torch.cuda.synchronize()
    assert sk.svc_f_grad.launches == m0 + 2 and g0 is None
    fr, gr = sk.svc_f_grad_plain(x.double(), sv.double(), dc.double(), 2.5,
                                 0.3)
    bound = tol * max(1., float(dc.abs().sum()))
    assert float((f.double() - fr).abs().max()) <= bound
    assert float((f0.double() - fr).abs().max()) <= bound
    gbound = bound * 2. * 2.5 * float(x.abs().max() + sv.abs().max())
    assert float((g.double() - gr).abs().max()) <= gbound


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    Kp, u0, u1 = _kp(8, 6, torch.float32, cuda)
    with pytest.raises(ValueError):
        stencil.k_apply(Kp, u0.T.contiguous().T, u1)     # not contiguous
    with pytest.raises(TypeError):
        stencil.k_apply(Kp, u0.double(), u1)
    with pytest.raises(ValueError):
        stencil.k_apply(Kp, u0[:-1].contiguous(), u1)
    x = torch.zeros(4, 5, device=cuda)
    with pytest.raises(ValueError):
        sk.svc_f_grad(x, torch.zeros(3, 5, device=cuda),
                      torch.zeros(3, device=cuda), 1., 0.)
    with pytest.raises(TypeError):
        sk.svc_f_grad(torch.zeros(4, 6, device=cuda),
                      torch.zeros(3, 6, device=cuda, dtype=torch.float64),
                      torch.zeros(3, device=cuda), 1., 0.)
