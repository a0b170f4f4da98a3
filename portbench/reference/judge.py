"""The numbers that decide ``correct``: the program's answers read against
the reference's own geometry, boundary conditions, stiffness and yield
function, in float64.

A return map is judged by what defines it, not by a second run that could
leave the tolerance band on another trip:

* ``identity``: every update it makes keeps sig + C depl = sig0 + C deps
  (each cutting-plane trip and the radial fallback move stress and
  plastic strain along the same direction), max-norm over sy;
* ``outside_share``: the share of rows whose yield value, in the band's
  units, lies above twice the band, or below minus twice the band where
  plastic strain was booked;
* ``yield_gap`` (return maps alone): the largest gap between the yield
  value the program returns and the reference's at the returned state.

A load history is judged at its end: the identity over the whole history
against the strain the program booked (sig + C epl = C eps), that strain
against the strain of the final displacement (``strain``: max-norm over
the applied strain; the float32 displacements of a fine mesh set its
floor), ``outside_share`` of the final state, the prescribed
displacements (``bc``, over the applied strain times the edge length),
the equilibrium of the final stresses (``equilibrium``: the internal
force on the free dofs over the reaction on the fixed ones) and
``glob_sig`` (the reported mean stress against the mean of the final
stresses, over sy).  Where the run hands over its last round's tangent
field and displacement increment, ``linear_residual`` reads the linear
solve: the free-dof force of that increment under that tangent over the
reaction, with the reference's geometry and BCs; and ``start_tangent``
the first round's tangent against the elastic stiffness.

A return map is also held to the reference's own (``response`` in
float64 from the same inputs) on the rows where both end inside the band
(or both elastic): ``stress_gap`` (max-norm over sy) and ``depl_gap``
(over sy / C11), each the largest over those rows of the gap less its
part along the reference's last return direction (C a for stresses, a
for plastic strains), which a trip more or less moves by up to a band's
worth; and ``tangent_gap``, the ``TANGENT_QUANTILE`` quantile over those
rows of the tangents' gap (Frobenius over C's).
"""
import torch

from . import returnmap as rm

#: the share of a batch's settled rows whose tangent is held to the
#: reference's: the tangent jumps from C to the plastic one where a trial
#: value sits on the band's edge, and between the path secant and the
#: substep tangent where w . deps changes sign, so rounding moves a few
#: rows in a million by 0.1-0.5 of |C|
TANGENT_QUANTILE = 0.999


def _f64(t, device):
    return t.detach().to(device=device, dtype=torch.float64)


def _outside_share(crit, sig, epl, depl):
    _, fn = rm.yield_value(crit, sig, epl)
    band = 2. * crit.yf_tol
    plastic = (depl != 0.).any(-1)
    out = (fn > band) | (plastic & (fn < -band))
    return float(out.double().mean())


def tangent_rows(T, nel):
    """A tangent field as rows (Nel, 6, 6) float64: rows pass through,
    planes (36, ...) over the elements (x slowest) are transposed."""
    if T.shape[0] == 36 and T.dim() > 2:
        T = T.reshape(36, nel).T
    return T.reshape(nel, 6, 6).to(torch.float64)


def linear_numbers(grid, C, fixed, T_first, T_last, du_last):
    """``start_tangent`` (the first round's tangent against C, Frobenius
    over C's, worst element) and ``linear_residual`` (the largest
    free-dof force of the last round's increment under that round's
    tangent, over the largest reaction on a fixed dof; no body force)."""
    dev = grid.device
    C = torch.as_tensor(C, dtype=torch.float64, device=dev)
    T0 = tangent_rows(T_first.to(dev), grid.nel)
    start = float(torch.linalg.matrix_norm(T0 - C).max()) / float(
        torch.linalg.matrix_norm(C))
    del T0
    T = tangent_rows(T_last.to(dev), grid.nel)
    q = grid.k_apply(T, _f64(du_last, dev).reshape(-1))
    del T
    res = float(q[~fixed].abs().max()) / max(float(q[fixed].abs().max()),
                                               1e-300)
    return dict(start_tangent=start, linear_residual=res)


def judge_solve(grid, crit, C, axis, eps, u, sig, epl, eps_el, glob_sig,
                last=None):
    """Numbers of one load history's final state (u (ndof,); sig, epl and
    the booked strain eps_el (Nel, 6); the reported glob_sig (6,)) against
    the prescribed strain ``eps`` along ``axis``; with ``last`` (the first
    round's tangent ``T_first``, the last round's ``T_last`` and
    ``du_last``) also ``linear_numbers``."""
    dev = grid.device
    u, sig, epl, eps_el, glob_sig = (_f64(t, dev).reshape(s) for t, s in (
        (u, (-1,)), (sig, (-1, 6)), (epl, (-1, 6)), (eps_el, (-1, 6)),
        (glob_sig, (-1,))))
    C = torch.as_tensor(C, dtype=torch.float64, device=dev)
    fixed, val = grid.uniaxial_bcs(axis, eps)
    bc = float((u[fixed] - val[fixed]).abs().max()) / (
        float(eps) * grid.lengths[axis])
    ident = float((sig + (epl - eps_el) @ C.T).abs().max()) / crit.sy
    strain = float((eps_el - grid.strain(u)).abs().max()) / float(eps)
    fint = grid.internal_force(sig)
    equil = float(torch.linalg.vector_norm(fint[~fixed])) / max(
        float(torch.linalg.vector_norm(fint[fixed])), 1e-300)
    glob = float((glob_sig - sig.mean(0)).abs().max()) / crit.sy
    out = dict(identity=ident, strain=strain, outside_share=_outside_share(
        crit, sig, epl, epl), bc=bc, equilibrium=equil, glob_sig=glob)
    if last is not None:
        del u, sig, epl, eps_el, fint
        out.update(linear_numbers(grid, C, fixed, **last))
    return out


def _off_direction(gap, d):
    """The max-norm of each row of ``gap`` less its part along ``d``."""
    n = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(
        1e-300)
    return (gap - (gap * n).sum(-1, keepdim=True) * n).abs().amax(-1)


def _worst(x, rows):
    """The largest of ``x`` over ``rows``, 0 over none."""
    return float(torch.where(rows, x, 0.).max())


def _settled(crit, f, depl, epl):
    """Rows that end inside the band, or elastic below it."""
    fn = f if crit.kind == 'svc' else f / (crit.sy + crit.khard * rm.eps_eq(
        epl))
    elastic = (depl == 0.).all(-1)
    return (fn <= crit.yf_tol) & ((fn >= -crit.yf_tol) | elastic)


def judge_return_map(crit, C, sig0, epl0, deps, f, sig, depl, tan, device,
                     maxiter=12):
    """Numbers of one batch of return maps: inputs (sig0, epl0, deps),
    the program's (f, sig, depl, tangent)."""
    sig0, epl0, deps, f, sig, depl, tan = (_f64(t, device) for t in (
        sig0, epl0, deps, f, sig, depl, tan))
    C = torch.as_tensor(C, dtype=torch.float64, device=device)
    ident = float((sig + depl @ C.T - sig0 - deps @ C.T).abs().max()) \
        / crit.sy
    epl = epl0 + depl
    fr, _ = rm.yield_value(crit, sig, epl)
    scale = 1. if crit.kind == 'svc' else crit.sy + crit.khard * rm.eps_eq(
        epl)
    gap = float(((f - fr) / scale).abs().max())
    out = dict(identity=ident,
               outside_share=_outside_share(crit, sig, epl, depl),
               yield_gap=gap)
    del fr
    f_r, sig_r, depl_r, tan_r = rm.response(crit, sig0, epl0, deps, C,
                                            maxiter)
    both = _settled(crit, f, depl, epl) & _settled(crit, f_r, depl_r,
                                                   epl0 + depl_r)
    _, a, _, _ = rm.f_grad(crit, sig_r, epl0 + depl_r)
    eps_y = crit.sy / float(C.abs().max())
    dt = (torch.linalg.matrix_norm(tan - tan_r) / float(
        torch.linalg.matrix_norm(C)))[both]
    out.update(
        stress_gap=_worst(_off_direction(sig - sig_r, a @ C.T), both)
        / crit.sy,
        depl_gap=_worst(_off_direction(depl - depl_r, a), both) / eps_y,
        tangent_gap=float(torch.quantile(dt.float(), TANGENT_QUANTILE))
        if dt.numel() else 0.)
    return out
