"""The least time a kernel's work needs on the card, and its share of the
time it took.

Peaks of one H100 SXM (NVIDIA's data sheet, at its 700 W limit): 3.35 TB/s
of HBM3, 67 TFLOP/s float32 and 34 TFLOP/s float64 outside the tensor
cores.  A launch's least time is the larger of its bytes over the
bandwidth and its operations over the peak; bytes count each input read
once and each output written once, operations what these inputs need,
whatever implements them (the counts of the program's ``chip_smoke.py``
phase 3).  A share is the summed least time of a kernel's launches in the
profiled window over their summed device time.
"""
import math
from dataclasses import dataclass

HBM_BPS = 3.35e12
PEAK_FLOPS = {4: 67.e12, 8: 34.e12}


def least_seconds(nbytes, flops, itemsize):
    """(seconds, 'bytes' | 'operations') of one launch."""
    tb, tf = nbytes / HBM_BPS, flops / PEAK_FLOPS[itemsize]
    return (tb, 'bytes') if tb >= tf else (tf, 'operations')


def kapply2d_work(Kp, u0, u1):
    """Kernel B, K u on an NX x NY grid: the (8, 8, NX, NY) stiffness
    planes and two nodal planes read, two written; one multiply-add per
    stiffness entry."""
    nn = u0.numel()
    return [((Kp.numel() + 4 * nn) * Kp.element_size(), 2 * Kp.numel(),
             Kp.element_size())]


def svc_fgrad_work(x, sv, dc, gamma, rho, with_grad=True):
    """Kernel A, the SVC decision function and its gradient at N points:
    x, sv and dc read, f (and g) written; per point and SV, F subtracts
    and F multiply-adds of the distance, the gamma product, the exp, the
    dc product and the sum, and F multiply-adds of the gradient."""
    N, F = x.shape
    nsv = sv.shape[0]
    if N == 0:
        return []
    g = 2 if with_grad else 1
    return [((g * N * F + N + nsv * (F + 1)) * x.element_size(),
             N * nsv * ((5 if with_grad else 3) * F + 4), x.element_size())]


def kapply3d_work(Cp, u0, u1, u2, lx, ly, lz):
    """Kernel C, K u on an NX x NY x NZ hex8 grid, one launch a batch
    item: the 36 tangent volumes and three nodal volumes read, three
    written; 612 operations an element."""
    nel = Cp[0].numel()
    nn = math.prod(u0.shape[-3:])
    items = u0.numel() // nn
    one = ((36 * nel + 6 * nn) * Cp.element_size(), 612 * nel,
           Cp.element_size())
    return [one] * items


@dataclass
class KernelSpec:
    """A kernel of the program: the function that launches it
    (``module:function``), a part of its device name in the trace, and
    the work of one call."""
    target: str
    event: str
    work: object


def share(ctx, spec):
    """Percent of its roofline that ``spec``'s kernel reached in the
    profiled window, or None where the trace has none of its launches or
    their count differs from the calls recorded."""
    calls = ctx.work.get(spec.target, [])
    got = ctx.trace.kernel(spec.event) if ctx.trace else None
    if not calls or not got or got[1] != len(calls):
        return None
    secs, bound = 0., {'bytes': 0., 'operations': 0.}
    for nbytes, flops, isz in calls:
        t, which = least_seconds(nbytes, flops, isz)
        secs += t
        bound[which] += t
    ctx.notes.append(f'{spec.event}: {len(calls)} launches, least '
                     f'{secs:.6f} s (bound by {max(bound, key=bound.get)}) '
                     f'of {got[0]:.6f} s')
    return 100. * secs / got[0]
