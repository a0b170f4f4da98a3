"""Batched Brent zeroin on tensors (the JAX ``rootfind.brent_jax``), and
its numpy copy ``brent_vec`` for the host profile (the JAX package's
``rootfind.brent_vec``: scipy's ``brentq`` update and stopping rules, so
given identical function values it reproduces scipy's iterates exactly).

The reference return map locates the ML yield surface with scipy's
``brentq`` at ``xtol=1e-5``; the JAX twin reproduces scipy's update and
stopping rules lane by lane, and so does ``brent``: the same safe
divisions, the same exact comparisons (``fcur == 0``, ``xpre == xblk``),
so in float64 the iterate sequence is JAX's.

One iteration's update of every lane is ``brent_step``, the wrapper of the
CUDA kernel ``csrc/brent_step.cu`` (XLA fuses the same loop body on the
TPU): a CUDA tensor launches the kernel, which updates the state in place,
or raises; a CPU tensor takes the plain PyTorch version
``brent_step_plain``.  The yield-locus distance of the faithful return map
does not come here on the card: kernel G (``svc_kernels.svc_yf_root``)
runs its marching and Brent per lane in one launch.
"""
import numpy as np
import torch

from pylabfea_tpu_torch.kernels import build

_RTOL = 4. * np.finfo(float).eps

#: iterations between two host reads of the all-lanes-done flag on the
#: card.  Finished lanes are frozen (every update is masked with the active
#: set), so the iterations run after the last lane converged change
#: nothing: reading the flag every ``CHECK_EVERY`` iterations gives JAX's
#: results with one device sync per ``CHECK_EVERY`` iterations instead of
#: one per iteration.  On the CPU a read syncs nothing and the flag is read
#: every iteration.
CHECK_EVERY = 8


def check_every(x):
    """Iterations between two reads of a done flag for tensors like
    ``x``."""
    return CHECK_EVERY if x.is_cuda else 1

#: the state of every lane, in the kernel's argument order
STATE = ('done', 'ok', 'root', 'xpre', 'fpre', 'xcur', 'fcur', 'xblk',
         'fblk', 'spre', 'scur')


def _safe(x):
    return torch.where(x == 0., 1., x)


def brent_vec(f, xa, xb, xtol=1.e-5, rtol=_RTOL, maxiter=100):
    """Batched Brent zeroin.  Each lane i solves f_i(x)=0 in [xa_i, xb_i].

    Returns (root, converged).  Lanes whose bracket does not straddle a sign
    change are returned unconverged with root = xb.
    """
    xa = np.array(xa, dtype=float)
    xb = np.array(xb, dtype=float)
    xpre, xcur = xa.copy(), xb.copy()
    fpre = np.asarray(f(xpre), dtype=float).copy()
    fcur = np.asarray(f(xcur), dtype=float).copy()

    root = xcur.copy()
    done = np.zeros(xa.shape, dtype=bool)
    ok = np.zeros(xa.shape, dtype=bool)
    # endpoint roots
    hit_pre = fpre == 0.
    root[hit_pre] = xpre[hit_pre]
    done |= hit_pre
    ok |= hit_pre
    hit_cur = (~done) & (fcur == 0.)
    root[hit_cur] = xcur[hit_cur]
    done |= hit_cur
    ok |= hit_cur
    bad = (~done) & (fpre * fcur > 0.)
    done |= bad  # no sign change: give up on these lanes

    xblk = np.zeros_like(xpre)
    fblk = np.zeros_like(fpre)
    spre = np.zeros_like(xpre)
    scur = np.zeros_like(xpre)

    for _ in range(maxiter):
        act = ~done
        if not act.any():
            break
        bracket = act & (fpre * fcur < 0.)
        xblk[bracket] = xpre[bracket]
        fblk[bracket] = fpre[bracket]
        spre[bracket] = xcur[bracket] - xpre[bracket]
        scur[bracket] = spre[bracket]

        swap = act & (np.abs(fblk) < np.abs(fcur))
        # rotate (pre <- cur, cur <- blk, blk <- pre) as in zeroin
        xpre_s, fpre_s = xcur[swap], fcur[swap]
        xpre[swap], fpre[swap] = xcur[swap], fcur[swap]
        xcur[swap], fcur[swap] = xblk[swap], fblk[swap]
        xblk[swap], fblk[swap] = xpre_s, fpre_s

        delta = (xtol + rtol * np.abs(xcur)) / 2.
        sbis = (xblk - xcur) / 2.
        conv = act & ((fcur == 0.) | (np.abs(sbis) < delta))
        root[conv] = xcur[conv]
        ok |= conv
        done |= conv
        act = ~done
        if not act.any():
            break

        interp = act & (np.abs(spre) > delta) & (np.abs(fcur) < np.abs(fpre))
        with np.errstate(divide='ignore', invalid='ignore'):
            # secant where only two points, inverse quadratic otherwise
            sec = -fcur * (xcur - xpre) / (fcur - fpre)
            dpre = (fpre - fcur) / (xpre - xcur)
            dblk = (fblk - fcur) / (xblk - xcur)
            iq = -fcur * (fblk * dblk - fpre * dpre) / (dblk * dpre * (fblk - fpre))
        stry = np.where(xpre == xblk, sec, iq)
        accept = interp & (2. * np.abs(stry) <
                           np.minimum(np.abs(spre), 3. * np.abs(sbis) - delta))
        spre_new = np.where(accept, scur, sbis)
        scur_new = np.where(accept, stry, sbis)
        spre[act] = spre_new[act]
        scur[act] = scur_new[act]

        xpre[act] = xcur[act]
        fpre[act] = fcur[act]
        step = np.where(np.abs(scur) > delta, scur,
                        np.where(sbis > 0, delta, -delta))
        xcur[act] = xcur[act] + step[act]
        # evaluate f on all lanes (inactive lanes ignored) — f must be total
        fnew = np.asarray(f(xcur), dtype=float)
        fcur[act] = fnew[act]

    root[~ok & ~done] = xcur[~ok & ~done]
    return root, ok


def brent_step_plain(state, xtol, rtol):
    """One Brent iteration on the active (not done) lanes of ``state``
    (a dict of the ``STATE`` tensors), up to the new abscissa ``xcur``;
    the caller evaluates f there.  Returns the new state dict."""
    done, ok, root = state['done'], state['ok'], state['root']
    xpre, fpre, xcur, fcur = (state[k] for k in ('xpre', 'fpre', 'xcur',
                                                 'fcur'))
    xblk, fblk, spre, scur = (state[k] for k in ('xblk', 'fblk', 'spre',
                                                 'scur'))
    act = ~done
    bracket = act & (fpre * fcur < 0.)
    xblk = torch.where(bracket, xpre, xblk)
    fblk = torch.where(bracket, fpre, fblk)
    spre = torch.where(bracket, xcur - xpre, spre)
    scur = torch.where(bracket, xcur - xpre, scur)

    swap = act & (torch.abs(fblk) < torch.abs(fcur))
    xpre2 = torch.where(swap, xcur, xpre)
    fpre2 = torch.where(swap, fcur, fpre)
    xcur = torch.where(swap, xblk, xcur)
    fcur = torch.where(swap, fblk, fcur)
    xblk = torch.where(swap, xpre2, xblk)
    fblk = torch.where(swap, fpre2, fblk)
    xpre, fpre = xpre2, fpre2

    delta = (xtol + rtol * torch.abs(xcur)) / 2.
    sbis = (xblk - xcur) / 2.
    conv = act & ((fcur == 0.) | (torch.abs(sbis) < delta))
    root = torch.where(conv, xcur, root)
    ok = ok | conv
    done = done | conv
    act = ~done

    interp = act & (torch.abs(spre) > delta) \
        & (torch.abs(fcur) < torch.abs(fpre))
    sec = -fcur * (xcur - xpre) / _safe(fcur - fpre)
    dpre = (fpre - fcur) / _safe(xpre - xcur)
    dblk = (fblk - fcur) / _safe(xblk - xcur)
    iq = -fcur * (fblk * dblk - fpre * dpre) \
        / _safe(dblk * dpre * (fblk - fpre))
    stry = torch.where(xpre == xblk, sec, iq)
    accept = interp & (2. * torch.abs(stry) < torch.minimum(
        torch.abs(spre), 3. * torch.abs(sbis) - delta))
    spre = torch.where(act, torch.where(accept, scur, sbis), spre)
    scur = torch.where(act, torch.where(accept, stry, sbis), scur)

    xpre = torch.where(act, xcur, xpre)
    fpre = torch.where(act, fcur, fpre)
    step = torch.where(torch.abs(scur) > delta, scur,
                       torch.where(sbis > 0, delta, -delta))
    xcur = torch.where(act, xcur + step, xcur)
    return dict(done=done, ok=ok, root=root, xpre=xpre, fpre=fpre,
                xcur=xcur, fcur=fcur, xblk=xblk, fblk=fblk, spre=spre,
                scur=scur)


def _check(state):
    x = state['xcur']
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'brent_step: dtype {x.dtype} not supported')
    for k in STATE:
        t = state[k]
        want = torch.bool if k in ('done', 'ok') else x.dtype
        if t.dtype != want or t.device != x.device:
            raise TypeError(f'brent_step: {k} is {t.dtype} on {t.device}, '
                            f'want {want} on {x.device}')
        if t.shape != x.shape or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f'brent_step: {k} must be a contiguous '
                             f'{tuple(x.shape)} vector, got '
                             f'{tuple(t.shape)}')


def brent_step(state, xtol, rtol):
    """One Brent iteration (see ``brent_step_plain``).  On the card the
    kernel updates the state tensors in place and returns the same dict;
    the caller owns them."""
    x = state['xcur']
    if x.device.type == 'cpu':
        return brent_step_plain(state, xtol, rtol)
    if x.device.type != 'cuda':
        raise TypeError(f'brent_step: device {x.device} not supported')
    _check(state)
    if x.numel() == 0:
        return state
    lib = build.load().lib
    fn = lib.pylabfea_brent_step_f32 if x.dtype == torch.float32 \
        else lib.pylabfea_brent_step_f64
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.numel(), *(state[k].data_ptr() for k in STATE),
                 float(xtol), float(rtol), stream)
    build.check(err, 'brent_step')
    brent_step.launches += 1
    return state


#: kernel launches since the last reset (a plain integer; set it to 0)
brent_step.launches = 0


def brent(f, xa, xb, xtol=1.e-5, rtol=_RTOL, maxiter=100, step=brent_step):
    """Brent zeroin on every lane: ``f`` maps (N,) abscissae to (N,)
    residuals, lane i solves f_i(x) = 0 in [xa_i, xb_i].  Finished lanes
    freeze while the others iterate, at most ``maxiter`` iterations, each
    one ``step`` (kernel F on the card; ``brent_step_plain`` keeps it plain
    PyTorch on any device).  Returns (root, converged); a lane without a
    sign change across its bracket is unconverged with root xb."""
    fpre = f(xa)
    fcur = f(xb)
    bad = fpre * fcur > 0.
    hit_pre = fpre == 0.
    hit_cur = (~hit_pre) & (fcur == 0.)
    zero = torch.zeros_like(xa)
    state = dict(done=bad | hit_pre | hit_cur, ok=hit_pre | hit_cur,
                 root=torch.where(hit_pre, xa, xb), xpre=xa.clone(),
                 fpre=fpre.clone(), xcur=xb.clone(), fcur=fcur.clone(),
                 xblk=zero, fblk=zero.clone(), spre=zero.clone(),
                 scur=zero.clone())
    it, every = 0, check_every(xa)
    while it < maxiter:
        if it % every == 0 and bool(state['done'].all()):
            break
        state = step(state, xtol, rtol)
        state['fcur'] = torch.where(state['done'], state['fcur'],
                                    f(state['xcur']))
        it += 1
    return torch.where(state['ok'], state['root'], state['xcur']), \
        state['ok']
