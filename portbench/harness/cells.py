"""The two kinds of cells.  A cell builds the program's objects and the
requests of its traffic mix from the seed, serves one request at a time
through the program's public entry, keeps what the judge reads, and, for
the control, serves the same requests with the reference in the
program's place.

* ``SolveCell`` (``fe_solve``): one whole ``fe_kernels.solve_uniaxial``
  (2-D) or ``fe3d.solve_uniaxial3`` (3-D) a request, from a fresh state,
  its end strain set by scaling the mesh's prescribed values
  (``dataclasses.replace(md, fixed_val=...)``).  Every request of the
  window is judged.  Where the configuration names its ``last_round``
  function (called once a round with (md, state, mat, CV, du, ...):
  ``state.elstiff`` the tangent the round solved with, ``du`` the round's
  increment), the cell keeps the first round's tangent and the last
  round's tangent and increment of each request for the judge.
* ``ReturnMapCell`` (``return_map``): one ``constitutive.response_fast``
  on a batch of the pool a request.  A sample of the window's calls,
  drawn from the seed (reservoir sampling), is judged.
"""
import dataclasses
import math

import numpy as np
import torch

from harness import instrument, traffic
from reference import fe as rfe
from reference import judge
from reference import returnmap as rm

DTYPES = {'float32': torch.float32, 'float64': torch.float64}
#: the precision a step below each configured one (the control)
LOWER = {torch.float32: torch.bfloat16, torch.float64: torch.float32}


def elastic(cfg):
    e = cfg['elasticity']
    return rm.elastic_stiffness(float(e['E']), float(e['nu']))


def program_material(cfg, root, dtype, device):
    """The configuration's material as the program's DeviceMaterial."""
    from pylabfea_tpu_torch import convert
    m = cfg['material']
    if m['criterion'] == 'svc':
        return convert.material_from_npz(f'{root}/{m["svc_file"]}',
                                         dtype=dtype, device=device)[0]
    return convert.material_from_params(
        dict(hill=np.ones(6), sy=float(m['sy']), khard=float(m['khard']),
             drucker=0.), is_svc=False, dtype=dtype, device=device)


def synchronize(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


class Cell:
    def __init__(self, cfg, mix, root, device):
        self.cfg, self.mix, self.root = cfg, mix, str(root)
        self.device = torch.device(device)
        self.dtype = DTYPES[cfg['dtype']]
        self.CV = elastic(cfg)
        self.crit = rm.criterion_from(cfg, self.root)
        self.counters = {}
        self.sampling = False

    def sync(self):
        synchronize(self.device)

    def start_window(self):
        """Forget the warm-up: counters and samples start here."""
        self.counters = {k: 0 for k in self.counters}
        self.sampling = True


class SolveCell(Cell):
    def __init__(self, cfg, mix, root, device):
        super().__init__(cfg, mix, root, device)
        self.n = [int(k) for k in mix['mesh']]
        if len(self.n) != cfg['dim']:
            raise ValueError(f'mesh {self.n} is not {cfg["dim"]}-D')
        self.axis = 'xyz'.index(cfg['load_axis'])
        self.nsteps, self.n_inner = int(mix['nsteps']), int(mix['n_inner'])
        #: work of one request: elements times load steps
        self.work = math.prod(self.n) * self.nsteps

    def setup(self, seed):
        L = self.cfg['lengths']
        kw = dict(uniax=self.cfg['load_axis'], eps_tot=self.cfg['eps_tot'],
                  dtype=self.dtype, device=self.device)
        if self.cfg['dim'] == 2:
            from pylabfea_tpu_torch.ops import fe_kernels as fek
            self.md = fek.rect_mesh(*self.n, LX=L[0], LY=L[1], **kw)
            self._solve = fek.solve_uniaxial
        else:
            from pylabfea_tpu_torch.ops import fe3d
            self.md = fe3d.box_mesh(*self.n, LX=L[0], LY=L[1], LZ=L[2], **kw)
            self._solve = fe3d.solve_uniaxial3
        self.mat = program_material(self.cfg, self.root, self.dtype,
                                    self.device)
        self.patches = instrument.Patches()
        self._first = self._last = None
        if 'last_round' in self.cfg:
            self.patches.patch(self.cfg['last_round'], self._keep_round)
        self.reseed(seed)

    def _keep_round(self, orig):
        def wrapper(md, state, mat, CV, du, *args, **kwargs):
            if self.sampling:
                if self._first is None:
                    self._first = state.elstiff
                self._last = (state.elstiff, du)
            return orig(md, state, mat, CV, du, *args, **kwargs)
        return wrapper

    def reseed(self, seed):
        self.scales = traffic.strain_scales(self.mix, seed)

    def request(self):
        s = next(self.scales)
        md = dataclasses.replace(self.md, fixed_val=self.md.fixed_val * s)
        self._first = self._last = None
        state, hist = self._solve(md, self.mat, self.CV, nsteps=self.nsteps,
                                  n_inner=self.n_inner, dtype=self.dtype)
        self.sync()
        rec = dict(scale=s, u=state.u, sig=state.sig, epl=state.epl,
                   eps=state.eps, glob_sig=hist[-1][0])
        if self._last is not None:
            rec['last'] = dict(T_first=self._first, T_last=self._last[0],
                               du_last=self._last[1])
            self._first = self._last = None
        return rec

    def release(self):
        self.patches.restore()
        self.md = self.mat = None

    def grid(self):
        return rfe.Grid(self.n, self.cfg['lengths'], self.device)

    def judge(self, records):
        """The numbers of every record, each with the record's scale."""
        grid = self.grid()
        return [judge.judge_solve(grid, self.crit, self.CV, self.axis,
                                  self.cfg['eps_tot'] * r['scale'], r['u'],
                                  r['sig'], r['epl'], r['eps'],
                                  r['glob_sig'], r.get('last'))
                for r in records]

    def control(self, seed, count):
        """``count`` requests of the seed's traffic served by the reference
        a precision below the configuration's."""
        grid = self.grid()
        scales = traffic.strain_scales(self.mix, seed)
        out = []
        for _ in range(count):
            s = next(scales)
            (u, sig, epl, eps), hist, last = rfe.solve_uniaxial(
                grid, self.crit, self.CV, self.axis,
                self.cfg['eps_tot'] * s, self.nsteps, self.n_inner,
                dtype=LOWER[self.dtype])
            out.append(dict(scale=s, u=u, sig=sig, epl=epl, eps=eps,
                            glob_sig=hist[-1], last=last if 'last_round'
                            in self.cfg else None))
        return out


class ReturnMapCell(Cell):
    def __init__(self, cfg, mix, root, device):
        super().__init__(cfg, mix, root, device)
        self.states = int(mix['states'])
        self.maxiter = int(mix['maxiter'])
        self.work = self.states

    def setup(self, seed):
        from pylabfea_tpu_torch.ops import constitutive as con
        from pylabfea_tpu_torch.ops import svc_kernels as sk
        self._con, self._sk = con, sk
        self.mat = program_material(self.cfg, self.root, self.dtype,
                                    self.device)
        self.CVt = torch.as_tensor(self.CV, dtype=self.dtype,
                                   device=self.device)
        self.reseed(seed)

    def reseed(self, seed):
        self.pool = None
        self.pool = traffic.return_map_pool(self.mix, seed, self.crit.sy,
                                            self.dtype, self.device)
        self.rng = np.random.default_rng([int(seed), 1])
        self.counters = {'calls': 0, 'a_launches': 0}
        self.kept, self.calls, self.sampling = [], 0, False

    def request(self):
        k = self.calls % len(self.pool[0])
        a0 = self._sk.svc_f_grad.launches
        f, sig, depl, tan = self._con.response_fast(
            self.mat, (self.pool[0][k], self.pool[1][k]), self.pool[2][k],
            self.CVt, self.maxiter)
        self.sync()
        self.counters['a_launches'] += self._sk.svc_f_grad.launches - a0
        self.counters['calls'] += 1
        self.calls += 1
        if self.sampling:
            # reservoir sampling over the window's calls
            rec = dict(batch=k, f=f, sig=sig, depl=depl, tan=tan)
            n, size = self.counters['calls'], int(self.mix['sample'])
            if n <= size:
                self.kept.append(rec)
            else:
                j = int(self.rng.integers(0, n))
                if j < size:
                    self.kept[j] = rec
        return None

    def release(self):
        """Free the program's objects and every batch no sample needs."""
        self.mat = None
        self.pool = {r['batch']: self._inputs(r['batch']) for r in self.kept}

    def _inputs(self, k):
        if isinstance(self.pool, dict):
            return self.pool[k]
        return tuple(p[k] for p in self.pool)

    def judge(self, records):
        return [judge.judge_return_map(self.crit, self.CV,
                                       *self._inputs(r['batch']), r['f'],
                                       r['sig'], r['depl'], r['tan'],
                                       self.device, self.maxiter)
                for r in self.kept]

    def control(self, seed, count):
        """The reference a precision below the configuration's on the first
        ``count`` batches of the seed's pool."""
        self.reseed(seed)
        C = torch.as_tensor(self.CV, device=self.device)
        for k in range(count):
            low = [t.to(LOWER[self.dtype]) for t in self._inputs(k)]
            f, sig, depl, tan = rm.response(self.crit, *low, C,
                                            self.maxiter)
            self.kept.append(dict(batch=k, f=f, sig=sig, depl=depl, tan=tan))
        return self.kept


KINDS = {'fe_solve': SolveCell, 'return_map': ReturnMapCell}


def make(cfg, mix, root, device):
    return KINDS[mix['kind']](cfg, mix, root, device)
