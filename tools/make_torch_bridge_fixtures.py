"""Write the model records of the port's bridge fixtures, with the
reference's golden values and the host and JAX solvers' results, to
``pylabfea_tpu_torch/data/bridge_*.npz``.

    JAX_PLATFORMS=cpu python tools/make_torch_bridge_fixtures.py [name ...]
    JAX_PLATFORMS=cpu python tools/make_torch_bridge_fixtures.py props \
        chiprun_out/card_svc.npz   # after bridge_study on the card

The models are the ones that ``tools/gen_accuracy_ledger.py`` and
``tests/test_bridge.py`` build, taken as they stand: their functions run
with the JAX bridge's solvers wrapped so that each model is copied just
before it is solved (``_Capture``).  Each copy is read into a model
record by ``pylabfea_tpu_torch.bridge.read_model`` and saved by
``save_record`` with these extra arrays:

* ``gold.field``, ``gold.index``, ``gold.comp``, ``gold.ref``: where each
  golden value of ``ACCURACY.md`` lies in the results (``u`` by dof,
  ``sig``/``epl`` by element and component, ``glob_sig`` by component)
  and the reference's value; ``gold.jax`` the JAX device solver's;
* ``host.<field>`` the host (numpy) solver's results and ``jax.<field>``
  the JAX device solver's (u, f, sig, eps, epl, sgl and, for the resume
  case, ``bct_mem``);
* ``solver`` and its keyword arguments ``kw.<name>``.

Files: ``bridge_bcnode.npz`` (the 18 x 18 two-material inclusion with
force edges and a node pin, ``solve_on_device`` one step and one inner
iteration), ``bridge_ml_shear.npz`` (the ML-Hill-6D plane-stress shear
FEA, ``solve_on_device_adaptive(fast=False)``, with the trained SVC in the
material record, so that no test trains one), ``bridge_bar_sf1.npz`` /
``bridge_bar_sf2.npz`` (the 1-D composite bar with linear and quadratic
elements) and ``bridge_resume.npz`` (the continued-loading case: the
record before the first solve, ``bct2`` the raised top displacement of
the second).  ``bridge_props.npz`` is the witness of
``calc_properties_on_device`` on the SVC the port's trainer fitted on the
card (``props``): JAX's and the port's yield strengths at the default
protocol and at chip_smoke phase 15d's.  This script imports the JAX
package and scikit-learn; the port and the machine that runs it on the
card need neither.
"""
import copy
import os
import re
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'tools'))
sys.path.insert(0, os.path.join(ROOT, 'tests'))

import numpy as np  # noqa: E402

import gen_accuracy_ledger as gal  # noqa: E402  (sets JAX to the CPU)
import test_bridge  # noqa: E402
from pylabfea_tpu import bridge as jbridge  # noqa: E402
from pylabfea_tpu_torch import bridge as tbridge  # noqa: E402

DATA = os.path.join(ROOT, 'pylabfea_tpu_torch', 'data')


class _Capture:
    """Wraps the JAX bridge's solvers: each call appends (solver name, a
    deep copy of the model before the solve, the keyword arguments) to
    ``calls`` and then solves as the original does."""

    def __init__(self):
        self.calls = []
        self.orig = {}

    def __enter__(self):
        for name in ('solve_on_device', 'solve_on_device_adaptive'):
            fn = getattr(jbridge, name)
            self.orig[name] = fn

            def wrapped(model, *a, _fn=fn, _name=name, **kw):
                self.calls.append((_name, copy.deepcopy(model), kw))
                return _fn(model, *a, **kw)
            setattr(jbridge, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(jbridge, name, fn)


def _results(model):
    """The fields of a solved host model."""
    return dict(u=np.asarray(model.u, float), f=np.asarray(model.f, float),
                sig=np.array([e.sig for e in model.element], float),
                eps=np.array([e.eps for e in model.element], float),
                epl=np.array([e.epl for e in model.element], float),
                sgl=np.asarray(model.sgl, float),
                glob_sig=np.asarray(model.glob['sig'], float))


def _kw(kw):
    """Solver keyword arguments as npz values (dtypes by name)."""
    return {f'kw.{k}': (np.str_(np.dtype(v).name)
                        if k == 'dtype' else np.asarray(v))
            for k, v in kw.items()}


def _gold(rows):
    """(field, index, comp) of each ``gen_accuracy_ledger`` row label."""
    out = dict(field=[], index=[], comp=[], ref=[], jax=[])
    for label, ref, dev in rows:
        m = re.search(r'u\[(\d+)\]', label)
        if m:
            loc = ('u', int(m.group(1)), -1)
        elif 'glob sig_12' in label:
            loc = ('glob_sig', -1, 5)
        else:
            m = re.search(r'element\[(\d+)\]\.(\w+)\[(\d+)\]', label)
            loc = (m.group(2), int(m.group(1)), int(m.group(3)))
        for k, v in zip(('field', 'index', 'comp', 'ref', 'jax'),
                        loc + (ref, dev)):
            out[k].append(v)
    return {f'gold.{k}': np.asarray(v) for k, v in out.items()}


def _prefixed(prefix, res):
    return {f'{prefix}.{k}': v for k, v in res.items()}


def _save(name, model, solver, kw, **extra):
    path = os.path.join(DATA, f'bridge_{name}.npz')
    tbridge.save_record(path, tbridge.read_model(model, device='cpu'),
                        solver=np.str_(solver), **_kw(kw), **extra)
    print('wrote', path, os.path.getsize(path), 'bytes')


def bcnode():
    with _Capture() as cap:
        rows = gal.bcnode_rows()
    (solver, model, kw), = cap.calls
    jax_model = copy.deepcopy(model)
    getattr(jbridge, solver)(jax_model, **kw)
    _save('bcnode', model, solver, kw, **_gold(rows),
          **_prefixed('jax', _results(jax_model)))


def ml_shear():
    with _Capture() as cap:
        rows = gal.ml_shear_rows()
    (solver, model, kw), = cap.calls
    jax_model = copy.deepcopy(model)
    getattr(jbridge, solver)(jax_model, **kw)
    _save('ml_shear', model, solver, kw, **_gold(rows),
          **_prefixed('jax', _results(jax_model)))


def bars():
    with _Capture() as cap:
        test_bridge.test_1d_bar_device_vs_host()
    for sf, (solver, model, kw) in zip((1, 2), cap.calls[:2]):
        host = copy.deepcopy(model)
        host.solve()
        host.calc_global()
        jax_model = copy.deepcopy(model)
        getattr(jbridge, solver)(jax_model, **kw)
        _save(f'bar_sf{sf}', model, solver, kw,
              **_prefixed('host', _results(host)),
              **_prefixed('jax', _results(jax_model)))


def resume():
    with _Capture() as cap:
        test_bridge.test_adaptive_resume_matches_host()
    (solver, first, kw), (_, second, _) = cap.calls
    bct2 = np.asarray(second.bct, float)
    host = copy.deepcopy(first)
    host.solve()
    host.bctop(bct2[1], 'disp')
    host.solve()
    jax_model = copy.deepcopy(first)
    getattr(jbridge, solver)(jax_model, **kw)
    jax_model.bctop(bct2[1], 'disp')
    getattr(jbridge, solver)(jax_model, **kw)
    res_h, res_j = _results(host), _results(jax_model)
    res_h['bct_mem'] = np.asarray(host.bct_mem, float)
    res_j['bct_mem'] = np.asarray(jax_model.bct_mem, float)
    _save('resume', first, solver, kw, bct2=bct2,
          **_prefixed('host', res_h), **_prefixed('jax', res_j))


#: the protocols of the properties witness: (eps, nsteps) of
#: ``calc_properties_on_device``'s defaults and of chip_smoke phase 15d
PROPS_PROTOCOLS = {'default': (0.005, 20), 'smoke': (0.001, 10)}
#: the witness's runs: (protocol, Nel, load cases, whether the port runs
#: too); the port's runs at finer meshes are the card's
#: (``python -m pylabfea_tpu_torch.bridge_study``)
PROPS_RUNS = (('default', 8, ('stx', 'sty', 'et2', 'ect'), True),
              ('smoke', 8, ('stx', 'sty', 'et2', 'ect'), True),
              ('default', 32, ('sty',), True),
              ('default', 64, ('sty',), False),
              ('default', 128, ('sty',), False))


def _hill_j2(ref, d):
    """J2 stress at the analytic locus of ``ref`` along the direction d."""
    from pylabfea_tpu.core.tensors import sig_eq_j2
    d = np.asarray(d, float)[None]
    return float(ref.sy * sig_eq_j2(d)[0] / ref.calc_seq(d)[0])


def _host_ml(rec):
    """A host ML ``Material`` serving the SVC of a material record (no
    training: the SVC parameters are set on it)."""
    import pylabfea_tpu as FE
    from pylabfea_tpu.ops import svc as jsvc
    m = FE.Material(name='ML')
    m.elasticity(E=float(rec['E']), nu=float(rec['nu']))
    m.plasticity(sy=float(rec['sy']), sdim=6)
    m.ML_yf, m.Ndof, m.dev_only = True, 6, bool(rec['dev_only'])
    m.scale_seq = float(rec['scale_seq'])
    m._svc = jsvc.SVCParams(np.asarray(rec['sv'], float),
                            np.asarray(rec['dc'], float), float(rec['rho']),
                            float(rec['gamma']))
    return m


def props(svc):
    """The witness of ``calc_properties_on_device`` on the card-trained
    Hill SVC: ``svc`` is the ``card_svc.npz`` that ``python -m
    pylabfea_tpu_torch.bridge_study`` writes (chip_smoke phase 14a's SVC,
    4623 SVs, trained on the Hill reference of ``examples/train_hill.py``:
    rv [1.2, 1, 0.8, 1, 1, 1], sy 50).  The JAX version and the port's
    ``properties_record`` on the CPU, float32, raw SVC, at ``PROPS_RUNS``;
    saved to ``bridge_props.npz`` with the material record (``m.<name>``)
    and, for each run, ``<jax|port>.<protocol>.<Nel>.<case>.<what>``:
    the prop and propJ2 yield strengths and the analytic Hill values along
    the elastic direction of the load case (``onset``) and along the run's
    last stress (``last``); printed with the relative errors."""
    import jax.numpy as jnp
    import torch
    import pylabfea_tpu as FE
    from pylabfea_tpu_torch import convert
    ref = FE.Material(name='Hill-reference')
    ref.elasticity(E=200.e3, nu=0.3)
    ref.plasticity(sy=50., rv=[1.2, 1., 0.8, 1., 1., 1.], sdim=6)
    with np.load(svc) as z:
        ml = _host_ml({k[4:]: z[k] for k in z.files if k.startswith('raw.')})
    mrec = convert.material_record(ml)
    out = {f'm.{k}': np.asarray(v) for k, v in mrec.items()}
    hh = ml.E / (1. - ml.nu ** 2)
    CVps = np.zeros((6, 6))
    CVps[0, 0] = CVps[1, 1] = hh
    CVps[0, 1] = CVps[1, 0] = ml.nu * hh
    onset = dict(stx=np.eye(6)[0], sty=np.eye(6)[1],
                 et2=CVps @ [.4, .4, 0., 0., 0., 0.],
                 ect=CVps @ [-.8, .8, 0., 0., 0., 0.])
    for tag, nel, cases, port in PROPS_RUNS:
        eps, nsteps = PROPS_PROTOCOLS[tag]
        jm = copy.deepcopy(ml)
        jbridge.calc_properties_on_device(jm, Nel=nel, eps=eps,
                                          nsteps=nsteps, dtype=jnp.float32,
                                          load_cases=cases)
        res = dict(jax={c: dict(prop=jm.prop[c]['ys'],
                                propJ2=jm.propJ2[c]['ys'],
                                sig=jm.sigeps[c]['sig'][-1]) for c in cases})
        if port:
            tp = tbridge.properties_record(
                mrec, Nel=nel, eps=eps, nsteps=nsteps, dtype=torch.float32,
                load_cases=cases, device='cpu')
            res['port'] = {c: dict(prop=r['prop']['ys'],
                                   propJ2=r['propJ2']['ys'],
                                   sig=r['sigeps']['sig'][-1])
                           for c, r in tp.items()}
        for who, rows in res.items():
            for c, r in rows.items():
                on, last = _hill_j2(ref, onset[c]), _hill_j2(ref, r['sig'])
                vals = dict(prop=r['prop'], propJ2=r['propJ2'], onset=on,
                            last=last)
                for k, v in vals.items():
                    out[f'{who}.{tag}.{nel}.{c}.{k}'] = np.float64(v)
                print(f'{who} {tag} Nel {nel} {c}: propJ2 {r["propJ2"]:.4f} '
                      f'(Hill onset {on:.4f}, '
                      f'{abs(r["propJ2"] - on) / on:.2%}), prop '
                      f'{r["prop"]:.4f} (Hill at the last stress '
                      f'{last:.4f}, {abs(r["prop"] - last) / last:.2%})',
                      flush=True)
    path = os.path.join(DATA, 'bridge_props.npz')
    np.savez_compressed(path, **out)
    print('wrote', path, os.path.getsize(path), 'bytes')


MAKERS = dict(bcnode=bcnode, ml_shear=ml_shear, bars=bars, resume=resume)


if __name__ == '__main__':
    args = sys.argv[1:]
    if args[:1] == ['props']:
        props(args[1])
    else:
        for name in args or list(MAKERS):
            MAKERS[name]()
