"""Train the SVC yield functions of the port's feature-layout fixtures and
save them under ``pylabfea_tpu_torch/data/``.

    JAX_PLATFORMS=cpu python tools/make_torch_svc_fixtures.py

Each fixture is the JAX package's host ``Material`` trained as in its own
tests and examples, carried through ``constitutive.device_material_from``
in float64: every ``DeviceMaterial`` leaf under its own name, the static
flags, the elastic stiffness ``CV``, the raw texture descriptor (texture
layouts) and the total strain ``eps`` of the port's uniaxial workloads.
``pylabfea_tpu_torch.convert.material_from_npz`` reads them without JAX:

* ``svc_wh.npz``: stress + work hardening (15 features), the settings of
  ``examples/train_hardening.py`` (J2 reference, sy 100 MPa, khard 500
  MPa, 120 load cases at 6 plastic strains up to 0.02);
* ``svc_cyl.npz``: cylindrical sdim=3 features (seq/scale - 1, theta/pi;
  2 features), ``tests/test_device.py``'s sdim=3 Hill reference (sy 150
  MPa) with 150 load cases;
* ``svc_tex_gsh3.npz``: texture-conditioned, two GSH_3 texture sets (6 +
  3 = 9 features), ``tests/test_device.py``'s texture test, served at
  the first texture;
* ``svc_tex_adv.npz``: PCA-whitened ADV_12 descriptors of four texture
  sets (6 + the PCA's components), ``tests/test_device.py``'s ADV test.

Two training sets for the port's trainer (``pylabfea_tpu_torch.ml_train``)
carry the host ``Material.create_sig_data`` points, scaled as
``train_SVC`` scales them (stress / sy), with the settings that made them:

* ``train_hill.npz``: ``examples/train_hill.py``'s Hill reference (sy 50
  MPa, rv = [1.2, 1, 0.8, 1, 1, 1]; Nlc 300, Nseq 25, Fe 0.3, Ce 0.95,
  about 15,000 points), the JAX trainer's fit at the JAX backend's
  settings (C 4, gamma 1.5, 4000 iterations, float32), its training
  accuracy and its decision values on a seeded probe set;
* ``train_small.npz``: ``tests/test_jax_trainer.py``'s Hill reference (sy
  100 MPa, hill [1.2, 1, 0.8, 1, 1, 1]) at 40 load cases and Nseq 6 (480
  points), C 10 and gamma 2.5, for the CPU parity test.

This script imports the JAX package and scikit-learn; the port and the
machine that runs it on the card need neither.
"""
import os
import sys

import numpy as np
from scipy.optimize import fsolve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import pylabfea_tpu as FE  # noqa: E402
from pylabfea_tpu.ops import constitutive as con  # noqa: E402

OUT = os.path.join(ROOT, 'pylabfea_tpu_torch', 'data')
EPS = 0.002


def wh_material():
    sys.path.insert(0, os.path.join(ROOT, 'examples'))
    from train_hardening import create_data
    ref = FE.Material(name='J2-hardening-reference')
    ref.elasticity(E=200.e3, nu=0.3)
    ref.plasticity(sy=100., khard=500., sdim=6)
    sig, epl = create_data(ref)
    mat = FE.Material(name='ML-hardening')
    mat.from_data({
        'sdim': 6, 'Nlc': 120, 'Ncyl': 0, 'Ntext': 1, 'wh_data': True,
        'tx_data': False, 'epc': 0.0,
        'peeq_max': float(FE.eps_eq(epl).max()), 'sy_av': 100.,
        'elast_const': ref.CV, 'flow_stress': sig, 'plastic_strain': epl,
        'tx_descriptor': 'GSH_3', 'texture': np.zeros(1), 'tdim': 0})
    mat.train_SVC(C=10, gamma=2.5, Nseq=4, Fe=0.7, Ce=0.95)
    return mat, ref.CV, None


def cyl_material():
    ref = FE.Material()
    ref.elasticity(E=200.e3, nu=0.3)
    ref.plasticity(sy=150., hill=[1.2, 1., 0.8], sdim=3)
    mat = FE.Material('ml3')
    mat.train_SVC(C=10, gamma=4., mat_ref=ref, Nlc=150, Nseq=4)
    assert mat.Ndof == 2
    return mat, ref.CV, None


def _tex_set(tv, sy, hill, descriptor, tdim):
    ref = FE.Material()
    ref.elasticity(E=200.e3, nu=0.3)
    ref.plasticity(sy=sy, hill=hill, sdim=6)
    su = FE.load_cases(12, 24)
    x1 = fsolve(ref.find_yloc, np.ones(36) * sy, args=(su,), xtol=1e-5)
    return ref.CV, {
        'sdim': 6, 'Nlc': 36, 'Ncyl': 0, 'Ntext': 1, 'wh_data': False,
        'tx_data': True, 'epc': 0.002, 'peeq_max': 0.01, 'sy_av': float(sy),
        'elast_const': ref.CV, 'sig_ideal': su * x1[:, None],
        'tx_descriptor': descriptor, 'texture': np.asarray(tv),
        'tdim': tdim}


def gsh3_material():
    sets = [_tex_set([0.3, 0., 0.], 90., [1.2, 1., 0.8, 1., 1., 1.],
                     'GSH_3', 3),
            _tex_set([0., 0.3, 0.1], 120., [1., 1., 1., 1., 1., 1.],
                     'GSH_3', 3)]
    mat = FE.Material('ML-tex')
    mat.from_data([s for _, s in sets])
    mat.train_SVC(C=10, gamma=1., Fe=0.8, Ce=0.95, Nseq=2)
    return mat, sets[0][0], np.array([0.3, 0., 0.])


def adv_material():
    rng = np.random.default_rng(7)
    adv = rng.normal(0., 1., (4, 12))
    sets = [_tex_set(adv[0], 90., [1.2, 1., 0.8, 1., 1., 1.], 'ADV_12', 12),
            _tex_set(adv[1], 120., [1., 1., 1., 1., 1., 1.], 'ADV_12', 12),
            _tex_set(adv[2], 105., [0.9, 1.1, 1., 1., 1., 1.], 'ADV_12', 12),
            _tex_set(adv[3], 112., [1.1, 0.9, 1., 1., 1., 1.], 'ADV_12', 12)]
    mat = FE.Material('ML-adv')
    mat.from_data([s for _, s in sets])
    mat.train_SVC(C=10, gamma=1., Fe=0.8, Ce=0.95, Nseq=2)
    assert mat.pca is not None
    return mat, sets[0][0], adv[0]


FIXTURES = {'svc_wh': wh_material, 'svc_cyl': cyl_material,
            'svc_tex_gsh3': gsh3_material, 'svc_tex_adv': adv_material}


def _sig_data(ref, nlc, nseq, fe, ce):
    """Labelled training stresses of ``ref`` as ``train_SVC`` makes them,
    scaled by the yield strength as its ``create_scaled_input`` does."""
    gen = FE.Material('gen')
    gen.elasticity(CV=ref.CV)
    gen.plasticity(sy=ref.sy, sdim=6)
    x, y = gen.create_sig_data(N=nlc, mat_ref=ref, Nseq=nseq, Fe=fe, Ce=ce)
    return x / ref.sy, y


def train_hill_set():
    import jax.numpy as jnp
    from pylabfea_tpu import ml_train
    from pylabfea_tpu.ops import svc as svc_ops
    rv = [1.2, 1., 0.8, 1., 1., 1.]
    ref = FE.Material(name='Hill-reference')
    ref.elasticity(E=200.e3, nu=0.3)
    ref.plasticity(sy=50., rv=rv, sdim=6)
    cfg = dict(nlc=300, nseq=25, fe=0.3, ce=0.95)
    X, y = _sig_data(ref, **cfg)
    C, gamma, iters = 4., 1.5, 4000
    params, a = ml_train.fit_svc_jax(X, y, C=C, gamma=gamma, iters=iters,
                                     dtype=jnp.float32)
    rng = np.random.default_rng(21)
    u = rng.normal(size=(1024, 6))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    probe = u * rng.uniform(0.3, 1.6, (1024, 1))
    pred = np.where(svc_ops.decision_function(params, X) > 0., 1., -1.)
    return dict(X=X.astype(np.float32), y=y.astype(np.int8), probe=probe,
                f_probe_jax=svc_ops.decision_function(params, probe),
                acc_jax=100. * np.mean(pred == y),
                nsv_jax=params.support_vectors.shape[0], C=C, gamma=gamma,
                iters=iters, sy=ref.sy, hill=np.asarray(ref.hill, float),
                rv=np.asarray(rv), CV=ref.CV, dtype='float32', **cfg)


def train_small_set():
    ref = FE.Material()
    ref.elasticity(E=200.e3, nu=0.3)
    ref.plasticity(sy=100., hill=[1.2, 1., 0.8, 1., 1., 1.], sdim=6)
    cfg = dict(nlc=40, nseq=6, fe=0.5, ce=0.95)
    X, y = _sig_data(ref, **cfg)
    return dict(X=X, y=y.astype(np.int8), C=10., gamma=2.5, sy=ref.sy,
                hill=np.asarray(ref.hill, float), CV=ref.CV, **cfg)


TRAINING_SETS = {'train_hill': train_hill_set, 'train_small': train_small_set}


def save(name, mat, CV, tex):
    import jax.numpy as jnp
    dm = con.device_material_from(mat, dtype=jnp.float64, tex=tex)
    leaves = {k: np.asarray(v, dtype=np.float64)
              for k, v in dm._asdict().items()
              if k not in ('is_svc', 'dev_only', 'sdim3')}
    path = os.path.join(OUT, name + '.npz')
    np.savez_compressed(
        path, **leaves, is_svc=dm.is_svc, dev_only=dm.dev_only,
        sdim3=dm.sdim3, CV=np.asarray(CV, dtype=np.float64), eps=EPS,
        tex_raw=np.zeros(0) if tex is None else np.asarray(tex, float))
    print(f'{path}: {dm.sv.shape[0]} SVs x {dm.sv.shape[1]} features, '
          f'{os.path.getsize(path)} bytes')


def save_set(name, arrays):
    path = os.path.join(OUT, name + '.npz')
    np.savez_compressed(path, **arrays)
    extra = (f', JAX fit: {arrays["nsv_jax"]} SVs, training accuracy '
             f'{arrays["acc_jax"]:.2f} %' if 'acc_jax' in arrays else '')
    print(f'{path}: {len(arrays["y"])} points{extra}, '
          f'{os.path.getsize(path)} bytes')


def main(names):
    os.makedirs(OUT, exist_ok=True)
    for name in names or list(FIXTURES) + list(TRAINING_SETS):
        if name in TRAINING_SETS:
            save_set(name, TRAINING_SETS[name]())
        else:
            save(name, *FIXTURES[name]())


if __name__ == '__main__':
    main(sys.argv[1:])
