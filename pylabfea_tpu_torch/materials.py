"""Material / constitutive layer.

``Material`` carries elastic and plastic parameter definitions, analytic
equivalent stresses (J2, Hill 3p/6p, Tresca, Barlat Yld2004-18p, Drucker and
LHS tension/compression asymmetry), machine-learned (SVC) yield functions
with analytic gradients and Hessians, the incremental return-mapping update
(``response``), consistent tangent stiffness, SVC training, data-driven
material definition, texture mixing, UMAT parameter export and property
characterization via the FE solver.

The port's copy of ``pylabfea_tpu.materials`` (host profile): numpy float64
with the same arithmetic in the same order, so it meets the reference's
golden values and the JAX package's host results.  Behavioral contract
follows the reference ``pylabfea.material``; the implementation is fully
batched: every constitutive function has a *rows* variant operating on
``(N, ...)`` element batches — the FE solver evaluates the return map for
all elements of one material in a single call instead of a Python loop, and
the bridge (``pylabfea_tpu_torch.bridge``) replays the same methods on the
card (``HostLaw``).

Where the JAX host profile calls JAX, this one calls the port's torch code:
the ``backend='jax'`` SVC fit and grid search are the card's dual trainer
(``ml_train``), ``compress_svc`` is ``ops.svc.reduce_svc``; each of these
methods takes ``device`` (``None`` is the card, ``'cpu'`` the CPU).
scikit-learn (``backend='sklearn'``, the default, and texture training)
and matplotlib are imported only where they are used.
"""
import pickle
import warnings

import numpy as np
from scipy.optimize import fsolve, root_scalar

from pylabfea_tpu_torch.core.tensors import (
    a_vec, b_vec, yf_tolerance, eps_eq, sig_polar_ang, sig_eq_j2,
    sig_cyl2princ, sig_princ, sig_dev,
)
from pylabfea_tpu_torch.ops import svc as svc_ops
from pylabfea_tpu_torch.ops.rootfind import brent_vec

_FLOATS = (float, np.float64, np.float32)


class Material(object):
    """Material definition: elastic/plastic parameters, constitutive update,
    ML yield functions, and property calculation via FEA.

    Parameters
    ----------
    name : str
        Material name (optional, default: 'Material')
    num : int
        Material number (optional, default: 1)
    """

    def __init__(self, name='Material', num=1):
        self.name = name
        self.num = num
        # elastic constants
        self.E = None
        self.nu = None
        self.CV = None
        self.C11 = None
        self.C12 = None
        self.C44 = None
        # plastic parameters
        self.sy = None          # current yield strength; None => elastic only
        self.sy0 = None         # initial yield strength
        self.khard = None       # linear hardening slope
        self.voce_r = 0.        # Voce saturation stress rise (0 = linear)
        self.voce_b = 1.        # Voce saturation rate
        self.drucker = None
        self.lhs = None
        self.tresca = False
        self.barlat = False
        self.hill_6p = False
        self.sdim = None
        self.tdim = None
        # ML flow rule
        self.ML_yf = False
        self.ML_grad = False
        self.dev_only = False
        self.svm_yf = None
        self.C_yf = None
        self.gam_yf = None
        self.scale_seq = None
        self.scale_wh = None
        self.scale_text = None
        self.std_scaler = None
        self.pca = None
        self._svc = None        # SVCParams for fast inference
        # microstructure / data
        self.msparam = None
        self.whdat = False
        self.txdat = False
        self.Ndof = 2
        self.Nset = None
        self.epc = None
        self.ind_wh = None
        self.ind_tx = None
        self.grid = None
        self.root_method = 'brentq'
        self.msg = {'yield_fct': None, 'gradient': None, 'nsteps': 0,
                    'equiv': None}
        empty = lambda keys: {k: dict.fromkeys(keys) for k in
                              ('stx', 'sty', 'et2', 'ect')}
        self.prop = empty(('ys', 'seq', 'eeq', 'peeq', 'style', 'name'))
        self.propJ2 = empty(('ys', 'seq', 'eeq', 'peeq'))
        self.sigeps = empty(('sig', 'eps', 'epl'))

    def GridSearchCVTexture(self, x, param_grid, n_splits, verbose=True,
                            Nseq=25, Fe=0.1, Ce=0.99, metric='acc',
                            pca_dim=10):
        """Texture-stratified grid-search CV (the reference declares this
        API but leaves the body incomplete, material.py:2370): K-fold the
        dataset ACROSS TEXTURES — if texture A is in a training fold, none
        of its stress data may appear in the validation fold — so the score
        measures generalization to unseen textures.

        Implemented on the working K-fold texture recursion
        (``_train_svc_texture_gridsearch``): for every (C, gamma) in
        ``param_grid``, ``n_splits``-fold over the microstructures in
        ``self.msparam``, retrain on the training textures, score on the
        held-out ones, then fit the final SVC with the best pair.  ``x`` is
        accepted for reference-API compatibility but ignored: the training
        set is regenerated per fold from ``msparam`` (required — a
        pre-assembled feature array cannot be re-split by texture once the
        per-texture scaling has been folded in).  Returns
        (train_score, test_score) of the final fit."""
        if x is not None:
            import warnings
            warnings.warn(
                'GridSearchCVTexture: regenerating training data per '
                'fold from msparam (the pre-assembled x is ignored — a '
                'pre-assembled feature array cannot be re-split by '
                'texture once the per-texture scaling has been folded '
                'in)', stacklevel=2)
        cvals = list(param_grid.get('C', [10]))
        gvals = list(param_grid.get('gamma', [1]))
        return self._train_svc_texture_gridsearch(
            C=cvals[0], gamma=gvals[0],
            Nlc=36, Nseq=Nseq, extend=False, mat_ref=None, sdata=None,
            plot=False, fontsize=16, Fe=Fe, Ce=Ce, scaler=None, pca=None,
            verbose=verbose, metric=metric, pca_dim=pca_dim,
            cvals=cvals, gvals=gvals, n_splits=n_splits)

    # =================================================================
    # elastic and plastic material definitions
    # =================================================================
    def elasticity(self, C11=None, C12=None, C44=None, CV=None,
                   E=None, nu=None):
        """Define elastic constants from (E, nu), (C11, C12, C44), or a full
        Voigt matrix CV."""
        if E is not None:
            if nu is None:
                raise ValueError('Inconsistent elastic definition: only E provided')
            if (C11 is not None) or (C12 is not None) or (C44 is not None):
                raise ValueError('Inconsistent elastic definition: E together with C_ij')
            hh = E / ((1. + nu) * (1. - 2. * nu))
            self.C11 = (1. - nu) * hh
            self.C12 = nu * hh
            self.C44 = (0.5 - nu) * hh
            self.E = E
            self.nu = nu
        elif C11 is not None:
            if nu is not None:
                raise ValueError('Inconsistent elastic definition: nu together with C_ij')
            if (C12 is None) or (C44 is None):
                raise ValueError('Inconsistent elastic definition: C12 or C44 missing')
            self.C11 = C11
            self.C12 = C12
            self.C44 = C44
            self.nu = C12 / (C11 + C12)
            self.E = 2 * C44 * (1 + self.nu)  # isotropic estimate
        elif CV is not None:
            self.CV = np.array(CV)
            self.C11 = self.CV[0, 0]
            self.C12 = self.CV[0, 1]
            self.C44 = self.CV[3, 3]
            self.nu = self.C12 / (self.C11 + self.C12)
            self.E = 2 * self.C44 * (1 + self.nu)  # isotropic estimate
        else:
            raise ValueError('elasticity: no parameters provided')
        if CV is None:
            CV = np.zeros((6, 6))
            CV[:3, :3] = self.C12
            np.fill_diagonal(CV[:3, :3], self.C11)
            CV[3, 3] = CV[4, 4] = CV[5, 5] = self.C44
            self.CV = CV

    def plasticity(self, sy=None, sdim=6, drucker=0., khard=0., tresca=False,
                   barlat=None, barlat_exp=None, hill=None, hill_3p=None,
                   hill_6p=None, rv=None, lhs=None, voce_r=0., voce_b=1.):
        """Define plastic parameters: yield strength, Hill anisotropy (directly
        or via rv flow ratios), Drucker/LHS asymmetry, Tresca or Barlat
        Yld2004-18p equivalent stress, and linear hardening slope.  Beyond
        the reference contract, ``voce_r``/``voce_b`` add a Voce saturation
        term to the flow stress (sy + khard*peeq + voce_r*(1-exp(-voce_b*
        peeq))) — micromechanical hardening saturates, and a purely linear
        law overshoots beyond ~1% plastic strain."""
        if sy < 0.:
            raise ValueError('Initial yield strength cannot be negative.')
        if khard < 0.:
            warnings.warn('Strain softening not supported. khard is set to 0.')
            khard = 0.
        if voce_r < 0. or voce_b <= 0.:
            raise ValueError('Voce parameters require voce_r >= 0 and '
                             'voce_b > 0.')
        self.sy0 = sy
        self.sy = sy
        self.khard = khard
        self.voce_r = voce_r
        self.voce_b = voce_b
        self.drucker = drucker
        self.lhs = None if lhs is None else np.array(lhs)
        if lhs is not None and not np.isclose(drucker, 0.0):
            raise ValueError('Drucker-Prager and LHS parameters cannot be '
                             'given at the same time.')
        if sdim != 3 and sdim != 6:
            raise ValueError(f'{self.name} in plasticity: sdim must be 3 or 6')
        if self.sdim is not None and self.sdim != sdim:
            print('plasticity: Parameter sdim is changed. New value:', sdim)
        self.sdim = sdim
        if hill is None and rv is None:
            hill = list(np.ones(self.sdim))
            if lhs is not None:
                raise ValueError('LHS asymmetry parameters provided without '
                                 'anisotropy parameters for plastic yielding.')
        elif hill is None:
            if len(rv) != self.sdim:
                raise ValueError(f'plasticity: wrong dimension of yield stress '
                                 f'ratios, must be {sdim}')
            rinv = 1. / np.array(rv)
            hill = list(np.ones(self.sdim))
            hill[0] = rinv[0] ** 2 + rinv[1] ** 2 - rinv[2] ** 2
            hill[1] = rinv[1] ** 2 + rinv[2] ** 2 - rinv[0] ** 2
            hill[2] = rinv[2] ** 2 + rinv[0] ** 2 - rinv[1] ** 2
            if self.sdim == 6:
                hill[3] = rinv[3] ** 2
                hill[4] = rinv[4] ** 2
                hill[5] = rinv[5] ** 2
        elif rv is not None:
            warnings.warn('plasticity: Both hill and rv provided. Using Hill '
                          'parameters.')
        hill = list(hill)
        lh = len(hill)
        if hill_6p is None and hill_3p is None:
            hill_6p = (lh == 6)
            hill_3p = not hill_6p
            if hill_3p and hill[0] == 1. and hill[1] == 1. and hill[2] == 1.:
                hill_3p = False
        if hill_6p and lh != 6:
            raise ValueError('plasticity: hill_6p=True requires 6 Hill parameters')
        if hill_3p and lh != 3:
            raise ValueError('plasticity: hill_3p=True allows only 3 Hill parameters')
        if hill_6p and sdim == 3:
            warnings.warn('plasticity: 6 Hill parameters with sdim=3; ignoring '
                          'shear parameters')
            hill_6p = False
            hill_3p = True
            hill = hill[0:3]
        if hill_3p and sdim == 6:
            warnings.warn('plasticity: 3 Hill parameters with sdim=6; shear '
                          'parameters set to 1')
            hill_3p = False
            hill_6p = True
            hill.extend([1., 1., 1.])
        if sdim == 6 and len(hill) == 3:
            hill.extend([1., 1., 1.])
        self.hill_6p = hill_6p
        self.hill_3p = hill_3p
        self.hill = np.array(hill)
        self.tresca = bool(tresca) if tresca is not None else False
        if barlat is not None:
            self.barlat = True
            b = np.asarray(barlat, dtype=float)
            self.Bar_m1 = np.array([[0., -b[0], -b[1], 0., 0., 0.],
                                    [-b[2], 0., -b[3], 0., 0., 0.],
                                    [-b[4], -b[5], 0., 0., 0., 0.],
                                    [0., 0., 0., b[6], 0., 0.],
                                    [0., 0., 0., 0., b[7], 0.],
                                    [0., 0., 0., 0., 0., b[8]]])
            self.Bar_m2 = np.array([[0., -b[9], -b[10], 0., 0., 0.],
                                    [-b[11], 0., -b[12], 0., 0., 0.],
                                    [-b[13], -b[14], 0., 0., 0., 0.],
                                    [0., 0., 0., b[15], 0., 0.],
                                    [0., 0., 0., 0., b[16], 0.],
                                    [0., 0., 0., 0., 0., b[17]]])
            self.barlat_exp = barlat_exp
        else:
            self.barlat = False

    # =================================================================
    # equivalent stress and yield function
    # =================================================================
    def calc_seq(self, sig):
        """Generalized equivalent stress: Tresca, Barlat, Hill 3p/6p or J2,
        with optional Drucker/LHS hydrostatic term.  Accepts (3,), (6,),
        (N,3), (N,6)."""
        sig = np.asarray(sig, dtype=float)
        sh = sig.shape
        if sh == (3,):
            sp = sig[None, :]
            sv = np.concatenate([sig, np.zeros(3)])[None, :]
            single = True
        elif sh == (6,):
            sp = sig_princ(sig)[0][None, :]
            sv = sig[None, :]
            single = True
        elif sig.ndim == 2 and sh[1] == 3:
            sp = sig
            sv = np.concatenate([sig, np.zeros_like(sig)], axis=1)
            single = False
        elif sig.ndim == 2 and sh[1] == 6:
            sp = sig_princ(sig)[0]
            sv = sig
            single = False
        else:
            raise TypeError(f'Unknown format of stress in calc_seq: sh={sh}')

        if self.tresca:
            seq = np.amax(sp, axis=1) - np.amin(sp, axis=1)
        elif self.barlat:
            seq = self.calc_seqB(sv)
            seq = np.atleast_1d(seq)
        else:
            if self.sy is None:
                hp = np.ones(3)
                d0 = np.zeros(3)
            else:
                hp = self.hill
                if self.lhs is not None:
                    d0 = self.lhs
                else:
                    d0 = np.ones(3) * self.drucker
            I1 = (sv[:, 0] * d0[0] + sv[:, 1] * d0[1] + sv[:, 2] * d0[2]) / 3.
            if self.hill_6p:
                I2 = 0.5 * (hp[0] * (sv[:, 0] - sv[:, 1]) ** 2 +
                            hp[1] * (sv[:, 1] - sv[:, 2]) ** 2 +
                            hp[2] * (sv[:, 2] - sv[:, 0]) ** 2 +
                            6. * hp[3] * sv[:, 3] ** 2 +
                            6. * hp[4] * sv[:, 4] ** 2 +
                            6. * hp[5] * sv[:, 5] ** 2)
                self.msg['equiv'] = '6-parameter Hill, full Voigt stress'
            else:
                d12 = sp[:, 0] - sp[:, 1]
                d23 = sp[:, 1] - sp[:, 2]
                d31 = sp[:, 2] - sp[:, 0]
                I2 = 0.5 * (hp[0] * d12 ** 2 + hp[1] * d23 ** 2 + hp[2] * d31 ** 2)
                self.msg['equiv'] = '3-parameter Hill'
            seq = np.sqrt(I2) + I1
        return seq[0] if single else seq

    def calc_seqB(self, sv):
        """Barlat Yld2004-18p equivalent stress (Barlat et al., IJP 21, 2005).

        Accepts a single Voigt stress (6,) or a batch (N,6)."""
        sv = np.asarray(sv, dtype=float)
        single = sv.ndim == 1
        svb = sv[None, :] if single else sv
        sd = sig_dev(svb)
        st1 = sd @ self.Bar_m1.T
        st2 = sd @ self.Bar_m2.T
        sp1 = sig_princ(st1)[0]
        sp2 = sig_princ(st2)[0]
        a = self.barlat_exp
        diff = np.abs(sp1[:, :, None] - sp2[:, None, :]) ** a
        seq = (0.25 * np.sum(diff, axis=(1, 2))) ** (1. / a)
        return seq[0] if single else seq

    def get_sflow(self, epl):
        """Scalar flow stress (linear isotropic + optional Voce saturation
        hardening) at plastic strain ``epl`` (scalar PEEQ or tensor)."""
        peeq = epl if type(epl) in _FLOATS else eps_eq(epl)
        return self._sflow_of(peeq)

    def _sflow_of(self, peeq):
        sf = self.sy + peeq * self.khard
        if getattr(self, 'voce_r', 0.):
            sf = sf - self.voce_r * np.expm1(-self.voce_b * peeq)
        return sf

    def get_khard(self, peeq=0.):
        """Hardening modulus d sflow / d peeq at the given plastic strain."""
        kh = self.khard
        if getattr(self, 'voce_r', 0.):
            kh = kh + self.voce_r * self.voce_b * np.exp(-self.voce_b * peeq)
        return kh

    def _sflow_rows(self, epl_rows):
        """Flow stress per row for (N, sdim) plastic strain tensors."""
        return self._sflow_of(eps_eq(epl_rows))

    def calc_yf(self, sig, epl=None, accumulated_strain=0.0, max_stress=0.0,
                flag=0.0, tex=None, ana=False, pred=False):
        """Yield function at stress(es) ``sig``: SVC decision function for ML
        materials (unless ``ana``), otherwise seq - sflow."""
        sh = np.shape(sig)
        if epl is None:
            epl = np.zeros(self.sdim if self.sdim is not None else 6)
        elif type(epl) in _FLOATS:
            epl = epl * np.array([1., -0.5, -0.5, 0., 0., 0.])
        if self.ML_yf and not ana:
            sig = np.asarray(sig, dtype=float)
            single = sh == (3,) or sh == (6,)
            sigb = sig[None, :] if single else sig
            if tex is not None and len(np.shape(tex)) == 1:
                tex = np.array([tex])
            elif tex is None and self.txdat:
                raise ValueError("SVM is trained on texture data but no "
                                 "texture data is given to evaluate yf!")
            x = self.create_scaled_input(sigb, epl, accumulated_strain,
                                         max_stress, flag, tex)
            if pred:
                f = self.svm_yf.predict(x) if self.svm_yf is not None \
                    else np.where(svc_ops.decision_function_np(self._svc, x) > 0, 1., -1.)
                self.msg['yield_fct'] = 'ML_yf-predict'
            else:
                f = svc_ops.decision_function_np(self._svc, x)
                self.msg['yield_fct'] = 'ML_yf-decision-fct'
            return f[0] if single else f
        f = self.calc_seq(sig) - self.get_sflow(epl)
        self.msg['yield_fct'] = 'analytical'
        return f

    def _yf_rows(self, sig_rows, epl_rows, acc=None, mxs=None, flg=None,
                 tex=None):
        """Yield function for row batches with per-row plastic strain."""
        if self.ML_yf:
            x = self.create_scaled_input(
                sig_rows, epl_rows,
                0.0 if acc is None else acc,
                0.0 if mxs is None else mxs,
                0.0 if flg is None else flg, tex)
            return svc_ops.decision_function_np(self._svc, x)
        return self.calc_seq(sig_rows) - self._sflow_rows(epl_rows)

    def find_yloc(self, x, su, epl=None, accumulated_strain=0.0,
                  max_stress=0.0, flag=0.0, tex=None):
        """Scale unit stresses ``su`` by ``x`` and evaluate the yield function
        (used by root searches for the yield locus)."""
        if self.txdat and tex is None:
            raise ValueError("SVM is trained on texture data but no texture "
                             "data was provided to this function.")
        return self.calc_yf(x[:, None] * su, epl=epl,
                            accumulated_strain=accumulated_strain,
                            max_stress=max_stress, flag=flag, tex=tex)

    def find_yloc_scalar(self, x, su, epl=None, accumulated_strain=0.0,
                         max_stress=0.0, flag=0.0, tex=None):
        """Scalar version of ``find_yloc``."""
        if self.txdat and tex is None:
            raise ValueError("SVM is trained on texture data but no texture "
                             "data was provided to this function.")
        return self.calc_yf(x * su, epl=epl,
                            accumulated_strain=accumulated_strain,
                            max_stress=max_stress, flag=flag, tex=tex)

    def ML_full_yf(self, sig, epl=None, ld=None, accumulated_strain=0.0,
                   max_stress=0.0, flag=0.0, tex=None, verb=True):
        """Distance of a single stress to the ML yield locus along the loading
        direction (bracket search + Brent root find, xtol=1e-5)."""
        sig = np.asarray(sig, dtype=float)
        sh = sig.shape
        if sh != (3,) and sh != (6,):
            raise ValueError('Only individual stress tensors supported in '
                             f'Material.ML_full_yf. Shape is {sh}')
        if epl is None:
            epl = np.zeros(self.sdim)
        res = self._ml_full_yf_rows(sig[None, :], np.asarray(epl)[None, :],
                                    ld=ld, acc=accumulated_strain,
                                    mxs=max_stress, flg=flag, tex=tex,
                                    verb=verb)
        return res[0]

    def _ml_full_yf_rows(self, sig_rows, epl_rows, ld=None, acc=0.0, mxs=0.0,
                         flg=0.0, tex=None, verb=False):
        """Batched ML yield distance; each row follows the identical marching
        + Brent sequence the scalar reference uses."""
        N = len(sig_rows)
        seq = np.atleast_1d(self.calc_seq(sig_rows))
        sflow = self._sflow_rows(epl_rows)
        yf = seq - 0.85 * sflow  # conservative estimate (fallback)

        if ld is None:
            solve = seq >= 0.01
            with np.errstate(divide='ignore', invalid='ignore'):
                su = np.where(solve[:, None], sig_rows / np.where(
                    seq[:, None] == 0., 1., seq[:, None]), 0.)
        else:
            solve = np.ones(N, dtype=bool)
            hh = np.linalg.norm(ld[0:self.sdim])
            if hh < 1.e-3:
                warnings.warn(f'ML_full_yf called with inconsistent ld={ld}')
                hh = 1.
                ld = np.zeros(self.sdim)
                ld[0] = 1.
            su = np.broadcast_to(ld[0:self.sdim] * np.sqrt(1.5) / hh,
                                 (N, self.sdim)).copy()
        if not solve.any():
            return yf
        idx = np.where(solve)[0]
        su_s = su[idx][:, 0:sig_rows.shape[1]] if ld is None else su[idx]
        epl_s = epl_rows[idx]
        sfl_s = sflow[idx]
        x0 = sfl_s.copy()
        shear = su_s[:, 0] * su_s[:, 1] < -1.e-5
        x0[shear] *= 0.4 if self.tresca else 0.5
        x1 = x0.copy()

        def yf_at(xv):
            return self._yf_rows(xv[:, None] * su_s, epl_s, acc, mxs, flg, tex)

        # march x0 down until yf < 0 (or x0 <= 0.01), exactly as the scalar loop
        for _ in range(2000):
            cond = (yf_at(x0) >= 0.) & (x0 > 0.01)
            if not cond.any():
                break
            x0[cond] *= 0.98
        # march x1 up until yf >= 0 (or x1 >= 5 sflow)
        for _ in range(2000):
            cond = (yf_at(x1) < 0.) & (x1 < 5. * sfl_s)
            if not cond.any():
                break
            x1[cond] *= 1.02
        f0 = yf_at(x0)
        f1 = yf_at(x1)
        bracketed = f0 * f1 <= 0.
        if not bracketed.all() and verb:
            warnings.warn('ML_full_yf: Could not bracket yield function for '
                          f'{np.sum(~bracketed)} of {len(x0)} stresses')
        if self.root_method == 'brentq':
            xs, ok = brent_vec(yf_at, x0, x1, xtol=1.e-5)
        else:  # pragma: no cover - non-default root method
            xs = np.empty(len(x0))
            ok = np.zeros(len(x0), dtype=bool)
            for i in range(len(x0)):
                r = root_scalar(lambda x: float(yf_at(np.full(len(x0), x))[i]),
                                method=self.root_method,
                                bracket=[x0[i], x1[i]], xtol=1.e-5)
                xs[i] = r.root
                ok[i] = r.converged
        good = bracketed & ok & (xs < 4. * sfl_s)
        seq_su = np.atleast_1d(self.calc_seq(su_s))
        yf_solved = np.where(good, seq[idx] - xs * seq_su, yf[idx])
        yf[idx] = yf_solved
        return yf

    # =================================================================
    # gradients, flow rule, tangent stiffness
    # =================================================================
    def calc_fgrad(self, sig, epl=None, seq=None, accumulated_strain=0.0,
                   max_stress=0.0, flag=0.0, tex=None, ana=False):
        """Gradient of the yield surface at ``sig``: analytic (Hill/J2/
        Drucker/LHS), SVC kernel gradient for ML materials, or separately
        fitted SVR gradient (ML_grad)."""
        sig = np.asarray(sig, dtype=float)
        sh = sig.shape
        if epl is None:
            epl = np.zeros_like(sig)
        elif np.shape(epl) != sh:
            raise ValueError('Parameters sig and epl must have the same shape.')
        single = sh == (3,) or sh == (6,)
        sigb = sig[None, :] if single else sig
        eplb = np.asarray(epl, dtype=float)
        eplb = eplb[None, :] if single else eplb
        if tex is not None and len(np.shape(tex)) == 1:
            tex = np.array([tex])
        elif tex is None and self.txdat:
            raise ValueError("SVM is trained on texture data but no texture "
                             "data is given to evaluate yf!")
        fgrad = self._fgrad_rows(sigb, eplb, seq=seq,
                                 acc=accumulated_strain, mxs=max_stress,
                                 flg=flag, tex=tex, ana=ana)
        return fgrad[0] if single else fgrad

    def _fgrad_rows(self, sig, epl, seq=None, acc=0.0, mxs=0.0, flg=0.0,
                    tex=None, ana=False):
        N = len(sig)
        fgrad = np.zeros_like(sig)
        if self.ML_grad and not ana:
            # SVR-regressed gradient (fitted in setup_fgrad_SVM)
            xf = np.concatenate((sig, epl), axis=1)
            xsc = self.sc_feat.transform(xf)
            dp = np.column_stack([g.predict(xsc) for g in self._svm_grads])
            fgrad[:, :] = self.sc_grad.inverse_transform(dp)
            self.khard = float(self.sc_khard.inverse_transform(
                self.svm_khard.predict(xsc).reshape(-1, 1))[-1, 0])
            self.msg['gradient'] = 'SVR gradient'
        elif self.ML_yf and not ana:
            x = self.create_scaled_input(sig, epl, acc, mxs, flg, tex)
            grads = svc_ops.decision_gradient_np(self._svc, x)  # (N, Ndof)
            if self.sdim == 3:
                jac = self._jac_cyl(sig)
                vec = np.zeros((N, 3))
                vec[:, 0] = 1.
                vec[:, 1] = grads[:, 1]
                fgrad = np.einsum('nij,nj->ni', jac, vec)
            else:
                if self.std_scaler is not None:
                    # chain rule through the standard scaler (stress features)
                    fgrad[:, 0:6] = grads[:, 0:6] / self.std_scaler.scale_[0:6]
                else:
                    fgrad[:, 0:6] = grads[:, 0:6] / self.scale_seq
            if self.whdat:
                hk = -np.sum(grads[:, self.ind_wh:self.ind_wh + self.sdim],
                             axis=0) * self.scale_seq / self.scale_wh
                self.khard = max(0., np.sum(hk) / N)
            else:
                self.khard = 0.
            self.msg['gradient'] = 'gradient to ML_yf'
        else:
            if self.barlat:
                raise ValueError('calc_fgrad: analytical gradient for Barlat '
                                 'not implemented')
            if self.tresca:
                raise ValueError('calc_fgrad: analytical gradient for Tresca '
                                 'not implemented')
            h0, h1, h2 = self.hill[0], self.hill[1], self.hill[2]
            if self.lhs is not None:
                d3 = self.lhs
            else:
                d3 = np.ones(3) * self.drucker / 3.
            if seq is None:
                seq = self.calc_seq(sig)
            seq = np.atleast_1d(seq)
            sdev = sig_dev(sig)
            fgrad[:, 0] = ((h0 + h2) * sdev[:, 0] - h0 * sdev[:, 1]
                           - h2 * sdev[:, 2]) / (2. * seq) + d3[0]
            fgrad[:, 1] = ((h1 + h0) * sdev[:, 1] - h0 * sdev[:, 0]
                           - h1 * sdev[:, 2]) / (2. * seq) + d3[1]
            fgrad[:, 2] = ((h2 + h1) * sdev[:, 2] - h2 * sdev[:, 0]
                           - h1 * sdev[:, 1]) / (2. * seq) + d3[2]
            if self.sdim == 6 and sig.shape[1] == 6:
                h3, h4, h5 = self.hill[3], self.hill[4], self.hill[5]
                fgrad[:, 3] = 3. * h3 * sdev[:, 3] / seq
                fgrad[:, 4] = 3. * h4 * sdev[:, 4] / seq
                fgrad[:, 5] = 3. * h5 * sdev[:, 5] / seq
                label = ('analytical, J2 isotropic, full stress'
                         if np.all(self.hill == 1.)
                         else 'analytical, 6-parameter Hill, full stress')
            else:
                label = ('analytical, J2 isotropic, princ. stress'
                         if h0 == h1 == h2 == 1.
                         else 'analytical, 3-parameter Hill, princ. stress')
            self.msg['gradient'] = label
        return fgrad

    @staticmethod
    def _jac_cyl(sig):
        """Jacobian of the (seq, theta, p) coordinate transform for a batch of
        principal stresses — maps cylindrical SVC gradients back to principal
        stress space (reference material.py:780-795)."""
        N = len(sig)
        J = np.ones((N, 3, 3))
        dev = sig_dev(sig)
        vn = np.linalg.norm(dev, axis=1) * np.sqrt(1.5)
        big = vn > 0.1
        vs = np.where(big, vn, 1.)
        dseqds = 3. * dev / vs[:, None]
        dsa = sig @ a_vec
        dsb = sig @ b_vec
        sc = dsa + 1j * dsb
        sc = np.where(sc == 0., 1., sc)
        z = -1j * ((a_vec[None, :] + 1j * b_vec[None, :]) / sc[:, None]
                   - dseqds / vs[:, None])
        J[big, :, 2] = 1. / 3.
        J[big, :, 0] = dseqds[big]
        J[big, :, 1] = np.real(z)[big]
        return J

    def calc_hessian(self, sig, epl=None, seq=None, accumulated_strain=0.0,
                     max_stress=0.0, flag=0.0, tex=None, ana=False):
        """Hessian of the ML yield surface (RBF kernel Hessian of the SVC)."""
        sig = np.asarray(sig, dtype=float)
        sh = sig.shape
        if epl is None:
            epl = np.zeros(self.sdim)
        if type(epl) in _FLOATS:
            epl = epl * sig / np.atleast_1d(sig_eq_j2(sig))[:, None]
        single = sh == (3,) or sh == (6,)
        sigb = sig[None, :] if single else sig
        if tex is not None and len(np.shape(tex)) == 1:
            tex = np.array([tex])
        elif tex is None and self.txdat:
            raise ValueError("SVM is trained on texture data but no texture "
                             "data is given to evaluate yf!")
        if self.ML_grad and not ana:
            raise NotImplementedError('calc_hessian: not implemented for SVR '
                                      'gradients')
        if not (self.ML_yf and not ana):
            raise ValueError('calc_hessian: analytical Hessians not implemented')
        if self.sdim == 3:
            raise NotImplementedError('calc_hessian: not implemented for 3D '
                                      'stress')
        x = self.create_scaled_input(sigb, np.asarray(epl), accumulated_strain,
                                     max_stress, flag, tex)
        h_full = svc_ops.decision_hessian_np(self._svc, x)
        hessian = h_full[:, 0:self.sdim, 0:self.sdim]
        if self.std_scaler is not None:
            sf = 1. / (np.ones(self.sdim) * self.scale_seq)
            hessian = hessian * np.outer(sf, sf)[None, :, :]
        else:
            hessian = hessian / self.scale_seq
        return hessian

    def epl_dot(self, sig, epl, Cel, deps, accumulated_strain=0.0,
                max_stress=0.0, flag=0.0, tex=None):
        """Plastic strain increment from associated flow
        (Crisfield ch. 6: lambda_dot = a^T C deps / (a^T C a + khard))."""
        return self._epl_dot_rows(np.asarray(sig, float)[None, :],
                                  np.asarray(epl, float)[None, :],
                                  Cel, np.asarray(deps, float)[None, :],
                                  accumulated_strain, max_stress, flag, tex)[0]

    def _epl_dot_rows(self, sig, epl, Cel, deps, acc=0.0, mxs=0.0, flg=0.0,
                      tex=None):
        N = len(sig)
        yfun = self._yf_rows(sig + deps @ Cel.T, epl, acc, mxs, flg, tex)
        pdot = np.zeros((N, 6))
        yld = np.atleast_1d(yfun) > yf_tolerance
        if yld.any():
            k = np.where(yld)[0]
            a = np.zeros((len(k), 6))
            if self.sdim == 3:
                a[:, 0:3] = self._fgrad_rows(sig_princ(sig[k])[0],
                                             epl[k][:, 0:3], acc=acc,
                                             mxs=mxs, tex=tex)
            else:
                a[:, :] = self._fgrad_rows(sig[k], epl[k], acc=acc, mxs=mxs,
                                           flg=flg, tex=tex)
            ca = a @ Cel.T
            hh = np.einsum('ni,ni->n', ca, a) + self.get_khard(eps_eq(epl[k]))
            lam = np.einsum('ni,ni->n', ca, deps[k]) / hh
            pdot[k] = lam[:, None] * a
        return pdot

    def C_tan(self, sig, Cel, epl=None):
        """Consistent tangent stiffness Ct = C - (Ca (x) Ca)/(a^T C a + khard)."""
        if epl is None:
            epl = np.zeros(self.sdim)
        return self._c_tan_rows(np.asarray(sig, float)[None, :], Cel,
                                np.asarray(epl, float)[None, :])[0]

    def _c_tan_rows(self, sig, Cel, epl):
        N = len(sig)
        a = np.zeros((N, 6))
        if self.sdim == 3:
            a[:, 0:3] = self._fgrad_rows(sig_princ(sig)[0], epl[:, 0:3])
        else:
            a[:, :] = self._fgrad_rows(sig, epl)
        ca = a @ Cel.T
        hh = np.einsum('ni,ni->n', ca, a) + self.get_khard(eps_eq(epl))
        return Cel[None, :, :] - np.einsum('ni,nj->nij', ca, ca) / hh[:, None, None]

    # =================================================================
    # incremental return mapping (the user-material function)
    # =================================================================
    def response(self, sig, epl, deps, CV, maxit=50):
        """Nonlinear material response over one strain increment (elastic
        predictor, step split at yield onset, substepping with excess-stress
        correction).  Returns (yield fct at end, stress, plastic strain
        increment, averaged tangent stiffness)."""
        sig = np.asarray(sig, dtype=float)
        sh = sig.shape
        if sh != (6,) and sh != (3,):
            raise ValueError('Only individual stress tensors supported in '
                             f'Material.response. Shape is {sh}')
        fy1, s, dp, gs, nst = self.response_batch(
            sig[None, :], np.asarray(epl, float)[None, :],
            np.asarray(deps, float)[None, :], CV, maxit=maxit)
        self.msg['nsteps'] = int(nst[0])
        return fy1[0], s[0], dp[0], gs[0]

    def response_batch(self, sig0, epl0, deps, CV, maxit=50):
        """Batched return mapping over N element states (the hot path of the
        FE solver).  Per-lane arithmetic is identical to the scalar update;
        lanes are compressed so divergent control flow stays exact.

        Returns (fy1, sig, depl, grad_stiff, nsteps) with leading dim N.
        """
        CV = np.asarray(CV, dtype=float)
        N = len(sig0)
        sig = np.array(sig0, dtype=float)
        epl0 = np.asarray(epl0, dtype=float)
        deps = np.asarray(deps, dtype=float)
        depl = np.zeros((N, 6))
        grad = np.zeros((N, 6, 6))
        nst = np.zeros(N, dtype=int)
        toler = yf_tolerance * self._sflow_rows(epl0)
        dsig = deps @ CV.T

        if self.ML_yf:
            fy1 = self._ml_full_yf_rows(sig + dsig, epl0)
        else:
            fy1 = np.atleast_1d(self._yf_rows(sig + dsig, epl0))
        elastic = fy1 < toler
        sig[elastic] += dsig[elastic]
        grad[elastic] = CV

        p = np.where(~elastic)[0]
        if len(p) == 0:
            return fy1, sig, depl, grad, nst

        sigp = sig[p].copy()
        eplp = epl0[p]
        depsp = deps[p]
        tolp = toler[p]
        fy1p = fy1[p].copy()
        deplp = np.zeros((len(p), 6))
        gradp = np.zeros((len(p), 6, 6))

        # split the step at the yield locus for lanes starting elastic
        fy0 = np.atleast_1d(self._yf_rows(sigp, eplp))
        split = fy0 < -0.15
        st_scal = np.ones(len(p))
        if split.any():
            if self.ML_yf:
                zl = np.zeros_like(eplp[split])
                fy0_d = self._ml_full_yf_rows(sigp[split], zl)
                fy0[split] = fy0_d
            st_scal[split] += fy0[split] / np.atleast_1d(
                self.calc_seq(dsig[p]))[split]
        deps_el = depsp * (1. - st_scal)[:, None]
        sigp += deps_el @ CV.T
        gradp[split] = CV[None] * (1. - st_scal[split])[:, None, None]
        deps_r = depsp - deps_el

        # trial with the full remaining step to decide on subdivision
        ddepl = self._epl_dot_rows(sigp, eplp, CV, deps_r)
        t_stiff = self._c_tan_rows(sigp, CV, eplp)
        eplt = eplp + deplp + ddepl
        dsig2 = np.einsum('nij,nj->ni', t_stiff, deps_r)
        if self.ML_yf:
            fy1p = self._ml_full_yf_rows(sigp + dsig2, eplt)
        else:
            fy1p = np.atleast_1d(self._yf_rows(sigp + dsig2, eplt))
        sub = fy1p > tolp
        deps_r[sub] /= maxit
        nsteps = np.where(sub, maxit, 1)

        # compliance for the excess-stress correction (shared by all lanes)
        SV = np.zeros((6, 6))
        i = 3 if CV[2, 2] > 1. else 2
        SV[0:i, 0:i] = np.linalg.inv(CV[0:i, 0:i])
        for k in range(3, 6):
            if CV[k, k] > 1.:
                SV[k, k] = 1. / CV[k, k]

        for it in range(int(np.max(nsteps))):
            act = np.where(it < nsteps)[0]
            if len(act) == 0:
                break
            nst[p[act]] = it
            sa = sigp[act]
            ea = eplp[act]
            dra = deps_r[act]
            ddepl = self._epl_dot_rows(sa, ea, CV, dra)
            t_st = self._c_tan_rows(sa, CV, ea)
            eplt = ea + deplp[act] + ddepl
            sa = sa + np.einsum('nij,nj->ni', t_st, dra)
            if self.ML_yf:
                fya = self._ml_full_yf_rows(sa, eplt)
            else:
                fya = np.atleast_1d(self._yf_rows(sa, eplt))
            over = fya > tolp[act]
            if over.any():
                o = np.where(over)[0]
                seq_o = np.atleast_1d(self.calc_seq(sa[o]))
                dsig_x = sa[o] * (fya[o] / seq_o)[:, None]
                sa[o] -= dsig_x
                ddepl[o] += dsig_x @ SV.T
                eplt[o] = ea[o] + deplp[act][o] + ddepl[o]
                # least-squares correction of the tangent from the removed
                # excess stress (min-norm solution == lstsq)
                dro = dra[o]
                amat = np.zeros((len(o), 3, 6))
                amat[:, 0, 0] = dro[:, 0]
                amat[:, 0, 4] = dro[:, 2]
                amat[:, 0, 5] = dro[:, 1]
                amat[:, 1, 1] = dro[:, 1]
                amat[:, 1, 3] = dro[:, 2]
                amat[:, 1, 5] = dro[:, 0]
                amat[:, 2, 2] = dro[:, 2]
                amat[:, 2, 3] = dro[:, 1]
                amat[:, 2, 4] = dro[:, 0]
                x = np.einsum('nij,nj->ni', np.linalg.pinv(amat), dsig_x[:, 0:3])
                Ct = np.zeros((len(o), 6, 6))
                Ct[:, 0, 0] = x[:, 0]
                Ct[:, 1, 1] = x[:, 1]
                Ct[:, 2, 2] = x[:, 2]
                Ct[:, 0, 1] = Ct[:, 1, 0] = x[:, 5]
                Ct[:, 0, 2] = Ct[:, 2, 0] = x[:, 4]
                Ct[:, 1, 2] = Ct[:, 2, 1] = x[:, 3]
                t_st[o] -= Ct
                if self.ML_yf:
                    fya[o] = self._ml_full_yf_rows(sa[o], eplt[o])
                else:
                    fya[o] = np.atleast_1d(self._yf_rows(sa[o], eplt[o]))
            sigp[act] = sa
            gradp[act] += t_st * (st_scal[act] / nsteps[act])[:, None, None]
            deplp[act] += ddepl
            fy1p[act] = fya

        fy1[p] = fy1p
        sig[p] = sigp
        depl[p] = deplp
        grad[p] = gradp
        return fy1, sig, depl, grad, nst

    # =================================================================
    # ML flow rule: feature construction and SVC training
    # =================================================================
    def create_scaled_input(self, sig, epl=None, acc_strain=None,
                            max_stress=None, flag=None, tex=None):
        """Build the scaled SVC feature vector from stress (and optional work
        hardening / texture features)."""
        sig = np.asarray(sig, dtype=float)
        sh = sig.shape
        sigb = sig[None, :] if sh == (3,) or sh == (6,) else sig
        N = len(sigb)
        if not self.txdat:
            x = np.zeros((N, self.Ndof))
            if self.sdim == 3:
                x[:, 0] = sig_eq_j2(sigb) / self.scale_seq - 1.
                x[:, 1] = sig_polar_ang(sigb) / np.pi
            else:
                if self.dev_only:
                    sigb = sig_dev(sigb)
                ncol = min(6, sigb.shape[1])
                x[:, 0:ncol] = sigb[:, 0:ncol] / self.scale_seq
            if self.whdat:
                x[:, self.ind_wh:self.ind_wh + self.sdim] = \
                    np.asarray(epl) / self.scale_wh
                x[:, self.ind_wh + self.sdim] = acc_strain
                x[:, self.ind_wh + self.sdim + 1] = \
                    np.asarray(max_stress) / self.scale_seq
                x[:, self.ind_wh + self.sdim + 2] = flag
        else:
            assert self.sdim == 6
            x_raw = np.zeros((N, self.Ndof))
            x_raw[:, 0:6] = sig_dev(sigb)[:, 0:6] if self.dev_only \
                else sigb[:, 0:6]
            if self.whdat:
                x_raw[:, self.ind_wh:self.ind_wh + self.sdim] = epl
                x_raw[:, self.ind_wh + self.sdim] = acc_strain
                x_raw[:, self.ind_wh + self.sdim + 1] = max_stress
                x_raw[:, self.ind_wh + self.sdim + 2] = flag
            x_raw[:, self.ind_tx:] = tex
            x = self.std_scaler.transform(x_raw)
            if self.pca and 'ADV' in self.msparam[0]['tx_descriptor']:
                x_tex = self.pca.transform(x_raw[:, self.ind_tx:])
                x = np.hstack((x[:, :self.ind_tx], x_tex))
            elif not self.pca and 'ADV' in self.msparam[0]['tx_descriptor']:
                raise Warning("No PCA object in material but address vector "
                              "texture descriptor used!")
        return x

    def _set_svc(self, clf):
        """Store a trained sklearn SVC and extract its parameters for the
        fast inference kernels."""
        self.svm_yf = clf
        self._svc = svc_ops.SVCParams.from_sklearn(clf)
        self.ML_yf = True

    def _fit_svc_backend(self, X_train, y_train, backend, iters=4000,
                         device=None):
        """Fit the RBF SVC with the selected backend and install the trained
        parameters: 'sklearn' (libsvm SMO, host) or 'jax' (the name the JAX
        API gives its on-device trainer; here the card's projected-gradient
        dual solver ``ml_train.train_svc_jax`` on ``device``, the card when
        None — no sklearn needed at fit time).  Both populate ``self._svc``
        (SVCParams), the store every consumer reads (device kernels, UMAT
        export, FE solvers)."""
        if backend == 'sklearn':
            from sklearn import svm
            clf = svm.SVC(kernel='rbf', C=self.C_yf, gamma=self.gam_yf)
            clf.fit(X_train, y_train)
            self._set_svc(clf)
            return
        if backend != 'jax':
            raise ValueError(f"backend must be 'sklearn' or 'jax', "
                             f"got {backend!r}")
        from pylabfea_tpu_torch.ml_train import train_svc_jax
        # the callers score the fit themselves
        train_svc_jax(self, X_train, y_train, C=self.C_yf,
                      gamma=self.gam_yf, iters=iters, device=device,
                      score=False)

    def compress_svc(self, nsv=None, tol=1e-3, seed=0, device=None):
        """Reduced-set compression of the trained ML yield function for
        serving: re-expresses the SVC decision function over fewer RBF
        centers (``ops.svc.reduce_svc`` — weighted k-means seeding +
        RKHS-objective center refinement + exact kernel-ridge
        coefficients).  Every inference pass (yf/grad/Hessian, host and
        device, UMAT export) costs linearly in the SV count, so the
        compression ratio is the constitutive-kernel speedup.

        ``nsv`` fixes the center count; ``tol`` (used when ``nsv`` is
        None) bounds the RELATIVE RKHS approximation error, which for the
        RBF kernel bounds the decision-function deviation at EVERY stress
        state.  Returns the achieved relative RKHS error.  The sklearn
        classifier object (if any) is dropped — ``_svc`` is the store all
        consumers read.  The compression runs in float64 on ``device`` (the
        card when None)."""
        if self._svc is None:
            raise RuntimeError('compress_svc requires a trained ML yield '
                               'function (train_SVC / setup_yf_SVM_6D)')
        red, rel = svc_ops.reduce_svc(self._svc, n_out=nsv, tol=tol,
                                      seed=seed, device=device)
        self._svc = red
        self.svm_yf = None
        return rel

    def _svc_predict(self, X):
        """Class predictions from the trained SVC (backend-agnostic: the
        sklearn object if present, the SVCParams decision function else)."""
        if self.svm_yf is not None:
            return self.svm_yf.predict(X)
        return np.where(svc_ops.decision_function_np(self._svc, X) > 0.,
                        1., -1.)

    def _svc_score(self, X, y):
        """Mean classification accuracy of the trained SVC on (X, y)."""
        return float(np.mean(self._svc_predict(X) == np.asarray(y)))

    def setup_yf_SVM(self, x, y_train, x_test=None, y_test=None, C=15.,
                     gamma=2.5, fs=0.1, plot=False, cyl=False,
                     gridsearch=False, cvals=None, gvals=None, verbose=3,
                     backend='sklearn', device=None):
        """Train the SVC yield function (dispatch on stress dimensionality)."""
        if self.sdim == 3:
            return self.setup_yf_SVM_3D(x, y_train, x_test=x_test,
                                        y_test=y_test, C=C, gamma=gamma,
                                        fs=fs, plot=plot, cyl=cyl,
                                        gridsearch=gridsearch, cvals=cvals,
                                        gvals=gvals, backend=backend,
                                        device=device)
        return self.setup_yf_SVM_6D(x, y_train, x_test=x_test, y_test=y_test,
                                    C=C, gamma=gamma, plot=plot,
                                    verbose=verbose, gridsearch=gridsearch,
                                    cvals=cvals, gvals=gvals, pca_dim=10,
                                    metric='acc', backend=backend,
                                    device=device)

    def setup_yf_SVM_6D(self, x, y_train, x_test=None, y_test=None, C=10.,
                        gamma=1., plot=False, gridsearch=False, cvals=None,
                        gvals=None, verbose=3, pca_dim=10, metric='acc',
                        backend='sklearn', device=None):
        """Train an RBF SVC on 6-D Voigt stress features (plus optional work
        hardening and texture dofs).  Returns (train_score, test_score).
        ``backend='jax'`` fits (and grid-searches) with the card's dual
        solver on ``device`` instead of sklearn."""
        assert self.sdim == 6
        if backend == 'sklearn' or self.txdat:
            from sklearn.preprocessing import StandardScaler
            from sklearn.decomposition import PCA
        if metric == 'mcc':
            from sklearn.metrics import matthews_corrcoef
        self.gam_yf = gamma
        self.C_yf = C
        if self.msparam is None:
            self.scale_seq = self.sy
        else:
            self.scale_seq = 0.
            self.scale_wh = 0.
            for i in range(self.Nset):
                self.scale_seq += self.msparam[i]['sy_av'] / self.Nset
                self.scale_wh += self.msparam[i]['peeq_max'] / self.Nset
            if not self.whdat:
                self.scale_wh = 1.
        sig = x[:, 0:6]
        if self.whdat:
            epl = x[:, self.ind_wh:self.ind_wh + self.sdim]
            acc_strain = x[:, self.ind_wh + self.sdim]
            max_stress = x[:, self.ind_wh + self.sdim + 1]
            flag = x[:, self.ind_wh + self.sdim + 2]
        else:
            epl = acc_strain = max_stress = flag = None
        if self.txdat:
            tex = x[:, self.ind_tx:]
            if 'ADV' in self.msparam[0]['tx_descriptor']:
                pca = PCA(n_components=pca_dim, whiten=True)
                pca.fit(tex)
                self.pca = pca
            self.std_scaler = StandardScaler().fit(x)
        else:
            tex = None
        X_train = self.create_scaled_input(sig, epl, acc_strain, max_stress,
                                           flag, tex)
        X_test = None
        if x_test is not None:
            sig = x_test[:, 0:6]
            if self.whdat:
                epl = x_test[:, self.ind_wh:self.ind_wh + self.sdim]
                acc_strain = x_test[:, self.ind_wh + self.sdim]
                max_stress = x_test[:, self.ind_wh + self.sdim + 1]
                flag = x_test[:, self.ind_wh + self.sdim + 2]
            if self.txdat:
                tex = x_test[:, self.ind_tx:]
            X_test = self.create_scaled_input(sig, epl, acc_strain,
                                              max_stress, flag, tex)

        if gridsearch:
            if cvals is None:
                cvals = [1, 2, 4, 10]
                if C not in cvals:
                    cvals.append(C)
            if gvals is None:
                gvals = [0.5, 1, 1.5, 2, 2.5, 3]
                if gamma not in gvals:
                    gvals.append(gamma)
            if backend == 'jax':
                from pylabfea_tpu_torch.ml_train import gridsearch_svc
                self.C_yf, self.gam_yf, sc = gridsearch_svc(
                    X_train, y_train, cvals, gvals, device=device)
                self.grid = {'cvals': cvals, 'gvals': gvals, 'scores': sc,
                             'best': {'C': self.C_yf, 'gamma': self.gam_yf}}
            else:
                from sklearn import svm
                from sklearn.model_selection import GridSearchCV
                self.grid = GridSearchCV(svm.SVC(),
                                         {'C': cvals, 'gamma': gvals},
                                         refit=True, verbose=verbose,
                                         n_jobs=-1)
                self.grid.fit(X_train, y_train)
                self.gam_yf = self.grid.best_params_["gamma"]
                self.C_yf = self.grid.best_params_["C"]
        self._fit_svc_backend(X_train, y_train, backend, device=device)

        if metric == 'acc':
            train_sc = 100 * self._svc_score(X_train, y_train)
        elif metric == 'mcc':
            train_sc = matthews_corrcoef(y_train, self._svc_predict(X_train))
        else:
            raise ValueError(f"{metric} must be acc or mcc")
        if X_test is None:
            test_sc = None
        elif metric == 'acc':
            test_sc = 100 * self._svc_score(X_test, y_test)
        else:
            test_sc = matthews_corrcoef(y_test, self._svc_predict(X_test))
        if plot:
            self._plot_training_decision(X_train, y_train)
        return train_sc, test_sc

    def setup_yf_SVM_3D(self, x, y_train, x_test=None, y_test=None, C=10.,
                        gamma=1., fs=0.1, plot=False, cyl=False,
                        gridsearch=False, cvals=None, gvals=None, pca_dim=10,
                        backend='sklearn', device=None):
        """Train an RBF SVC in cylindrical stress space (seq/sy-1, theta/pi)
        with periodic augmentation of the polar angle.  ``backend='jax'``
        fits with the card's dual solver on ``device`` instead of
        sklearn."""
        self.gam_yf = gamma
        self.C_yf = C
        assert self.sdim == 3
        if self.txdat:
            raise NotImplementedError('Texture not yet implemented for 3D data.')
        if self.msparam is None:
            self.scale_seq = self.sy
        else:
            self.scale_seq = 0.
            self.scale_wh = 0.
            self.scale_text = np.zeros(self.Nset)
            for i in range(self.Nset):
                self.scale_seq += self.msparam[i]['sy_av'] / self.Nset
                self.scale_wh += self.msparam[i]['peeq_max'] / self.Nset
                self.scale_text[i] = np.average(self.msparam[i]['texture'])
        N = len(x)
        X_train = np.zeros((N, self.Ndof))
        if not cyl:
            X_train[:, 0] = sig_eq_j2(x[:, 0:3]) / self.scale_seq - 1.
            X_train[:, 1] = sig_polar_ang(x[:, 0:3]) / np.pi
        else:
            X_train[:, 0] = x[:, 0] / self.scale_seq - 1.
            X_train[:, 1] = x[:, 1] / np.pi
        if self.whdat:
            X_train[:, self.ind_wh] = x[:, self.ind_wh] / self.scale_wh

        # copy left/right borders to enforce periodicity in theta
        indr = np.nonzero(X_train[:, 1] > 1. - fs)
        indl = np.nonzero(X_train[:, 1] < fs - 1.)
        Xr = X_train[indr]
        Xl = X_train[indl]
        Xr[:, 1] -= 2.
        Xl[:, 1] += 2.
        X_train = np.append(X_train, np.append(Xr, Xl, axis=0), axis=0)
        y_train = np.append(y_train,
                            np.append(y_train[indr], y_train[indl], axis=0),
                            axis=0)
        X_test = None
        if x_test is not None:
            Ntest = len(x_test)
            X_test = np.zeros((Ntest, self.Ndof))
            if not cyl:
                X_test[:, 0] = sig_eq_j2(x_test) / self.scale_seq - 1.
                X_test[:, 1] = sig_polar_ang(x_test) / np.pi
            else:
                X_test[:, 0] = x_test[:, 0] / self.scale_seq - 1.
                X_test[:, 1] = x_test[:, 1] / np.pi
            if self.whdat:
                X_test[:, self.ind_wh] = x_test[:, self.ind_wh + 1] / self.scale_wh

        if gridsearch:
            if cvals is None:
                cvals = [2, 4, 6, 8, 10, 15]
                if C not in cvals:
                    cvals.append(C)
            if gvals is None:
                gvals = [1, 1.5, 2, 2.5, 3]
                if gamma not in gvals:
                    gvals.append(gamma)
            if backend == 'jax':
                from pylabfea_tpu_torch.ml_train import gridsearch_svc
                self.C_yf, self.gam_yf, _ = gridsearch_svc(
                    X_train, y_train, cvals, gvals, device=device)
            else:
                from sklearn import svm
                from sklearn.model_selection import GridSearchCV
                grid = GridSearchCV(svm.SVC(), {'C': cvals, 'gamma': gvals},
                                    refit=True, verbose=3, n_jobs=-1)
                grid.fit(X_train, y_train)
                self.gam_yf = grid.best_params_["gamma"]
                self.C_yf = grid.best_params_["C"]
        self._fit_svc_backend(X_train, y_train, backend, device=device)
        train_sc = 100 * self._svc_score(X_train, y_train)
        test_sc = None if X_test is None \
            else 100 * self._svc_score(X_test, y_test)
        if plot:
            self._plot_training_decision(X_train, y_train)
        return train_sc, test_sc

    def train_SVC(self, C=10, gamma=4, Nlc=36, Nseq=25, fs=0.3, extend=False,
                  mat_ref=None, sdata=None, plot=False, fontsize=16,
                  gridsearch=False, cvals=None, gvals=None, Fe=0.1, Ce=0.99,
                  scaler=None, pca=None, train_index=None, test_index=None,
                  verbose=1, metric='acc', pca_dim=10, reversal=None,
                  backend='sklearn', device=None):
        """Top-level SVC training: generates training data from a reference
        material, explicit yield stresses or microstructure data (msparam),
        then fits the yield-function classifier.  For texture data with
        gridsearch, a K-fold cross validation over textures is performed.

        ``backend='jax'`` (spelled as in the JAX API) fits the SVC with the
        card's projected-gradient dual solver (``ml_train.fit_svc``, float32
        as the JAX trainer) on ``device`` (the card when None) instead of
        sklearn's libsvm — the path on a machine without scikit-learn."""
        if reversal is not None:
            print('WARNING in "train_SVC": Parameter "reversal" is deprecated '
                  'and will be ignored.')
        if self.txdat and gridsearch:
            return self._train_svc_texture_gridsearch(
                C, gamma, Nlc, Nseq, extend, mat_ref, sdata, plot, fontsize,
                Fe, Ce, scaler, pca, verbose, metric, pca_dim, cvals, gvals)

        xtest = None
        ytest = None
        if self.msparam is None:
            if sdata is None:
                if mat_ref is None:
                    raise ValueError('create_data_sig: Neither sdata nor '
                                     'mat_ref are provided, cannot generate '
                                     'training data')
                self.elasticity(CV=mat_ref.CV)
                self.plasticity(sy=mat_ref.sy, sdim=mat_ref.sdim)
                xt, yt = self.create_sig_data(N=Nlc, mat_ref=mat_ref,
                                              Nseq=Nseq, Fe=Fe, Ce=Ce,
                                              extend=extend)
            else:
                Nlc = len(sdata[:, 0])
                seq = sig_eq_j2(sdata)
                self.plasticity(sy=np.mean(seq), sdim=len(sdata[0, :]))
                xt, yt = self.create_sig_data(sdata=sdata, Nseq=Nseq, Fe=Fe,
                                              Ce=Ce, extend=extend)
            self.Ndof = 2 if self.sdim == 3 else 6
        else:
            x_list, y_list = [], []
            if train_index is None:
                train_index = range(len(self.msparam))
            for idx_ms in train_index:
                Nlc, N0, x_tr, y_tr = self._create_data_for_ms(
                    Ce=Ce, Fe=Fe, Nseq=Nseq, extend=extend, idx_ms=idx_ms)
                x_list.append(x_tr)
                y_list.append(y_tr)
            xt = np.concatenate(x_list, axis=0)
            yt = np.concatenate(y_list, axis=0)
            if test_index is not None:
                xte, yte = [], []
                for idx_ms in test_index:
                    _, _, x_ts, y_ts = self._create_data_for_ms(
                        Ce=Ce, Fe=Fe, Nseq=Nseq, extend=extend, idx_ms=idx_ms)
                    xte.append(x_ts)
                    yte.append(y_ts)
                xtest = np.concatenate(xte, axis=0)
                ytest = np.concatenate(yte, axis=0)

        if np.any(np.abs(yt) <= 0.99):
            warnings.warn('train_SVC: result vector for yield function '
                          'contains more categories than "-1" and "+1".')
        if self.sdim == 3:
            train_sc, test_sc = self.setup_yf_SVM_3D(
                xt, yt, C=C, gamma=gamma, fs=0.3, plot=False,
                gridsearch=gridsearch, cvals=cvals, gvals=gvals,
                backend=backend, device=device)
        else:
            train_sc, test_sc = self.setup_yf_SVM_6D(
                xt, yt, x_test=xtest, y_test=ytest, C=C, gamma=gamma,
                gridsearch=gridsearch, cvals=cvals, gvals=gvals,
                verbose=verbose, metric=metric, pca_dim=pca_dim,
                backend=backend, device=device)
        if not gridsearch:
            print(f"Training completed with score: {train_sc}")
        if plot:
            self._plot_trained_yield_loci(xt, yt, Nlc, fontsize)
        return train_sc, test_sc

    def _train_svc_texture_gridsearch(self, C, gamma, Nlc, Nseq, extend,
                                      mat_ref, sdata, plot, fontsize, Fe, Ce,
                                      scaler, pca, verbose, metric, pca_dim,
                                      cvals, gvals, n_splits=5):
        """K-fold cross validation over textures: full textures are held out
        per fold so the score measures generalization to unseen textures."""
        import random as pyrandom
        from sklearn.model_selection import KFold, ParameterGrid

        if cvals is None:
            cvals = [1, 5, 10, 20, 50]
            if C not in cvals:
                cvals.append(C)
        if gvals is None:
            gvals = [0.3, 0.5, 1, 5, 10]
            if gamma not in gvals:
                gvals.append(gamma)
        hp_grid = ParameterGrid({'C': cvals, 'gamma': gvals})
        best_cv_score = 0
        C_cv = 0
        gamma_cv = 0
        for idx_pair, hp in enumerate(list(hp_grid)):
            if verbose:
                print(f"HP Run {idx_pair} / {len(list(hp_grid))}: {hp}")
            pyrandom.seed(42)
            kf = KFold(n_splits=n_splits, shuffle=True, random_state=42)
            test_scores = []
            for train_index, test_index in kf.split(self.msparam):
                _, ts = self.train_SVC(C=hp['C'], gamma=hp['gamma'], Nlc=Nlc,
                                       Nseq=Nseq, extend=extend,
                                       mat_ref=mat_ref, sdata=sdata,
                                       plot=False, fontsize=fontsize,
                                       gridsearch=False, Fe=Fe, Ce=Ce,
                                       scaler=scaler, pca=pca,
                                       train_index=train_index,
                                       test_index=test_index,
                                       verbose=verbose, metric=metric,
                                       pca_dim=pca_dim)
                test_scores.append(ts)
            cv_score = np.mean(test_scores)
            if cv_score > best_cv_score:
                best_cv_score = cv_score
                C_cv = hp['C']
                gamma_cv = hp['gamma']
        if C_cv == 0 or gamma_cv == 0:
            warnings.warn("CV couldn't find better values for C and gamma. "
                          f"Best mean {metric} across test folds: {best_cv_score}")
        train_sc, test_sc = self.train_SVC(
            C=C_cv, gamma=gamma_cv, Nlc=Nlc, Nseq=Nseq, extend=extend,
            mat_ref=mat_ref, sdata=sdata, plot=plot, fontsize=fontsize,
            gridsearch=False, Fe=Fe, Ce=Ce, scaler=scaler, pca=pca,
            verbose=verbose, metric=metric, pca_dim=pca_dim)
        print(f"Grid search finished. Best HP: C={C_cv}, gamma={gamma_cv}")
        return train_sc, test_sc

    def _create_data_for_ms(self, Ce, Fe, Nseq, extend, idx_ms, reversal=None):
        """Create the training set for one microstructure in ``msparam``:
        stress features scaled around the yield locus, plus work-hardening
        and texture feature columns.  Returns (Nlc, N0, xt, yt)."""
        if reversal is not None:
            print('WARNING in "_create_data_for_ms": Parameter "reversal" is '
                  'deprecated and will be ignored.')
        ms = self.msparam[idx_ms]
        Nlc = ms['Nlc']
        if self.whdat:
            Ndinp = len(ms['flow_stress'])
            Nlc -= ms['Ncyl']
        else:
            Ndinp = len(ms['sig_ideal'])
        Nsdata = 2 * Nseq + 4 if extend else 2 * Nseq
        N0 = Nlc * Nsdata
        Nt = Ndinp * Nsdata
        xt = np.zeros((Nt, self.Ndof))
        key = 'flow_stress' if self.whdat else 'sig_ideal'
        sig_train, yt = self.create_sig_data(sdata=ms[key], Nseq=Nseq, Fe=Fe,
                                             Ce=Ce, extend=extend)
        xt[:, 0:self.sdim] = sig_train
        if self.whdat:
            rev = 'normalized_accumulated_strain' in self.msparam[0]
            if rev and 'max_stress' not in self.msparam[0]:
                raise ValueError("Data contains 'normalized_accumulated_"
                                 "strain' but not 'max_stress'.")
            if rev and self.Ndof < 2 * self.sdim + 2:
                raise ValueError("Data for 'normalized_accumulated_strain' "
                                 "given but not enough DOF defined.")
            epl = self.msparam[0]['plastic_strain']
            for j in range(Nsdata):
                rows = slice(j * Ndinp, (j + 1) * Ndinp)
                xt[rows, self.ind_wh:self.ind_wh + self.sdim] = epl
                if rev:
                    xt[rows, self.ind_wh + self.sdim] = \
                        self.msparam[0]['normalized_accumulated_strain']
                    xt[rows, self.ind_wh + self.sdim + 1] = \
                        self.msparam[0]['max_stress']
        if self.txdat:
            xt[:, self.ind_tx:] = ms['texture']
        return Nlc, N0, xt, yt

    def test_data_generation(self, C=10, gamma=4, Nlc=36, Nseq=25, fs=0.3,
                             extend=False, mat_ref=None, sdata=None,
                             fontsize=16, gridsearch=False, cvals=None,
                             gvals=None, Fe=0.1, Ce=0.99, reversal=False):
        """Generate a labeled test set with the same recipe used for training
        data (for scoring a trained SVC)."""
        if self.msparam is None:
            if sdata is None:
                if mat_ref is None:
                    raise ValueError('create_data_sig: Neither sdata nor '
                                     'mat_ref are provided')
                self.elasticity(CV=mat_ref.CV)
                self.plasticity(sy=mat_ref.sy, sdim=mat_ref.sdim)
                xt, yt = self.create_sig_data(N=Nlc, mat_ref=mat_ref,
                                              Nseq=Nseq, Fe=Fe, Ce=Ce,
                                              extend=extend)
            else:
                Nlc = len(sdata[:, 0])
                seq = sig_eq_j2(sdata)
                self.plasticity(sy=np.mean(seq), sdim=len(sdata[0, :]))
                xt, yt = self.create_sig_data(sdata=sdata, Nseq=Nseq, Fe=Fe,
                                              Ce=Ce, extend=extend)
            self.Ndof = 2 if self.sdim == 3 else 6
        else:
            if self.whdat:
                Ndinp = len(self.msparam[0]['flow_stress'])
                key = 'flow_stress'
            else:
                Ndinp = len(self.msparam[0]['sig_ideal'])
                key = 'sig_ideal'
            Nsdata = 2 * Nseq + 4 if extend else 2 * Nseq
            xt = np.zeros((Ndinp * Nsdata, self.Ndof))
            sig_train, yt = self.create_sig_data(sdata=self.msparam[0][key],
                                                 Nseq=Nseq, extend=extend,
                                                 Fe=Fe, Ce=Ce)
            xt[:, 0:self.sdim] = sig_train
            if self.whdat:
                rev = reversal or \
                    'normalized_accumulated_strain' in self.msparam[0]
                epl = self.msparam[0]['plastic_strain']
                for j in range(Nsdata):
                    rows = slice(j * Ndinp, (j + 1) * Ndinp)
                    xt[rows, self.sdim:self.sdim + self.ind_wh] = epl
                    if rev:
                        xt[rows, self.sdim + self.ind_wh] = \
                            self.msparam[0]['normalized_accumulated_strain']
                        xt[rows, self.sdim + self.ind_wh + 1] = \
                            self.msparam[0]['max_stress']
                        xt[rows, self.sdim + self.ind_wh + 2] = \
                            self.msparam[0]['flag']
        return xt, yt

    def create_sig_data(self, N=None, mat_ref=None, sdata=None, Nseq=2,
                        sflow=None, offs=0.01, extend=False, rand=False,
                        Fe=0.1, Ce=0.99):
        """Create labeled training stresses on the deviatoric plane: yield
        stresses (from root finding on ``mat_ref`` or given ``sdata``) scaled
        into an elastic band [Fe..Ce] (label -1) and a plastic band
        [2-Ce..2-Fe] (label +1); ``extend`` adds far-field plastic points.

        Returns (stresses (M, sdim), labels (M,))."""
        from pylabfea_tpu_torch.training import load_cases

        if sflow is not None:
            print('WARNING: Parameter "sflow" no longer used in function '
                  '"create_sig_data".')
        if sdata is None:
            if mat_ref is None:
                raise ValueError('create_data_sig: Neither sdata nor mat_ref '
                                 'are provided, cannot generate training data')
            if self.sdim == 3:
                if N is None:
                    warnings.warn('create_sig_data: N not provided, using 36')
                    N = 36
                theta = np.linspace(-np.pi, np.pi, N) if not rand \
                    else 2. * (np.random.rand(N) - 0.5) * np.pi
                sc = np.ones((N, 2))
                sc[:, 1] = theta
                su = sig_cyl2princ(sc)
            else:
                if N is None:
                    warnings.warn('create_sig_data: N not provided, using 300')
                    N = 300
                n3 = int(N / 3)
                su = load_cases(n3, N - n3)
                if self.dev_only:
                    su = sig_dev(su)
            x1 = fsolve(mat_ref.find_yloc, np.ones(N) * mat_ref.sy,
                        args=(su,), xtol=1.e-5)
            sdata = su * x1[:, None]
        else:
            i = len(sdata)
            if (N is not None) and (N != i):
                warnings.warn(f'create_sig_data: N and dimension of sdata do '
                              f'not agree. Continuing with N={i}')
            if mat_ref is not None:
                warnings.warn('create_sig_data: using sdata for training, '
                              'ignoring mat_ref')
            N = i
        if self.dev_only:
            sdata = sig_dev(sdata)
        if Nseq == 1:
            midpoint = 0.5 * (Fe + Ce)
            seq = np.array([midpoint, 2. - midpoint])
        else:
            seq = np.append(np.linspace(Fe, Ce, Nseq),
                            np.linspace(2. - Ce, 2. - Fe, Nseq))
        if extend:
            seq = np.append(seq, np.array([2.4, 3., 4., 5.]))
        Nd = len(seq)
        st = np.zeros((N * Nd, self.sdim))
        yt = np.zeros(N * Nd)
        for i in range(Nd):
            st[i * N:(i + 1) * N, :] = np.asarray(sdata)[:, 0:self.sdim] * seq[i]
            yt[i * N:(i + 1) * N] = -1. if i < Nseq else +1.
        return st, yt

    def setup_fgrad_SVM(self):
        """Fit SVR regressors to plastic strain increments in the data to
        represent the yield-function gradient (plus a hardening-rate SVR)."""
        from sklearn import svm
        from sklearn.preprocessing import StandardScaler

        if not self.whdat:
            raise ValueError('No strain hardening data available.')
        C = self.C_yf
        gamma = self.gam_yf
        mk = lambda: svm.SVR(C=C, cache_size=3000, epsilon=0.01, gamma=gamma,
                             kernel='rbf', tol=0.0001)
        self._svm_grads = [mk() for _ in range(6)]
        self.svm_khard = mk()
        eps = self.msparam[0]['plastic_strain']
        sig = self.msparam[0]['flow_stress']
        peeq = eps_eq(eps)
        seq = sig_eq_j2(sig)
        ndata = len(seq)
        X_gt = np.concatenate((sig, eps), axis=1)
        y_gt = np.zeros((ndata, 6))
        nz = peeq > 1.e-12
        y_gt[nz] = eps[nz] / peeq[nz, None]
        y_kh = np.zeros(ndata)
        dpe = np.diff(peeq)
        good = np.abs(dpe) > 1.e-12
        y_kh[:-1][good] = np.diff(seq)[good] / dpe[good]
        self.sc_feat = StandardScaler().fit(X_gt)
        self.sc_grad = StandardScaler().fit(y_gt)
        self.sc_khard = StandardScaler().fit(y_kh.reshape(-1, 1))
        x_sc = self.sc_feat.transform(X_gt)
        y_sc = self.sc_grad.transform(y_gt)
        y_kh_sc = self.sc_khard.transform(y_kh.reshape(-1, 1))
        for i, g in enumerate(self._svm_grads):
            g.fit(x_sc, y_sc[:, i])
        self.svm_khard.fit(x_sc, y_kh_sc.flatten())
        # keep reference-compatible attribute names
        (self.svm_grad0, self.svm_grad1, self.svm_grad2, self.svm_grad3,
         self.svm_grad4, self.svm_grad5) = self._svm_grads
        self.ML_grad = True

    # =================================================================
    # parameter export / serialization
    # =================================================================
    def export_MLparam(self, sname, source=None, file=None,
                       path='../../models/', descr=None, param=None):
        """Write trained SVC parameters (support vectors, dual coefficients,
        intercept, scalings, elastic constants) to an Abaqus-readable CSV
        (8 values per line) plus a JSON metadata file.  Layout matches the
        reference UMAT contract (reference material.py:2185-2217 /
        ml_umat.f:33-55)."""
        from json import dump
        from datetime import date
        import getpass
        import platform

        if not self.ML_yf:
            raise AttributeError('export_MLparam: No ML flow rule defined.')
        if self.msparam is None:
            self.Nset = 1
            self.epc = 0.
            self.scale_wh = 1.
            self.scale_text = [1.]
        if self.Nset > 9:
            raise ValueError('export_MLparam: Too many sets to export.')
        if (descr is not None and param is not None) and len(descr) != len(param):
            raise ValueError('Lists for descr and param must have the same '
                             'lengths.')
        if file is None:
            file = 'abq_' + self.name
        if path[-1] != '/':
            path += '/'
        file = path + file

        if self._svc is None:
            raise AttributeError('export_MLparam: no trained SVC parameters '
                                 '(train_SVC must run first).')
        dc = np.asarray(self._svc.dual_coef)
        nsv = len(dc)
        nlin = int((nsv * (self.Ndof + 1) + 30) / 8) + 1
        Ndata = nlin * 8
        props = np.zeros(Ndata)
        props[0] = nsv
        props[1] = self.Ndof
        props[2] = self.C11
        props[3] = self.C12
        props[4] = self.C44
        props[5] = self._svc.intercept
        props[6] = self.gam_yf
        props[7] = self.epc
        props[8] = self.scale_seq
        props[9] = self.scale_wh
        if self.CV is None:
            props[10:16] = -1
        else:
            props[10] = self.CV[1, 1]
            props[11] = self.CV[2, 2]
            props[12] = self.CV[0, 2]
            props[13] = self.CV[1, 2]
            props[14] = self.CV[4, 4]
            props[15] = self.CV[5, 5]
        props[16] = -1. if self.dev_only else 0.
        props[17] = self.Nset
        props[18:18 + self.Nset] = self.scale_text
        props[29:29 + nsv] = dc
        nl = (self.Ndof + 1) * nsv + 29
        props[29 + nsv:nl] = np.asarray(
            self._svc.support_vectors).flatten()
        np.savetxt(file + '-svm.csv', props.reshape((nlin, 8)),
                   delimiter=', ', newline='\n')

        today = str(date.today())
        try:
            owner = getpass.getuser()
        except Exception:
            owner = 'unknown'
        sys_info = platform.uname()
        descr = list(descr) if descr is not None else []
        param = list(param) if param is not None else []
        descr.extend(['Ndata', 'gamma', 'C'])
        param.extend([Ndata, self.gam_yf, self.C_yf])
        from pylabfea_tpu_torch import __version__
        meta = {
            "Info": {
                "Owner": owner,
                "Institution": "pylabfea_tpu_torch",
                "Date": today,
                "Description": "SVC-parameters for plasticity model",
                "Method": "Support Vector Classification",
                "System": {
                    "sysname": sys_info[0], "nodename": sys_info[1],
                    "release": sys_info[2], "version": sys_info[3],
                    "machine": sys_info[4]},
            },
            "Model": {
                "Creator": "pylabfea_tpu_torch",
                "Version": __version__,
                "Repository": "",
                "Input": source,
                "Script": sname,
                "Names": descr,
                "Parameters": param
            },
            "Data": {
                "Class": 'SVC_parameters',
                "Type": 'CSV',
                "File": file + '-svm.csv',
                "Separator": ',',
                "Header": None,
                "Format": (nlin, 8),
                "Names": ['nsv', 'nsd', 'C11', 'C12', 'C44', 'rho', 'gamma',
                          'epc', 'scale_seq', 'scale_wh', 'C22', 'C33', 'C13',
                          'C23', 'C55', 'C66', 'Nset', 'scale_text[0:Nset]',
                          'dual_coef[0:nsv]', 'sup_vec[0:nsv,0:nsd]'],
                "Units": {'Stress': 'MPa', 'Strain': 'None', 'Disp': 'mm',
                          'Force': 'N'}
            }
        }
        with open(file + '-svm_meta.json', 'w') as fp:
            dump(meta, fp, indent=2)

    def from_MLparam(self, name, path='../../models/'):
        """Recreate an ML material from parameters written by
        ``export_MLparam`` (CSV + metadata JSON)."""
        import json
        import os
        if path and path[-1] != '/':
            path += '/'
        with open(os.path.join(path, name + '-svm_meta.json')) as fp:
            meta = json.load(fp)
        props = np.loadtxt(os.path.join(path, name + '-svm.csv'),
                           delimiter=',').ravel()
        nsv = int(round(props[0]))
        ndof = int(round(props[1]))
        C11, C12, C44 = props[2], props[3], props[4]
        rho = props[5]
        gamma = props[6]
        self.epc = props[7]
        self.scale_seq = props[8]
        self.scale_wh = props[9]
        self.dev_only = props[16] < -0.5
        self.Nset = int(round(props[17]))
        self.scale_text = props[18:18 + self.Nset]
        dc = props[29:29 + nsv]
        sv = props[29 + nsv:29 + nsv + ndof * nsv].reshape((nsv, ndof))
        if props[10] > 0:
            CV = np.zeros((6, 6))
            CV[0, 0] = C11
            CV[1, 1] = props[10]
            CV[2, 2] = props[11]
            CV[0, 1] = CV[1, 0] = C12
            CV[0, 2] = CV[2, 0] = props[12]
            CV[1, 2] = CV[2, 1] = props[13]
            CV[3, 3] = C44
            CV[4, 4] = props[14]
            CV[5, 5] = props[15]
            self.elasticity(CV=CV)
        else:
            self.elasticity(C11=C11, C12=C12, C44=C44)
        self.Ndof = ndof
        self.sdim = 3 if ndof == 2 else 6
        self.plasticity(sy=self.scale_seq, sdim=self.sdim)
        self._svc = svc_ops.SVCParams(support_vectors=sv, dual_coef=dc,
                                      intercept=float(rho), gamma=float(gamma))
        self.gam_yf = float(gamma)
        self.svm_yf = None
        self.ML_yf = True
        self.msg['yield_fct'] = 'ML_yf-imported'
        return meta

    def pckl(self, name=None, path='../../materials/'):
        """Pickle this material (avoids re-training ML flow rules)."""
        if name is None:
            name = 'mat_' + self.name + '.pkl'
        if path[-1] != '/':
            path += '/'
        with open(path + name, 'wb') as output:
            pickle.dump(self, output, pickle.HIGHEST_PROTOCOL)

    # =================================================================
    # data-driven material definition
    # =================================================================
    def from_data(self, param):
        """Define material properties from ``Data.mat_data`` dictionaries
        (elasticity, plasticity, work hardening, textures)."""
        self.msparam = np.array(param, ndmin=1)
        self.Nset = len(self.msparam)
        self.whdat = self.msparam[0]['wh_data']
        Ntext = self.msparam[0]['Ntext']
        if self.Nset > 1:
            if not self.msparam[0]['tx_data']:
                raise ValueError('Multiple microstructures assigned to '
                                 'material but no tx_data in given param dict.')
            self.txdat = True
        else:
            self.txdat = self.msparam[0]['tx_data']
        if self.sdim is None:
            self.sdim = self.msparam[0]['sdim']
        elif self.sdim != self.msparam[0]['sdim']:
            self.sdim = self.msparam[0]['sdim']
            warnings.warn('from_data: Microstructure has changed definition '
                          f'of sdim. New value={self.sdim}')
        if self.sdim != 3 and self.sdim != 6:
            raise ValueError('Value of sdim must be either 3 or 6')
        if self.txdat:
            if self.tdim is None:
                self.tdim = self.msparam[0]['tdim']
            elif self.tdim != self.msparam[0]['tdim']:
                self.tdim = self.msparam[0]['tdim']
                warnings.warn('from_data: Microstructure has changed '
                              f'definition of tdim. New value={self.tdim}')
        else:
            self.tdim = None
        self.epc = self.msparam[0]['epc']
        for i in range(1, self.Nset):
            h3 = self.msparam[i]['Ntext'] != Ntext
            h4 = self.msparam[i]['sdim'] != self.sdim
            h5 = self.txdat and self.msparam[i]['tdim'] != self.tdim
            if h3 or h4 or h5:
                raise ValueError(f'Inconsistent data structure of set #{i}')
        self.Ndof = 2 if self.sdim == 3 else 6
        if self.whdat:
            self.ind_wh = self.Ndof
            self.Ndof += self.sdim + 3
        if self.txdat:
            self.ind_tx = self.Ndof
            self.Ndof += self.tdim
        if self.msparam[0]['elast_const'] is None:
            print('WARNING: No data on elastic properties in data.')
        else:
            self.elasticity(CV=self.msparam[0]['elast_const'])
        self.plasticity(sy=self.msparam[0]['sy_av'], sdim=self.sdim)
        if self.msparam[0]['tx_descriptor'] == 'VF':
            raise NotImplementedError

    def set_texture(self, current, verb=False):
        """Set the current texture-mixture parameter; re-interpolates the
        yield strength from the assigned microstructures."""
        self.tx_cur = np.array(current, ndmin=1)
        sm = np.sum(self.tx_cur)
        if sm > 1. or sm < 0.:
            raise ValueError('set_texture: Bad value for mixture parameter')
        if len(self.tx_cur) != self.Nset:
            raise ValueError('set_texture: Wrong dimension of mixture parameter')
        wght = np.ones(self.Nset) / self.Nset if sm < 1.e-3 else self.tx_cur / sm
        self.sy = 0.
        index = []
        for i, ms in enumerate(self.msparam):
            hh = ms['texture'] - self.tx_cur[i]
            index.append(np.argmin(np.abs(hh)))
            self.sy += ms['sy_av'] * wght[i]
        if verb:
            print('New texture parameters: ', self.tx_cur)
            print('Yield strength:', self.sy, 'MPa')
        self.ms_index = index

    # =================================================================
    # post-processing and graphics
    # =================================================================
    def ellipsis(self, a=1., b=1. / np.sqrt(3.), n=72):
        """Ellipse along the 45-degree axis (isotropic yield locus outline)."""
        t = np.arange(0., 2.1 * np.pi, np.pi / n)
        return a * np.cos(t) - b * np.sin(t), a * np.cos(t) + b * np.sin(t)

    @staticmethod
    def _symmetrize_about_zero(Z):
        """Clamp the wider side of a diverging field's value range to the
        magnitude of the narrower side, so zero sits at the colormap
        center."""
        lo, hi = float(np.amin(Z)), float(np.amax(Z))
        return np.minimum(Z, -lo) if -lo < hi else np.maximum(Z, -hi)

    def plot_data(self, Z, axs, xx, yy, field=True, c='red'):
        """Contour (and optional field) plot of yield-function values."""
        Z = self._symmetrize_about_zero(np.asarray(Z)).reshape(xx.shape)
        if field:
            axs.imshow(Z, origin='lower', aspect='auto',
                       interpolation='nearest', cmap='PuOr_r',
                       extent=(xx.min(), xx.max(), yy.min(), yy.max()))
        return axs.contour(xx, yy, Z, levels=[0], linewidths=1.5,
                           linestyles='solid', colors=c)

    def _plot_training_decision(self, X_train, y_train):  # pragma: no cover
        import matplotlib.pyplot as plt
        xx, yy = np.meshgrid(np.linspace(-1.2, 1.2, 50),
                             np.linspace(-1.2, 1.2, 50))
        fig, ax = plt.subplots(figsize=(10, 8))
        feat = np.c_[yy.ravel(), xx.ravel()]
        if self.Ndof > 2:
            pads = [np.ones(2500) * self.scale_wh]
            if self.Ndof > 3:
                pads.append(np.ones(2500) * np.mean(self.scale_text))
            feat = np.c_[feat, np.column_stack(pads)[:, :self.Ndof - 2]]
        Z = svc_ops.decision_function_np(self._svc, feat)
        self.plot_data(Z, ax, xx, yy, c='black')
        ax.scatter(X_train[:, 1], X_train[:, 0], s=10, c=y_train,
                   cmap=plt.cm.Paired)
        ax.set_xlabel(r'$\theta/\pi$')
        ax.set_ylabel(r'$\sigma_{eq}/\sigma_y$')
        plt.show()

    def _plot_trained_yield_loci(self, xt, yt, Nlc, fontsize):  # pragma: no cover
        import matplotlib.pyplot as plt
        theta = np.linspace(-np.pi, np.pi, 36)
        plt.figure(figsize=(10, 8))
        sflow = self.get_sflow(0.)
        snorm = sig_cyl2princ(np.array([sflow * np.ones(36) * np.sqrt(1.5),
                                        theta]).T)
        x1 = fsolve(self.find_yloc, np.ones(36), args=(snorm,), xtol=1.e-5)
        s_yld = sig_eq_j2(snorm * x1[:, None])
        plt.polar(theta, s_yld, '-k', label='ML yield locus')
        plt.legend()
        plt.show()

    def plot_yield_locus(self, fun=None, label=None, data=None, trange=1.e-2,
                         peeq=0., xstart=None, xend=None, axis1=None,
                         axis2=None, iso=False, ref_mat=None, field=False,
                         Nmesh=100, file=None, fontsize=20, scaling=True):
        """Plot cuts through the yield locus in principal stress space."""
        import matplotlib.pyplot as plt
        from matplotlib.lines import Line2D

        axis1 = [0] if axis1 is None else list(axis1)
        axis2 = [1] if axis2 is None else list(axis2)
        if xstart is None:
            xstart = -2. if scaling else -2. * self.sy
        if xend is None:
            xend = 2. if scaling else 2. * self.sy
        xx, yy = np.meshgrid(np.linspace(xstart, xend, Nmesh),
                             np.linspace(xstart, xend, Nmesh))
        Nm2 = Nmesh * Nmesh
        Nc = len(axis1)
        if len(axis2) != Nc:
            raise ValueError('plot_yield_locus: mismatch in dimensions of '
                             'axis1 and axis2')
        fig, axs = plt.subplots(nrows=1, ncols=Nc,
                                figsize=(10, 8) if Nc == 1 else (20, 5))
        for j in range(Nc):
            ax = axs if Nc == 1 else axs[j]
            lines, labels = [], []
            s = [None, None, None]
            a1, a2 = axis1[j], axis2[j]
            if a1 == 3:
                s[0] = xx.ravel()
                s[1] = xx.ravel()
                ref_mat = None
                a1 = 0
            elif a1 in (0, 1, 2):
                s[a1] = xx.ravel()
            else:
                s[0] = xx.ravel()
                a1 = 0
            if a2 == 3:
                s[2] = yy.ravel()
                a2 = 2
            elif a2 in (0, 1, 2) and s[a2] is None:
                s[a2] = yy.ravel()
            else:
                if s[1] is None:
                    s[1] = yy.ravel()
                    a2 = 1
            si3 = [i for i in range(3) if s[i] is None]
            si3 = si3[-1] if si3 else 1
            for i in range(3):
                if s[i] is None:
                    s[i] = np.zeros(Nm2)
            sig = np.c_[s[0], s[1], s[2]]
            sf = 1. / self.sy if scaling else 1.
            if scaling:
                sig = sig * self.sy
            Z = (self.calc_yf(sig, epl=peeq, pred=True) if fun is None
                 else fun(sig, pred=True)) * sf
            if label is None:
                label = self.name
            contour = self.plot_data(Z, ax, xx, yy, field=field)
            lines.append(Line2D([0], [0], color=contour.colors, lw=2))
            labels.append(label)
            if ref_mat is not None:
                Z = ref_mat.calc_yf(sig, epl=peeq, pred=True) * sf
                contour = self.plot_data(Z, ax, xx, yy, field=False, c='black')
                lines.append(Line2D([0], [0], color=contour.colors, lw=2))
                labels.append(ref_mat.name)
            if iso:
                x0, y0 = self.ellipsis()
                if not scaling:
                    x0, y0 = x0 * self.sy, y0 * self.sy
                hl = ax.plot(x0, y0, '-b')
                lines.extend(hl)
                labels.append('isotropic J2')
            if data is not None:
                dat = np.array(data) * sf
                ir = np.nonzero(np.logical_and(
                    np.abs(dat[:, si3]) < trange,
                    np.logical_and(dat[:, a1] > xstart,
                                   dat[:, a1] < xend)))[0]
                yf = np.sign(self.calc_yf(np.array(data)[ir, :], epl=peeq))
                ax.scatter(dat[ir, a1], dat[ir, a2], s=60, c=yf,
                           cmap=plt.cm.Paired, edgecolors='k')
            ax.legend(lines, labels, loc='upper left', fontsize=fontsize - 4)
        if file is not None:
            fig.savefig(file + '.pdf', format='pdf', dpi=300)
        return axs

    def calc_properties(self, size=2, Nel=2, verb=False, eps=0.005,
                        min_step=None, sigeps=False,
                        load_cases=('stx', 'sty', 'et2', 'ect')):
        """Characterize the material by running small plane-stress FE models
        along canonical load paths (uniaxial x/y, equibiaxial, pure shear);
        fills ``prop``, ``propJ2`` and optionally ``sigeps``."""
        from pylabfea_tpu_torch.femodel import Model

        def calc_strength(vbc1, nbc1, vbc2, nbc2, sel):
            fe = Model(dim=2, planestress=True)
            fe.geom([size], LY=size)
            fe.assign([self])
            fe.bcleft(0.)
            fe.bcbot(0.)
            fe.bcright(vbc1, nbc1)
            fe.bctop(vbc2, nbc2)
            fe.mesh(NX=Nel, NY=Nel)
            fe.solve(verb=verb, min_step=min_step)
            seq = self.calc_seq(fe.sgl)
            eeq = eps_eq(fe.egl)
            peeq = eps_eq(fe.epgl)
            iys = np.nonzero(peeq < 1.e-2)
            self.prop[sel]['ys'] = seq[iys[0][-1]]
            self.prop[sel]['seq'] = seq
            self.prop[sel]['eeq'] = eeq
            self.prop[sel]['peeq'] = peeq
            seq = sig_eq_j2(fe.sgl)
            iys = np.nonzero(peeq < 1.e-6)
            self.propJ2[sel]['ys'] = seq[iys[0][-1]]
            self.propJ2[sel]['seq'] = seq
            self.propJ2[sel]['eeq'] = eeq
            self.propJ2[sel]['peeq'] = peeq
            if sigeps:
                self.sigeps[sel]['sig'] = fe.sgl
                self.sigeps[sel]['eps'] = fe.egl
                self.sigeps[sel]['epl'] = fe.epgl

        styles = {'stx': ('-r', 'uniax-x'), 'sty': ('-b', 'uniax-y'),
                  'et2': ('-k', 'equibiax'), 'ect': ('-m', 'shear')}
        for case in load_cases:
            if case == 'stx':
                calc_strength(eps * size, 'disp', 0., 'force', 'stx')
            elif case == 'sty':
                calc_strength(0., 'force', eps * size, 'disp', 'sty')
            elif case == 'et2':
                calc_strength(0.4 * eps * size, 'disp', 0.4 * eps * size,
                              'disp', 'et2')
            elif case == 'ect':
                calc_strength(-0.8 * eps * size, 'disp', 0.8 * eps * size,
                              'disp', 'ect')
            else:
                warnings.warn(f'calc_properties: Load case not supported: {case}')
                continue
            self.prop[case]['style'], self.prop[case]['name'] = styles[case]

    def plot_stress_strain(self, Hill=False, file=None, fontsize=14):
        """Plot the stress-strain curves computed by ``calc_properties``."""
        import matplotlib.pyplot as plt
        legend = []
        for sel in self.prop:
            if self.propJ2[sel]['ys'] is not None:
                plt.plot(self.propJ2[sel]['eeq'] * 100.,
                         self.propJ2[sel]['seq'], self.prop[sel]['style'])
                legend.append(self.prop[sel]['name'])
        plt.title('Material: ' + self.name, fontsize=fontsize)
        plt.xlabel(r'$\epsilon_\mathrm{eq}$ (%)', fontsize=fontsize)
        plt.ylabel(r'$\sigma^\mathrm{J2}_\mathrm{eq}$ (MPa)',
                   fontsize=fontsize)
        plt.legend(legend, loc='lower right', fontsize=fontsize)
        if file is not None:
            plt.savefig(file + 'J2.pdf', format='pdf', dpi=300)
        plt.show()
        if Hill:
            for sel in self.prop:
                if self.prop[sel]['ys'] is not None:
                    plt.plot(self.prop[sel]['eeq'] * 100.,
                             self.prop[sel]['seq'], self.prop[sel]['style'])
            if file is not None:
                plt.savefig(file + 'Hill.pdf', format='pdf', dpi=300)
            plt.show()

    def polar_plot_yl(self, Na=72, cmat=None, data=None, dname='reference',
                      scaling=None, field=False, predict=False, cbar=False,
                      Np=100, file=None, arrow=False, sJ2=False, show=True):
        """Polar plot of the yield locus in the deviatoric plane."""
        import matplotlib.pyplot as plt
        sf = 1. if scaling is None else 1. / scaling
        fig = plt.figure(figsize=(12, 9))
        ax = fig.add_axes([0, 0, 1, 1], projection='polar')
        if field and self.ML_yf:
            # decision-function field on a polar (theta, seq) grid; the SVC
            # features are (seq/sy - 1, theta/pi)
            tgrid, rgrid = np.meshgrid(
                np.linspace(-np.pi, np.pi, Np),
                np.linspace(0., 2. * self.scale_seq, Np))
            feat = np.column_stack([rgrid.ravel() / self.scale_seq - 1.,
                                    tgrid.ravel() / np.pi])
            if self.Ndof == 3:
                feat = np.column_stack([feat, -np.ones(len(feat))])
            elif self.Ndof > 3:
                raise ValueError('polar_plot_yl does not support texture '
                                 'dofs for field plots.')
            Z = svc_ops.decision_function_np(self._svc, feat)
            if predict:
                Z = np.where(Z > 0, 1., -1.)
            Z = self._symmetrize_about_zero(Z).reshape(tgrid.shape)
            im = ax.pcolormesh(tgrid, rgrid * sf, Z, cmap='PuOr_r',
                               shading='auto')
            if cbar:
                fig.colorbar(im, ax=ax)
        theta = np.linspace(0., 2 * np.pi, Na)
        snorm = sig_cyl2princ(np.array([self.sy * np.ones(Na) * np.sqrt(1.5),
                                        theta]).T)
        x1 = fsolve(self.find_yloc, np.ones(Na), args=snorm, xtol=1.e-5)
        sig = snorm * np.array([x1, x1, x1]).T
        s_yld = sig_eq_j2(sig) if sJ2 else self.calc_seq(sig)
        ax.plot(theta, s_yld * sf, '-r', linewidth=2, label=self.name)
        if cmat is not None:
            import matplotlib.pyplot as plt
            cmap = plt.get_cmap('copper')
            for i, mat in enumerate(cmat):
                x1 = fsolve(mat.find_yloc, np.ones(Na), args=snorm, xtol=1.e-5)
                sig = snorm * np.array([x1, x1, x1]).T
                s_yld = sig_eq_j2(sig) if sJ2 else self.calc_seq(sig)
                ax.plot(theta, s_yld * sf, color=cmap(i / len(cmat)),
                        linewidth=2, label=mat.name)
        if data is not None:
            ax.plot(data[:, 1], data[:, 0] * sf, '.b', label=dname)
        if file is not None:
            plt.legend(loc=(.9, 0.95), fontsize=18)
            plt.savefig(file + '.pdf', format='pdf', dpi=300)
        if show:  # pragma: no cover
            plt.legend(loc=(.78, 0.84), fontsize=18)
            plt.show()
        return ax
