"""Tensor math kernel (host profile; the port's numpy copy of
``pylabfea_tpu.core.tensors``, the same arithmetic in the same order).

Voigt/principal/cylindrical stress conversions, equivalent stresses and
strains, and the ``Stress``/``Strain`` convenience classes.  This is the
numeric vocabulary of the host profile; behavioral contract follows the
reference ``pylabfea.basic`` (basic.py:20-604) but the implementation is
fully batched — there are no per-tensor Python loops.  The torch twin of
the batched primitives for the device path lives in
``pylabfea_tpu_torch.ops.jtensors``.

Accepted shapes mirror the reference API: single tensors ``(3,)``/``(6,)``
return scalars/single tensors; batches ``(N,3)``/``(N,6)`` return arrays.
"""
import pickle

import numpy as np

#: Plastic yielding is assumed when the yield function exceeds this tolerance
#: (one value for the host profile and the device path: ``config``).
from pylabfea_tpu_torch.config import yf_tolerance  # noqa: F401

# First/second unit vectors spanning the deviatoric stress plane
# (real/imaginary axis of the polar representation).
a_vec = np.array([1., -0.5, -0.5]) / np.sqrt(1.5)
b_vec = np.array([0., 0.5, -0.5]) * np.sqrt(2)


_VOIGT_IDX = ((0, 0), (1, 1), (2, 2), (1, 2), (0, 2), (0, 1))


def voigt_to_tensor(sv):
    """Convert Voigt vectors (...,6) to symmetric tensors (...,3,3)."""
    sv = np.asarray(sv)
    out = np.zeros(sv.shape[:-1] + (3, 3), dtype=sv.dtype)
    for k, (i, j) in enumerate(_VOIGT_IDX):
        out[..., i, j] = sv[..., k]
        out[..., j, i] = sv[..., k]
    return out


def tensor_to_voigt(st):
    """Convert symmetric tensors (...,3,3) to Voigt vectors (...,6)."""
    st = np.asarray(st)
    out = np.empty(st.shape[:-2] + (6,), dtype=st.dtype)
    for k, (i, j) in enumerate(_VOIGT_IDX):
        out[..., k] = st[..., i, j]
    return out


def _as_batch(sig, kinds):
    """Normalize input to a batch; return (batch, was_single).

    ``kinds`` is a set of admissible trailing sizes, e.g. {3, 6}.
    """
    sig = np.asarray(sig, dtype=float)
    if sig.ndim == 1 and sig.shape[0] in kinds:
        return sig[None, :], True
    if sig.ndim == 2 and sig.shape[1] in kinds:
        return sig, False
    raise TypeError(f'Unknown stress/strain format: shape={sig.shape}')


def sig_princ(sig):
    """Principal stresses and eigenvector matrices of stress tensors.

    Parameters
    ----------
    sig : (6,), (N,6), (3,3) or (N,3,3) array
        Voigt or Cartesian stress tensor(s).

    Returns
    -------
    spa : (3,) or (N,3) array — principal stresses
    eva : (3,3) or (N,3,3) array — eigenvector/rotation matrices

    Notes
    -----
    The component ordering follows the reference convention
    (basic.py:153-173): eigen-pairs are re-ordered by the axis along which
    the eigenvector matrix row has its largest magnitude (stable w.r.t.
    input order), and the matrix sign is flipped to enforce det > 0.
    ``np.linalg.eig`` (not ``eigh``) is used so that degenerate/shear states
    resolve ties identically to the reference.
    """
    sig = np.asarray(sig, dtype=float)
    if sig.ndim >= 2 and sig.shape[-2:] == (3, 3):
        st = sig[None] if sig.ndim == 2 else sig
        single = sig.ndim == 2
    else:
        sv, single = _as_batch(sig, {6})
        st = voigt_to_tensor(sv)
    w, v = np.linalg.eig(st)
    w = np.real(w)
    v = np.real(v)
    # row r of v has its max-|.| entry in column iev[r]; stable sort of rows
    # by that column index reproduces the reference's greedy reordering.
    iev = np.argmax(np.abs(v), axis=-1)
    j = np.argsort(iev, axis=-1, kind='stable')
    eva = np.take_along_axis(v, j[..., :, None], axis=-2)
    spa = np.take_along_axis(w, j, axis=-1)
    det = np.linalg.det(eva)
    eva = np.where((det < 0)[..., None, None], -eva, eva)
    if single:
        return spa[0], eva[0]
    return spa, eva


def sig_eq_j2(sig):
    """J2 (von Mises) equivalent stress of principal or Voigt stresses.

    Voigt inputs are diagonalized first (reference basic.py:30-65 contract).
    """
    if isinstance(sig, list):
        sig = np.array(sig)
    sig = np.asarray(sig, dtype=float)
    sp, single = _as_batch(sig, {3, 6})
    if sp.shape[1] == 6:
        sp = sig_princ(sp)[0]
    d12 = sp[:, 0] - sp[:, 1]
    d23 = sp[:, 1] - sp[:, 2]
    d31 = sp[:, 2] - sp[:, 0]
    seq = np.sqrt(0.5 * (d12 ** 2 + d23 ** 2 + d31 ** 2))
    return seq[0] if single else seq


def sig_polar_ang(sig):
    """Polar angle of stress in the deviatoric plane, range [-pi, pi]."""
    sig = np.asarray(sig, dtype=float)
    sp, single = _as_batch(sig, {3, 6})
    if sp.shape[1] == 6:
        sp = sig_princ(sp)[0]
    hyd = np.sum(sp, axis=1) / 3.
    dev = sp - hyd[:, None]
    vn = np.linalg.norm(dev, axis=1)
    vn = np.where(vn < 1.e-4, 1., vn)
    dsa = (dev / vn[:, None]) @ a_vec
    dsb = (dev / vn[:, None]) @ b_vec
    theta = np.angle(dsa + 1j * dsb)
    return theta[0] if single else theta


def sig_cyl2princ(s_cyl):
    """Convert cylindrical stress (seq, theta[, p]) to principal stress.

    Reference-contract quirk (basic.py:203-205): the hydrostatic column p is
    only applied when the *leading* dimension of the input equals 3 — i.e.
    for a single (3,) stress, or a batch of exactly 3 rows; (N,3) batches
    with N != 3 ignore p.
    """
    s_cyl = np.asarray(s_cyl, dtype=float)
    sh = s_cyl.shape
    sc, single = _as_batch(s_cyl, {2, 3})
    seq = sc[:, 0]
    theta = sc[:, 1]
    sp = (np.cos(theta)[:, None] * a_vec[None, :] +
          np.sin(theta)[:, None] * b_vec[None, :]) * \
         np.sqrt(2. / 3.) * seq[:, None]
    if sh[0] == 3 and sc.shape[1] == 3:
        sp = sp + sc[:, 2][:, None] / 3.
    return sp[0] if single else sp


def sig_cyl2voigt(sig_cyl, eigen_vector):
    """Rotate cylindrical stress back into the Voigt frame of ``eigen_vector``."""
    sp = sig_cyl2princ(sig_cyl)
    ev = np.array(eigen_vector, dtype=float)
    if np.linalg.det(ev) < 0:
        ev = -ev  # enforce right-handed eigenvector system
    hh = ev @ np.diag(sp) @ ev.T
    return tensor_to_voigt(hh)


def sig_princ2cyl(sig, mat=None):
    """Convert principal or Voigt stress to cylindrical (seq, theta, p).

    If ``mat`` is given, its material-specific equivalent stress is used for
    the radial component, otherwise J2.
    """
    sig = np.asarray(sig, dtype=float)
    sv, single = _as_batch(sig, {3, 6})
    if sv.shape[1] == 3:
        sp = sv
        sv6 = np.concatenate([sv, np.zeros_like(sv)], axis=1)
    else:
        sp = sig_princ(sv)[0]
        sv6 = sv
    sc = np.zeros((len(sp), 3))
    sc[:, 0] = sig_eq_j2(sp) if mat is None else mat.calc_seq(sv6)
    sc[:, 1] = sig_polar_ang(sp)
    sc[:, 2] = np.sum(sp, axis=1) / 3.
    return sc[0] if single else sc


def sig_spherical_to_cartesian(angles, seq=1.0):
    """Map 5 spherical angles onto a unit Voigt stress, scaled by ``seq``."""
    angles = np.asarray(angles, dtype=float)
    assert angles.shape[-1] == 5
    s = np.sin(angles)
    c = np.cos(angles)
    cum = np.cumprod(s, axis=-1)
    out = np.empty(angles.shape[:-1] + (6,))
    out[..., 0] = c[..., 0]
    for k in range(1, 5):
        out[..., k] = cum[..., k - 1] * c[..., k]
    out[..., 5] = cum[..., 4]
    return seq * out


def sig_dev(sig):
    """Deviatoric part of stress tensor(s): subtract hydrostatic pressure."""
    sig = np.asarray(sig, dtype=float)
    hyd = np.zeros_like(sig)
    if sig.ndim == 1:
        hyd[0:3] = np.sum(sig[0:3]) / 3.
    else:
        hyd[:, 0:3] = (np.sum(sig[:, 0:3], axis=1) / 3.)[:, None]
    return sig - hyd


def eps_eq(eps):
    """Equivalent strain of principal (3) or Voigt (6) strain tensor(s)."""
    eps = np.asarray(eps, dtype=float)
    ep, single = _as_batch(eps, {3, 6})
    if ep.shape[1] == 6:
        eeq = np.sqrt(2. * (np.sum(ep[:, 0:3] ** 2, axis=1) +
                            0.5 * np.sum(ep[:, 3:6] ** 2, axis=1)) / 3.)
    else:
        eeq = np.sqrt(2. * np.sum(ep[:, 0:3] ** 2, axis=1) / 3.)
    return eeq[0] if single else eeq


class Stress(object):
    """Voigt stress tensor with derived representations.

    Attributes: ``voigt``/``v``, ``tens``/``t``, ``princ``/``p``, ``evec``,
    ``hydrostatic``/``h``, ``dev``/``d``.
    """

    def __init__(self, sv):
        self.v = self.voigt = np.array(sv)
        self.t = self.tens = voigt_to_tensor(self.v)
        self.princ, self.evec = sig_princ(self.tens)
        self.p = self.princ
        self.h = self.hydrostatic = np.sum(self.p) / 3.
        self.d = self.dev = self.v - np.array([self.h, self.h, self.h, 0., 0., 0.])

    def seq(self, mat=None):
        """Material-specific equivalent stress (J2 if ``mat`` is None)."""
        if mat is None:
            return sig_eq_j2(self.p)
        return mat.calc_seq(self.v)

    def theta(self):
        """Polar angle in the deviatoric plane."""
        return sig_polar_ang(self.p)

    def seq_j2(self):
        """J2 equivalent stress."""
        return sig_eq_j2(self.p)

    def cyl(self):
        """Cylindrical representation (seq_J2, theta, p)."""
        return np.array([sig_eq_j2(self.p), sig_polar_ang(self.p), self.h])

    def lode_ang(self, arg):
        """Lode angle; ``arg`` is either an equivalent stress or a Material."""
        seq = arg if type(arg) is float else self.seq(arg)
        j3 = np.linalg.det(self.tens - self.h * np.eye(3))
        return np.arccos(0.5 * j3 * (3. / seq) ** 3) / 3.


class Strain(object):
    """Voigt strain tensor with principal values and equivalent strain."""

    def __init__(self, sv):
        self.v = self.voigt = np.array(sv)
        self.t = self.tens = voigt_to_tensor(self.v)
        self.princ, self.evec = np.linalg.eig(self.tens)
        self.p = self.princ

    def eeq(self):
        """Equivalent strain."""
        return eps_eq(self.v)

    def inv(self):
        """Component-wise inverse, ignoring (near-)zero entries."""
        out = np.zeros(6)
        nz = np.abs(self.voigt) > 1.e-9
        out[nz] = 1. / self.voigt[nz]
        return out


def pickle2mat(name, path='./'):
    """Load a pickled Material object from ``path``/``name``."""
    if name is None:
        raise ValueError('Name for pickled material must be given.')
    if path[-1] != '/':
        path += '/'
    with open(path + name, 'rb') as inp:
        return pickle.load(inp)


# legacy aliases (reference basic.py:579-604)
def seq_J2(sig):
    return sig_eq_j2(sig)


def sprinc(sig):
    return sig_princ(sig)


def sp_cart(scyl):
    return sig_cyl2princ(scyl)


def svoigt(scyl, evec):
    return sig_cyl2voigt(scyl, evec)


def s_cyl(sig, mat=None):
    return sig_princ2cyl(sig, mat)


def sdev(sig):
    return sig_dev(sig)


def polar_ang(sig):
    return sig_polar_ang(sig)
