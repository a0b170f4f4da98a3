"""Training-data generation and scoring for ML yield functions.

Low-discrepancy unit stresses on 3-D/6-D hyperspheres (load cases for which
yield onsets are determined), classification scores, and test-set generation
from data files.  Contract follows the reference ``pylabfea.training``; the hypersphere
construction is vectorized — one batched Brent solve per dimension instead
of a Python root find per point.  The port's numpy copy of
``pylabfea_tpu.training`` (host profile).
"""
import numpy as np
from scipy.special import gamma as _gamma_fn

from pylabfea_tpu_torch.core.tensors import sig_eq_j2
from pylabfea_tpu_torch.ops.rootfind import brent_vec


def int_sin_m(x, m):
    """Integral of sin^m(t) dt from 0 to x (recursive; vectorized in x)."""
    if m == 0:
        return x
    if m == 1:
        return 1. - np.cos(x)
    return (m - 1) / m * int_sin_m(x, m - 2) \
        - np.cos(x) * np.sin(x) ** (m - 1) / m


def primes():
    """Infinite generator of prime numbers.

    Sieve of Eratosthenes over a doubling numpy range; only the primes not
    yet emitted are yielded after each extension.  The hypersphere sequences
    consume one prime per feature dimension, so the range stays tiny."""
    limit, emitted = 32, 0
    while True:
        sieve = np.ones(limit, dtype=bool)
        sieve[:2] = False
        for p in range(2, int(limit ** 0.5) + 1):
            if sieve[p]:
                sieve[p * p::p] = False
        found = np.flatnonzero(sieve)
        for p in found[emitted:]:
            yield int(p)
        emitted = len(found)
        limit *= 2


def uniform_hypersphere(d, n, method='brentq'):
    """n unit stresses distributed with low discrepancy on the d-dimensional
    hypersphere (per-dimension prime-offset sequences; inversion of the
    sphere-area CDF by Brent root finding, batched over all points)."""
    points = np.ones((n, d))
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    points[:, 0] = np.sin(t)
    points[:, 1] = np.cos(t)
    for dim, prime in zip(range(2, d), primes()):
        offset = np.sqrt(prime)
        mult = _gamma_fn(0.5 * (dim + 1)) / (_gamma_fn(0.5 * dim) * np.sqrt(np.pi))
        targets = (np.arange(n) * offset) % 1

        def dim_func(y):
            return mult * int_sin_m(y, dim - 1) - targets

        if method == 'brentq':
            deg, ok = brent_vec(dim_func, np.zeros(n), np.full(n, np.pi),
                                xtol=1.e-8)
            if not ok.all():
                print(f'Root finding not converged for {np.sum(~ok)} points')
        else:  # pragma: no cover - non-default methods
            from scipy.optimize import root_scalar
            deg = np.empty(n)
            for i in range(n):
                res = root_scalar(lambda y: mult * int_sin_m(y, dim - 1)
                                  - targets[i], method=method,
                                  bracket=[0, np.pi], xtol=1.e-8)
                deg[i] = res.root
        points[:, 0:dim] *= np.sin(deg)[:, None]
        points[:, dim] *= np.cos(deg)
    return points


def load_cases(number_3d, number_6d, method='brentq'):
    """Unit stresses in principal (3d) and full (6d) stress space, normalized
    to unit J2 equivalent stress."""
    sig_3d = np.zeros((number_3d, 6))
    if number_3d > 0:
        sig_3d[:, 0:3] = uniform_hypersphere(3, number_3d, method=method)
    sig_6d = uniform_hypersphere(6, number_6d)
    allsig = np.concatenate((sig_3d, sig_6d))
    seq = sig_eq_j2(allsig)
    ind = np.nonzero(seq < 1.e-3)[0]
    if len(ind) > 0:
        print('WARNING: Small stresses detected:', ind)
    return allsig / seq[:, None]


def training_score(yf_ref, yf_ml, plot=False):
    """Classification metrics of ML yield-function signs against reference:
    returns (MAE, precision, accuracy, recall, F1, MCC)."""
    from sklearn.metrics import mean_absolute_error, matthews_corrcoef

    res_ref = np.sign(yf_ref)
    res_ref[np.abs(res_ref) < 0.9] = 1.
    res_ml = np.sign(yf_ml)
    res_ml[np.abs(res_ml) < 0.9] = 1.

    if plot:  # pragma: no cover
        import matplotlib.pyplot as plt
        from sklearn.metrics import confusion_matrix, ConfusionMatrixDisplay
        cm = confusion_matrix(res_ref, res_ml)
        ConfusionMatrixDisplay(cm, display_labels=['Elastic', 'Plastic']) \
            .plot(cmap='viridis', colorbar=False)
        plt.show()

    TP = int(np.sum((res_ref == 1) & (res_ml == 1)))
    FN = int(np.sum((res_ref == 1) & (res_ml == -1)))
    FP = int(np.sum((res_ref == -1) & (res_ml == 1)))
    TN = int(np.sum((res_ref == -1) & (res_ml == -1)))
    mae = mean_absolute_error(yf_ref, yf_ml)
    MCC = matthews_corrcoef(np.sign(yf_ref), np.sign(yf_ml))
    precision = TP / (TP + FP) if TP + FP > 0 else 0.0
    accuracy = (TP + TN) / (TP + FP + FN + TN) if TP + FP + FN + TN > 0 else 0.0
    recall = TP / (TP + FN) if TP + FN > 0 else 0.0
    f1 = 2 * recall * precision / (recall + precision) \
        if recall + precision > 1.0e-4 else 0.0
    print("Mean Absolute Error is", mae)
    print('True Positives:', TP, 'True Negatives:', TN)
    print('False Positives:', FP, 'False Negatives:', FN)
    print('Precision:', precision, 'Accuracy:', accuracy, 'Recall:', recall)
    print('F1score:', f1, 'MCC score:', MCC)
    return mae, precision, accuracy, recall, f1, MCC


def create_test_sig(file, number_sig_per_strain=4):
    """Labeled test stresses from a micromechanical dataset: flow stresses
    scaled up (x1.5/1.2/1.1/1.01, label +1) and down (x0.99/0.9/0.8/0.5,
    label -1), with matching plastic strains."""
    from pylabfea_tpu_torch.dataio import Data

    db2 = Data(file, epl_crit=2.e-3, epl_start=1.e-3, epl_max=0.03, depl=0.0)
    pl_sig, el_sig, epl_ts = [], [], []
    for j in range(len(db2.mat_data['plastic_strain'])):
        for f in (1.5, 1.2, 1.1, 1.01):
            pl_sig.append(db2.mat_data['flow_stress'][j] * f)
        for f in (0.99, 0.9, 0.8, 0.5):
            el_sig.append(db2.mat_data['flow_stress'][j] * f)
        for _ in range(int(number_sig_per_strain)):
            epl_ts.append(db2.mat_data['plastic_strain'][j].tolist())
    ts_sig = np.array(pl_sig + el_sig)
    epl_tot = np.array(epl_ts + epl_ts)
    half = len(ts_sig) // 2
    yf_ref = np.concatenate((np.ones(half), -np.ones(len(ts_sig) - half)))
    return ts_sig, epl_tot, yf_ref
