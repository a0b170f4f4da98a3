"""Data import & analysis for micromechanical test databases.

Reads JSON databases following the modular materials data schema (legacy
``Results`` S11.. arrays or the new ``stress``/``total_strain``/
``plastic_strain`` sub-dicts), detects the elastic-plastic transition,
reconstructs plastic strains when absent, fits the elastic stiffness tensor,
and assembles the ``mat_data`` dictionary that defines ML materials.

Contract follows the reference ``pylabfea.data``; stress/strain assembly
and the plastic-strain reconstruction are vectorized.  The port's numpy
copy of ``pylabfea_tpu.dataio`` (host profile); ``Data.fit_material`` runs
the port's ``ops.calibrate`` on the card unless given ``device``.
"""
import json
import os
import random
import warnings

import numpy as np
from scipy.signal import savgol_filter
from scipy.optimize import minimize

from pylabfea_tpu_torch.core.tensors import sig_eq_j2, eps_eq, sig_polar_ang, \
    sig_princ2cyl as sig_princ2cyl_single


def ln_strain(eng):
    """Engineering -> logarithmic strain (guarded against eng <= -1)."""
    h2 = np.maximum(1. + np.asarray(eng, dtype=float), 1.e-10)
    return np.log(h2)


def eng_strain(ln):
    """Logarithmic -> engineering strain."""
    return np.exp(np.asarray(ln, dtype=float)) - 1.


def interpolate_stress(s0, s1, e0, e1, et):
    """Linear interpolation of stress between two strain samples."""
    return s0 + (et - e0) * (s1 - s0) / (e1 - e0)


def find_transition_index(stress):
    """Index of the elastic->plastic transition along one load path: smooth
    with Savitzky-Golay filters, then find where the second derivative of the
    equivalent stress departs from its elastic-regime level."""
    stress = np.asarray(stress, dtype=float)
    nst = len(stress)
    wl1 = max(5, nst // 10)
    wl2 = max(2, nst // 50)
    d2 = savgol_filter(
        savgol_filter(stress, window_length=wl1, polyorder=1, deriv=1),
        window_length=wl2, polyorder=1, deriv=1)
    # block means of the second derivative over consecutive windows of
    # width wl2, starting at 10% of the path; the first window sets the
    # elastic-regime tolerance, the last window is never a candidate
    # (window count and 1.2x threshold are the goldens' contract)
    i0 = nst // 10
    nwin = (nst - i0) // wl2
    if nwin > 2:
        means = d2[i0:i0 + nwin * wl2].reshape(nwin, wl2).mean(axis=1)
        hits = np.flatnonzero(np.abs(means[1:nwin - 1]) > means[0] * 1.2)
        if hits.size:
            return i0 + (int(hits[0]) + 1) * wl2
    print('Warning: Transition not determined properly')
    return i0


def get_elastic_coefficients(eps, sig, method='least_square',
                             initial_guess=None):
    """Fit the symmetric 6x6 stiffness matrix to stress-strain pairs, either
    by direct least squares over the 21 independent coefficients or by
    Cholesky-parameterized optimization with a positive-definiteness penalty."""

    iu = np.triu_indices(6)

    def map_flat_to_matrix(C_flat):
        C = np.zeros((6, 6))
        C[iu] = C_flat
        C[(iu[1], iu[0])] = C_flat
        return C

    def map_flat_to_L_and_C(C_flat):
        L = np.zeros((6, 6))
        L[np.tril_indices(6)] = C_flat
        return L, L @ L.T

    def is_positive_definite(C):
        return np.all(np.linalg.eigvals(C) > 0)

    def objective_function(x_flat, data_pairs, penalty_weight=1e9,
                           lambda_reg=1e-3):
        _, C = map_flat_to_L_and_C(x_flat)
        penalty = 0.
        if not is_positive_definite(C):
            penalty = penalty_weight * np.sum(
                np.min(np.linalg.eigvals(C), 0) ** 2)
        ssr = 0.
        for strain, observed in data_pairs:
            ssr += np.sum((observed - C @ np.asarray(strain)) ** 2)
        return ssr + penalty + lambda_reg * np.sum(x_flat ** 2)

    def least_square(data_pairs, random_pairs_number=100):
        # row r of C contributes one equation per pair: sig_r = C[r,:] @ eps.
        # Design matrix columns are the 21 upper-triangle coefficients.
        if random_pairs_number > len(data_pairs):
            random_pairs_number = len(data_pairs)
        pairs = random.sample(data_pairs, random_pairs_number)
        colmap = np.zeros((6, 6), dtype=int)
        colmap[iu] = np.arange(21)
        colmap[(iu[1], iu[0])] = colmap[iu]
        npairs = len(pairs)
        A = np.zeros((npairs * 6, 21))
        b = np.zeros(npairs * 6)
        row = 0
        for strains, stresses in pairs:
            strains = np.asarray(strains, dtype=float)
            for r in range(6):
                A[row, colmap[r]] += strains  # += folds duplicate columns
                b[row] = stresses[r]
                row += 1
        C_flat, *_ = np.linalg.lstsq(A, b, rcond=None)
        return map_flat_to_matrix(C_flat)

    data_pairs = list(zip(eps, sig))
    max_attempts = 50
    attempts = 0
    success = False
    optimized_C = None
    while attempts < max_attempts and not success:
        if method == 'least_square':
            optimized_C = least_square(data_pairs,
                                       random_pairs_number=len(data_pairs))
            success = True
        elif method == 'decomposition':
            guess = initial_guess if initial_guess is not None \
                else np.random.rand(21)
            result = minimize(objective_function, guess, args=(data_pairs,),
                              method='L-BFGS-B')
            if result.success:
                success = True
                _, optimized_C = map_flat_to_L_and_C(result.x)
            else:
                attempts += 1
        else:
            raise ValueError("Invalid method selected. Choose 'least_square' "
                             "or 'decomposition'.")
    if not success:
        print(f'Optimization of material stiffness matrix failed after '
              f'{max_attempts} attempts')
    return np.array(optimized_C)


_COMP_ORDER = ('11', '22', '33', '23', '13', '12')


def _tensor_from_subdict(d):
    """Assemble (N,6) arrays from {'s11': [...], ...}-style sub-dicts."""
    tens = [1] * 6
    for ind, vals in d.items():
        for k, comp in enumerate(_COMP_ORDER):
            if comp in ind:
                tens[k] = vals
                break
    return np.array(tens).T


class Data(object):
    """Handle data from virtual/physical mechanical tests for training ML
    flow rules.  ``source`` is a JSON filename, a pre-read dict, or a legacy
    array of yield stresses; results are collected in ``mat_data``."""

    def __init__(self, source, path_data='./', name='Dataset',
                 mat_name="Simulanium", sdim=6, epl_crit=None, epl_start=None,
                 epl_max=None, depl=0., plot=False, wh_data=True,
                 tx_data=False, texture_name='Random', tx_descriptor='GSH_3',
                 mode='RS'):
        if sdim != 3 and sdim != 6:
            raise ValueError('Value of sdim must be either 3 or 6')
        self.lc_data = None
        self.mat_data = dict()
        self.mat_data['epc'] = epl_crit
        self.mat_data['ep_start'] = epl_start
        self.mat_data['ep_max'] = epl_max
        self.mat_data['delta_ep'] = depl
        self.mat_data['sdim'] = sdim
        self.mat_data['tdim'] = 0
        self.mat_data['Name'] = mat_name
        self.mat_data['Dataset'] = name
        self.mat_data['wh_data'] = wh_data
        self.mat_data['tx_data'] = tx_data
        self.mat_data['Ntext'] = 1
        self.mat_data['tx_name'] = texture_name
        self.mat_data['tx_index'] = 0
        self.mat_data['texture'] = np.zeros(1)
        self.mat_data['tx_descriptor'] = tx_descriptor
        self.mat_data['tx_key'] = None
        self.mode = mode

        if isinstance(source, str):
            self.lc_data = self.read_data(os.path.join(path_data, source))
            self.parse_data(epl_crit, epl_start, epl_max, depl)
        elif isinstance(source, dict):
            self.lc_data = source
            self.parse_data(epl_crit, epl_start, epl_max, depl)
        elif isinstance(source, (list, np.ndarray)):
            print('WARNING: This data type will be no longer supported.')
            self.convert_data(np.array(source))
        else:
            raise ValueError('Only sources of type "str" or "dict" are '
                             'supported.')
        if plot:  # pragma: no cover
            self.plot_training_data()

    def key_parser(self, key):
        """Decode a load-case key into its descriptor fields."""
        p = key.split('_')
        if self.mode == 'RS':
            return {"Stress_Type": p[0], "Load_Type": p[1], "Hash_Load": p[2],
                    "Hash_Orientation": p[3], "Texture_Type": p[4]}
        if self.mode == 'JS':
            return {"Stress_Type": p[0], "Load_Type": p[1], "Hash_Load": p[2],
                    "Hash_Orientation": p[5], "Texture_Type": p[7],
                    "N_Grains": p[3], "Elements_Grain": p[4]}
        raise KeyError(f"Mode is: {self.mode}. Must be RS or JS")

    def add_data(self, data_file, path_data='./'):
        """Merge another data file into this set and re-parse."""
        new_data = self.read_data(os.path.join(path_data, data_file))
        self.lc_data.update(new_data)
        self.parse_data(self.mat_data['epc'], self.mat_data['ep_start'],
                        self.mat_data['ep_max'], self.mat_data['delta_ep'])

    def fit_material(self, name=None, hardening='voce', nsteps=25,
                     shear_convention='tensor', device=None, **fit_kw):
        """Identify a ready-to-use analytic ``Material`` from this
        database: the best-fit Hill[+Voce] surrogate of the measured
        stress-strain paths (``ops.calibrate.fit_from_data`` — forward-mode
        derivatives through the device return map), with the database's fitted elastic
        stiffness.  The interpretable counterpart of ``train_SVC`` on the
        same data: Hill coefficients and hardening parameters instead of a
        non-parametric SVC locus.

        ``shear_convention`` defaults to 'tensor' — the CPFEM database
        convention (see fit_from_data).  A wrong convention silently
        poisons the fitted shear coefficients by 2x, so the stored
        stiffness is checked against the declared convention when the
        texture is near-isotropic: for engineering strains a random
        texture gives C44 ~ (C11-C12)/2, for tensor strains ~ (C11-C12).
        Returns (Material, fit info dict); the fitted parameters are also
        stored as ``info['params']``.  The fit runs on ``device`` (the card
        when None).
        """
        from pylabfea_tpu_torch.materials import Material
        from pylabfea_tpu_torch.ops import calibrate

        C = self.mat_data.get('elast_const')
        if C is not None:
            C = np.asarray(C)
            c11 = C[:3, :3].diagonal().mean()
            c12 = (C[:3, :3].sum() - C[:3, :3].diagonal().sum()) / 6.
            ratio = C[3:, 3:].diagonal().mean() / max((c11 - c12) / 2.,
                                                      1e-9)
            # only diagnostic for near-isotropic stiffnesses; a ratio near
            # 1 is the engineering signature, near 2 the tensor one
            if shear_convention == 'tensor' and ratio < 1.4:
                warnings.warn(
                    'fit_material: shear_convention="tensor" but the '
                    f'stored stiffness has C44/((C11-C12)/2) = {ratio:.2f} '
                    '~ 1, the ENGINEERING-convention signature — if the '
                    'database stores engineering shear strains, pass '
                    'shear_convention="engineering" or the fitted shear '
                    'coefficients will be off by 2x.')
            elif shear_convention == 'engineering' and ratio > 1.6:
                warnings.warn(
                    'fit_material: shear_convention="engineering" but the '
                    f'stored stiffness has C44/((C11-C12)/2) = {ratio:.2f} '
                    '~ 2, the TENSOR-convention signature (CPFEM '
                    'databases) — consider shear_convention="tensor".')

        params, info = calibrate.fit_from_data(
            self, nsteps=nsteps, shear_convention=shear_convention,
            hardening=hardening, device=device, **fit_kw)
        info['params'] = params
        mat = Material(name or f"{self.mat_data['Name']}-hill-fit")
        # info['CV'] is the ENGINEERING-convention stiffness the fit used
        # (the stored elast_const is invalid for engineering strains when
        # the database convention is 'tensor')
        mat.elasticity(CV=np.asarray(info['CV']))
        mat.plasticity(sy=params['sy'], hill=list(params['hill']),
                       khard=params['khard'],
                       voce_r=params.get('voce_r', 0.),
                       voce_b=params.get('voce_b', 1.), sdim=6)
        return mat, info

    def write_info(self, data):
        if "identifier" not in data.keys():
            return
        if "input_path" in data.keys():
            print(f'Input path for data set {data["identifier"]}: '
                  f'{data["input_path"]}')
        if "load_case" in data.keys():
            print(f'Load case: {data["load_case"]}')

    def _store_texture_descriptor(self, block):
        """Digest a top-level 'Texture' block into mat_data: name/index
        always; the quantitative descriptor (GSH coefficient slice or ADV
        address vector) only when tx_data is enabled."""
        self.mat_data['tx_name'] = block['name']
        if 'texture_index' in block:
            self.mat_data['tx_index'] = block['texture_index']
        else:
            print('read_data: texture block carries no texture_index; '
                  'keeping the default (0).')
        if not self.mat_data['tx_data']:
            warnings.warn('tx_data was set to false. Only qualitative '
                          'texture info is included.')
            return
        descr = self.mat_data['tx_descriptor']
        kind, _, tail = descr.rpartition('_')
        if descr.startswith('GSH') or 'GSH' in kind:
            ncoeff = int(tail)
            if ncoeff not in (3, 7, 12, 37):
                raise ValueError(f'GSH descriptor dimension {ncoeff} is not '
                                 'supported (choose 3, 7, 12 or 37)')
            coeff = np.asarray(block['gsh_coeff_reconstructed_random'])
            self.mat_data['texture'] = coeff[1:1 + ncoeff]
        elif descr.startswith('ADV') or 'ADV' in kind:
            self.mat_data['texture'] = np.asarray(
                block[f'address_vector_{int(tail)}'])
        elif descr == 'VF':
            raise NotImplementedError
        self.mat_data['tdim'] = len(self.mat_data['texture'])

    def _stress_unit_factor(self, rec):
        """MPa-normalisation factor from a record's 'units' entry."""
        if 'units' not in rec:
            print('Warning: No units for stresses are given. Assuming MPa.')
            return 1.
        unit = rec['units']['Stress']
        try:
            return {'MPa': 1., 'GPa': 1000.}[unit]
        except KeyError:
            raise ValueError(f'Cannot convert stress unit {unit}. '
                             'Data must be in MPa or GPa.') from None

    def _decode_load_case(self, key, rec):
        """Extract (sig, eps_tot, eps_pl | None) arrays from one load-case
        record in either JSON schema (legacy 'Results' S11.. arrays or the
        new stress/total_strain/plastic_strain sub-dicts), in MPa."""
        if 'Results' in rec:
            res = rec['Results']
            shear0 = '32' if self.mode == 'JS' else '23'
            def gather(prefix):
                comps = ('11', '22', '33', shear0, '13', '12')
                return np.array([res[prefix + c] for c in comps]).T
            sig = gather('S')
            eps_tot = gather('E')
            eps_pl = gather('Ep') if 'Ep11' in res else None
        else:
            sig = _tensor_from_subdict(rec['stress'])
            sig = sig * self._stress_unit_factor(rec)
            eps_tot = _tensor_from_subdict(rec['total_strain'])
            eps_pl = (_tensor_from_subdict(rec['plastic_strain'])
                      if 'plastic_strain' in rec else None)
        return sig, eps_tot, eps_pl

    @staticmethod
    def _case_metadata(rec):
        """Provenance fields (identifier/input_path/load_case) if present."""
        meta = {}
        if 'identifier' in rec:
            meta['identifier'] = rec['identifier']
            if 'input_path' in rec:
                meta['input_path'] = rec['input_path']
            if 'load_case' in rec:
                meta['load_case'] = rec['load_case']
            else:
                bc0 = rec.get('mechanical_BC', [{}])[0]
                if 'load_case' in bc0:
                    meta['load_case'] = bc0['load_case']
        return meta

    def _backfill_plastic_strain(self, records, fit_eps, fit_sig):
        """No record carried plastic strains: fit the elastic stiffness to
        the collected elastic-regime samples and subtract the (logarithmic)
        elastic strain from each total strain."""
        C = get_elastic_coefficients(fit_eps, fit_sig, method='least_square')
        compliance = np.linalg.inv(C)
        for rec in records.values():
            eps_el = ln_strain(rec['Stress'] @ compliance.T)
            eps_pl = eng_strain(ln_strain(rec['Strain_Total']) - eps_el)
            rec['Strain_Plastic'] = eps_pl
            rec['Eq_Strain_Plastic'] = eps_eq(eps_pl)
        print('Plastic strains are reconstructed from linear part of '
              'stress strain data.')

    def read_data(self, data_file):
        """Read a JSON database into per-load-case stress/strain arrays.

        Handles the legacy 'Results' format and the new schema, texture
        descriptor blocks (GSH/ADV), unit conversion, 'cyl' yield-onset-only
        records, and plastic-strain reconstruction from the fitted compliance
        when plastic strains are absent.  Contract follows the reference
        reader (data.py:500-704)."""
        print("Reading data from", data_file)
        with open(data_file) as fh:
            raw = json.load(fh)
        records = dict()
        fit_eps = []   # elastic-regime strain samples for the stiffness fit
        fit_sig = []
        have_plastic = False
        for pos, (key, rec) in enumerate(raw.items()):
            if key == 'Texture':
                self._store_texture_descriptor(rec)
                continue
            if 'cyl' in key and 'Results' in rec:
                # yield-onset-only record: a bare stress tensor
                records[key] = {"Stress": rec['Results']}
                continue
            sig, eps_tot, eps_pl = self._decode_load_case(key, rec)
            seq = sig_eq_j2(sig)
            if eps_pl is None:
                # no plastic strains: bank one elastic sample at 90% of the
                # detected transition for the stiffness fit; paths whose
                # transition sits in the first 10 samples are unusable
                knee = find_transition_index(seq)
                if knee < 10:
                    continue
                knee = int(knee * 0.9)
                fit_eps.append(eps_tot[knee, :])
                fit_sig.append(sig[knee, :])
                peeq = None
            else:
                peeq = eps_eq(eps_pl)
                have_plastic = True
            records[key] = {
                "Stress": sig,
                "Eq_Stress": seq,
                "Strain_Plastic": eps_pl,
                "Eq_Strain_Plastic": peeq,
                "Strain_Total": eps_tot,
                "Eq_Strain_Total": eps_eq(eps_tot),
                "Index": pos,
                **self._case_metadata(rec)}

        if not have_plastic:
            self._backfill_plastic_strain(records, fit_eps, fit_sig)
        return records

    @staticmethod
    def _strain_bounds(peeq, knee, epl_crit, epl_start, epl_max):
        """Resolve the per-load-case (critical, start, max) plastic-strain
        levels from the user settings, defaulting from the detected
        transition; validates epl_start <= critical level."""
        crit = (max(peeq[knee] * 1.1, 0.002) if epl_crit is None
                else epl_crit)
        start = peeq[knee] if epl_start is None else epl_start
        if epl_start is not None and epl_start > crit:
            raise ValueError(f'Value of epl_start={epl_start} is larger '
                             f'than epl_crit={crit}.')
        return crit, start, (max(peeq) if epl_max is None else epl_max)

    @staticmethod
    def _thin_by_spacing(values, gap):
        """Greedy positions whose value exceeds the previously accepted one
        by at least ``gap`` (first acceptance threshold: 0)."""
        keep = []
        floor = 0.0
        for pos, v in enumerate(values):
            if v >= floor:
                keep.append(pos)
                floor = v + gap
        return np.asarray(keep, dtype=int)

    def _drop_case(self, key, seqno, rec, why):
        print(f'parse_data: dropping load case {key} [#{seqno}] — {why}')
        self.write_info(rec)

    def parse_data(self, epl_crit, epl_start, epl_max, depl):
        """Per load case: locate the yield point, interpolate the ideal yield
        stress at epl_crit, collect flow stresses/plastic strains with
        minimum spacing ``depl``, fit elastic constants, and average the
        yield strength into ``mat_data``.  Contract follows the reference
        parser (data.py:706-888)."""
        n_cases = len(self.lc_data)
        n_cyl = 0
        n_dropped = 0
        peeq_top = 0.          # largest collected plastic strain level
        crit_sum = start_sum = max_sum = 0.0
        flow_sig = []          # flow-stress rows across all kept cases
        flow_epl = []          # matching onset-shifted plastic-strain rows
        onset_sig = []         # ideal yield stresses (one per kept case)
        case_ends = np.zeros(n_cases + 1, dtype=int)
        fit_eps = []           # elastic strain/stress samples for the C fit
        fit_sig = []
        knee_table = []
        seqno = 0              # position among non-dropped cases
        n_rows = 0             # running total of collected flow rows
        for key, rec in self.lc_data.items():
            if 'cyl' in key:
                # yield-onset-only record: the stress IS the ideal stress
                n_cyl += 1
                seqno += 1
                onset_sig.append(rec['Stress'])
                continue
            knee = find_transition_index(rec["Eq_Stress"])
            fit_eps.append(rec['Strain_Total'][knee]
                           - rec['Strain_Plastic'][knee])
            fit_sig.append(rec['Stress'][knee])
            peeq = rec['Eq_Strain_Plastic']
            crit, start, top = self._strain_bounds(
                peeq, knee, epl_crit, epl_start, epl_max)

            below_crit = np.flatnonzero(peeq <= crit)
            elastic_ids = np.flatnonzero(peeq <= start)
            plastic_ids = np.flatnonzero((peeq > start) & (peeq <= top))
            # admissibility rules (order matters — message selection only):
            why = None
            if below_crit.size < 2:
                why = 'fewer than 2 samples below epl_crit (no elastic ' \
                      'regime before yield onset)'
            elif below_crit.size >= len(peeq) - 2:
                why = 'fewer than 3 samples above epl_crit (plastic regime ' \
                      'too short)'
            elif elastic_ids.size < 2:
                why = 'fewer than 2 samples below epl_start (no elastic ' \
                      'regime)'
            elif plastic_ids.size < 2:
                why = 'fewer than 2 samples in (epl_start, epl_max] (no ' \
                      'plastic regime)'
            if why is not None:
                self._drop_case(key, seqno, rec, why)
                n_dropped += 1
                continue

            knee_table.append([knee, int(below_crit[-1]),
                               int(elastic_ids[-1]), int(plastic_ids[0])])
            crit_sum += crit
            start_sum += start
            max_sum += top

            # ideal yield stress: rescale the last sub-critical stress tensor
            # so its J2 magnitude matches seq interpolated to peeq == crit
            last = below_crit[-1]
            seq_at_crit = interpolate_stress(
                s0=rec['Eq_Stress'][last], s1=rec['Eq_Stress'][last + 1],
                e0=peeq[last], e1=peeq[last + 1], et=crit)
            onset_sig.append(rec['Stress'][last] * seq_at_crit
                             / sig_eq_j2(rec['Stress'][last]))
            peeq_top = max(peeq_top, peeq[plastic_ids[-1]])

            # flow data: thin to minimum spacing depl, then shift the
            # plastic strains so they vanish at yield onset
            picked = plastic_ids[self._thin_by_spacing(peeq[plastic_ids],
                                                       depl)]
            shrink = np.maximum(0., 1. - crit / peeq[picked])
            flow_sig.extend(rec['Stress'][picked])
            flow_epl.extend(rec['Strain_Plastic'][picked]
                            * shrink[:, None])
            n_rows += picked.size
            case_ends[seqno] = n_rows
            if self.mode == 'JS':
                fields = self.key_parser(key)
                self.mat_data['tx_key'] = fields["Hash_Orientation"]
            else:
                self.mat_data['ms_type'] = 'unknown'
                self.mat_data['tx_key'] = 'unknown'
            seqno += 1

        n_kept = n_cases - n_dropped - n_cyl
        if n_kept == 0:
            raise ValueError(
                'parse_data: no usable load cases — every non-cyl record was '
                'skipped as short or degenerate; check epl_crit/epl_start '
                'against the data resolution.')
        C = get_elastic_coefficients(fit_eps, fit_sig, method='least_square')
        sy_av = np.mean(sig_eq_j2(np.array(onset_sig)))
        md = self.mat_data
        md['flow_stress'] = np.array(flow_sig)
        md['plastic_strain'] = np.array(flow_epl)
        md['lc_indices'] = case_ends
        md['epc'] = crit_sum / n_kept
        md['ep_start'] = start_sum / n_kept
        md['ep_max'] = max_sum / n_kept
        md['peeq_max'] = peeq_top - crit_sum / n_kept
        md['elast_const'] = C
        md['sy_av'] = sy_av
        md['Nlc'] = n_cases - n_dropped
        md['Ncyl'] = n_cyl
        md['sig_ideal'] = np.array(onset_sig)
        md['elstress'] = fit_sig
        md['elstrain'] = fit_eps
        md['transition_ind'] = knee_table
        print(f'\n###   Data set: {md["Name"]}  ###')
        print(f'Estimated elastic constants (in GPa): C={C * 1.E-3}')
        print(f'Estimated yield strength: {sy_av:5.2f} MPa at '
              f'PEEQ = {start_sum / (n_cases - n_dropped):5.3f}')

    def convert_data(self, sig):
        """Build mat_data from yield-onset stress tensors only."""
        Nlc = len(sig)
        sdim = len(sig[0, :])
        if sdim != self.mat_data['sdim']:
            warnings.warn('Warning: dimension of stress in data does not '
                          'agree with parameter sdim. Use value from data.')
        self.mat_data['sig_ideal'] = sig
        self.mat_data['wh_data'] = False
        lc_ind_list = np.linspace(0, Nlc)
        self.mat_data['lc_indices'] = np.append(lc_ind_list, 0.)
        self.mat_data['elast_const'] = None
        self.mat_data['sy_av'] = np.mean(sig_eq_j2(sig))
        self.mat_data['peeq_max'] = 0.0
        self.mat_data['Nlc'] = Nlc
        print(f'\n###   Data set: {self.mat_data["Name"]}  ###')
        print(f'Converted data for {Nlc} stress tensors at yield onset.')
        print('WARNING: Elastic parameters cannot be derived from data.')

    def add2mat_data(self, data_dict, key):
        """Add one load case and re-parse."""
        self.lc_data[key] = data_dict
        self.parse_data(self.mat_data['epc'], self.mat_data['ep_start'],
                        self.mat_data['ep_max'], self.mat_data['delta_ep'])

    # ----------------------
    # plotting
    # ----------------------
    def plot_training_data(self, emax=1):  # pragma: no cover
        for xlabel in ("Total Strain", "Plastic Strain"):
            self.plot_data(self.lc_data, xlabel, "Stress", emax=emax)

    def plot_data(self, data, xlabel, ylabel, emax=None):  # pragma: no cover
        import matplotlib.pyplot as plt
        for key, val in data.items():
            if 'cyl' in key:
                continue
            plt.scatter(val["Strain_Total"], val["Stress"], s=1)
            if emax is not None:
                plt.xlim(0, emax)
            plt.xlabel(xlabel, fontsize=14)
            plt.ylabel(ylabel, fontsize=14)
        plt.show()

    def plot_stress_strain(self, plot_peeq=True, eps_max=0.1, epc=None,
                           fontsize=14, cmap='viridis'):  # pragma: no cover
        import matplotlib.pyplot as plt
        cols = plt.get_cmap(cmap)
        smax = 0.0
        fig = plt.figure()
        for val in self.lc_data.values():
            eeq = eps_eq(val['Strain_Plastic'] if plot_peeq
                         else val['Strain_Total'])
            seq = sig_eq_j2(val['Stress'])
            ind = np.nonzero(eeq <= eps_max)[0]
            idx = np.argmax(seq[ind])
            smax = max(smax, seq[idx])
            col = (sig_polar_ang(val['Stress'][idx]) + np.pi) / (2 * np.pi)
            plt.plot(eeq[ind], seq[ind], color=cols(col))
        if epc is not None:
            plt.plot([epc, epc], [0, smax], '--r')
        plt.xlabel(r'$\epsilon_{eq}$ (.)', fontsize=fontsize)
        plt.ylabel(r'$\sigma_{eq}$ (MPa)', fontsize=fontsize)
        plt.show()
        plt.close(fig=fig)

    def plot_yield_stress(self, show_hist=True, test_data=None, fontsize=14,
                          cmap='viridis'):  # pragma: no cover
        import matplotlib.pyplot as plt
        cols = plt.get_cmap(cmap)
        fig = plt.figure()
        ang = sig_polar_ang(self.mat_data['sig_ideal'])
        seq = sig_eq_j2(self.mat_data['sig_ideal'])
        ind = np.argsort(ang)
        plt.scatter(ang[ind], seq[ind], c=cols((ang[ind] + np.pi) / (2 * np.pi)))
        plt.plot([-np.pi, np.pi], [self.mat_data['sy_av']] * 2, '--k')
        plt.show()
        plt.close(fig)
        if show_hist:
            fig = plt.figure()
            plt.hist(seq, density=True, label="training data")
            if test_data is not None:
                plt.hist(test_data, density=True, label="test data")
            plt.legend(loc='upper left')
            plt.show()
            plt.close(fig)

    def plot_yield_locus(self, mat_data=None, active='flow_stress',
                         scatter=False, data=None, data_label=None,
                         arrow=False, file=None, title=None,
                         fontsize=18):  # pragma: no cover
        """Polar plot of initial yield points contained in the data set."""
        import matplotlib.pyplot as plt
        if mat_data is None:
            mat_data = self.mat_data
        fig, ax = plt.subplots(subplot_kw={'projection': 'polar'},
                               figsize=(15, 8))
        sc, scy = [], []
        stresses = mat_data[active]
        for i in range(len(stresses)):
            cylv = sig_princ2cyl_single(stresses[i])
            sc.append(cylv)
            if active == 'flow_stress':
                ppe = eps_eq(mat_data['plastic_strain'][i])
                if ppe < 0.003:
                    scy.append(cylv)
            else:
                scy.append(cylv)
        scy = np.array(scy if scy else sc)
        ax.scatter(scy[:, 1], scy[:, 0], marker=".", label='yield points')
        if data is not None:
            ax.plot(data[:, 1], data[:, 0], '.r', label=data_label)
        if title:
            ax.set_title(title, fontsize=fontsize)
        ax.legend()
        if file is not None:
            fig.savefig(file + '.pdf', format='pdf', dpi=300)
        plt.show()
        return ax

    def plot_set(self):  # pragma: no cover
        import matplotlib.pyplot as plt
        cmap = plt.get_cmap('viridis', self.mat_data['Nlc'])
        plt.figure(figsize=(18, 7))
        plt.subplot(1, 2, 1)
        for val in self.lc_data.values():
            peeq = eps_eq(val['Strain_Plastic'])
            seq = sig_eq_j2(val['Stress'])
            idx = np.nonzero(peeq <= self.mat_data['ep_max'])[0][-1]
            col = 0.5 * (sig_polar_ang(val['Stress'][idx]) / np.pi + 1)
            plt.plot(peeq[0:idx] * 100, seq[0:idx], color=cmap(col))
        plt.subplot(1, 2, 2)
        ang = sig_polar_ang(self.mat_data['flow_stress'])
        seq = sig_eq_j2(self.mat_data['flow_stress'])
        ind = np.argsort(ang)
        plt.plot(ang[ind], seq[ind], '-k')
        plt.plot([-np.pi, np.pi], [self.mat_data['sy_av']] * 2, '--k')
        plt.show()
