"""Checkpoint and resume of the solver state and of a host ``Model`` (the
counterpart of ``pylabfea_tpu.utils.checkpoint``).

A ``SolverState`` or ``SolverState3`` is written as one ``.npz`` of its
arrays with a JSON ``__manifest__`` (``format`` 1, the field names and a
meta dict), the JAX package's format: a file written by either package
loads in the other bit for bit.  ``save_model`` / ``load_model`` do the
same for a host ``Model``'s displacements, forces, element states and BC
memory, in the JAX package's format too.
"""
import dataclasses
import json

import numpy as np
import torch

from pylabfea_tpu_torch.config import resolve_device
from pylabfea_tpu_torch.ops.fe3d import SolverState3
from pylabfea_tpu_torch.ops.fe_kernels import SolverState

_FORMAT_VERSION = 1


def save_state(path, state, meta=None):
    """Write a 2-D or 3-D solver state (and an optional JSON-serializable
    ``meta`` dict) to ``path``."""
    fields = [f.name for f in dataclasses.fields(state)]
    arrays = {f: getattr(state, f).detach().cpu().numpy() for f in fields}
    manifest = {'format': _FORMAT_VERSION, 'fields': fields,
                'meta': meta or {}}
    np.savez_compressed(path, __manifest__=json.dumps(manifest), **arrays)


def load_state(path, dtype=None, device=None):
    """Read a state written by ``save_state`` (of either package): a
    ``SolverState3`` where ``u`` is a (3, nnX, nnY, nnZ) volume, else a
    ``SolverState``, its tensors in the file's dtype (or ``dtype``) on
    ``device`` (the card when None).  Returns (state, meta); raises on a
    newer format."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z['__manifest__']))
        if manifest['format'] > _FORMAT_VERSION:
            raise ValueError(f'checkpoint format {manifest["format"]} is '
                             'newer than this build supports')
        arrays = {f: torch.as_tensor(z[f], dtype=dtype, device=device)
                  for f in manifest['fields']}
    cls = SolverState3 if arrays['u'].dim() == 4 else SolverState
    return cls(**arrays), manifest['meta']


def save_model(path, model, meta=None):
    """Checkpoint a host ``Model``: displacements, forces, element state and
    BC memory, so ``solve()`` can resume loading after a restart."""
    arrays = {
        'u': model.u, 'f': model.f,
        'sgl': model.sgl, 'egl': model.egl, 'epgl': model.epgl,
        'bct_mem': model.bct_mem, 'bcr_mem': model.bcr_mem,
        'el_sig': np.array([el.sig for el in model.element]),
        'el_eps': np.array([el.eps for el in model.element]),
        'el_epl': np.array([el.epl for el in model.element]),
        'el_elstiff': np.array([el.elstiff for el in model.element]),
    }
    if getattr(model, 'noset', None) is not None:
        arrays['bcn_mem'] = model.bcn_mem
    manifest = {'format': _FORMAT_VERSION, 'meta': meta or {},
                'nel': len(model.element)}
    np.savez_compressed(path, __manifest__=json.dumps(manifest), **arrays)


def load_model(path, model):
    """Restore a checkpoint of ``save_model`` (of either package) into a
    meshed ``Model`` of the same mesh and materials; returns its meta."""
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z['__manifest__']))
        if manifest['nel'] != len(model.element):
            raise ValueError('checkpoint mesh does not match model mesh')
        model.u = z['u']
        model.f = z['f']
        model.sgl = z['sgl']
        model.egl = z['egl']
        model.epgl = z['epgl']
        model.bct_mem = z['bct_mem']
        model.bcr_mem = z['bcr_mem']
        if 'bcn_mem' in z:
            model.bcn_mem = z['bcn_mem']
        for i, el in enumerate(model.element):
            el.sig = z['el_sig'][i]
            el.eps = z['el_eps'][i]
            el.epl = z['el_epl'][i]
            el.elstiff = z['el_elstiff'][i]
            el.calc_Kel()
    return manifest['meta']
