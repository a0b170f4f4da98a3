"""Checkpoint and resume of the solver state (the counterpart of
``pylabfea_tpu.utils.checkpoint``).

A ``SolverState`` or ``SolverState3`` is written as one ``.npz`` of its
arrays with a JSON ``__manifest__`` (``format`` 1, the field names and a
meta dict), the JAX package's format: a file written by either package
loads in the other bit for bit.  Host ``Model`` checkpoints
(``save_model`` / ``load_model``) belong to the JAX package's host profile.
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
