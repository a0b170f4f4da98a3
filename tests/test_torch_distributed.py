"""PyTorch port: the multi-process runtime of the domain decomposition
(``parallel.distributed``, ``parallel.launch``), the twin of
``tests/test_multihost.py``: a 2-process Gloo run of a strip solve that
spans the process boundary gives the same checksum on both processes and
the one-process value."""
import pytest
import torch

from pylabfea_tpu_torch.parallel import distributed as pd
from pylabfea_tpu_torch.parallel import launch, runs

# One torch thread: the suite runs several test processes at once (the
# spawned ranks take one each too).
torch.set_num_threads(1)

ELASTIC = dict(kind='strip_elastic', NX=16, NY=8, eps=0.002, dtype='float64')


def test_two_process_strip_matches_one_process():
    """Two Gloo ranks solve the 16 x 8 elastic strip problem of
    ``tests/test_multihost.py`` (CG to 1e-12, float64): the same checksum
    bit for bit on both, within 1e-10 of one process, the same iteration
    count; the ranks in host order."""
    two = [r[0] for r in launch.spawn(runs.suite, 2, 'gloo', ['cpu'] * 2,
                                      ([ELASTIC],))]
    (one,) = runs.suite(pd.RankMesh(), torch.device('cpu'), [ELASTIC])
    assert two[0]['checksum'] == two[1]['checksum']
    assert two[0]['checksum'] == pytest.approx(one['checksum'], rel=1e-10)
    assert two[0]['it'] == two[1]['it'] == one['it']
    assert one['res'] < 1e-12 and two[0]['res'] < 1e-12
    assert [r['order'] for r in two] == [(0, 1)] * 2
    assert [r['pos'] for r in two] == [0, 1]


def test_rank_failure_raises():
    """A rank that raises fails the run with its traceback."""
    with pytest.raises(RuntimeError, match="(?s)rank \\d failed.*KeyError"):
        launch.spawn(runs.suite, 2, 'gloo', ['cpu'] * 2,
                     ([dict(kind='none')],), timeout=120.)


def test_single_process_runtime(monkeypatch):
    """One process: ``init_multihost`` is a no-op that returns False (from
    the arguments or ``WORLD_SIZE``), the strip mesh is the one-rank
    ``RankMesh`` and its collectives leave their tensors as they are;
    more processes without a card and without a backend ask for the
    card."""
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    assert pd.init_multihost() is False
    assert pd.init_multihost(num_processes=1) is False
    monkeypatch.setenv('WORLD_SIZE', '1')
    assert pd.init_multihost() is False
    mesh = pd.global_strip_mesh()
    assert (mesh.order, mesh.pos, mesh.size) == ((0,), 0, 1)
    t = torch.arange(6.).reshape(2, 3)
    assert torch.equal(mesh.all_reduce(t.clone()), t)
    assert torch.equal(mesh.broadcast(t.clone()), t)
    assert torch.equal(mesh.exchange(t), t[None])
    assert pd.default_backend('cpu') == 'gloo'
    assert pd.default_backend('cuda:1') == 'nccl'
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        pd.init_multihost('127.0.0.1:1', 2, 0)
