"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program.  Names are compared by
their whole top-level part: ``pylabfea_tpu_torch`` begins with
``pylabfea_tpu`` and is a different package."""
import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'pylabfea_tpu'}


def imported(path):
    """Top-level names of every module ``path`` imports (static and
    ``importlib.import_module`` with a literal name)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
        elif (isinstance(node, ast.Call) and getattr(
                node.func, 'attr', '') == 'import_module' and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split('.')[0])
    return names


def sources():
    return sorted(p for p in BENCH.rglob('*.py') if '__pycache__' not in
                  p.parts)


def test_whole_top_level_names():
    assert 'pylabfea_tpu_torch'.split('.')[0] not in FORBIDDEN
    assert 'pylabfea_tpu.ops'.split('.')[0] in FORBIDDEN


def test_no_module_imports_jax_or_the_jax_package():
    for path in sources():
        if path.parent.name == 'tests' and path.name == Path(
                __file__).name:
            continue
        assert not imported(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / 'reference').glob('*.py'):
        assert 'pylabfea_tpu_torch' not in imported(path), path
        assert 'harness' not in imported(path), path


def targets():
    """Every program function the configurations and the metric readers
    name."""
    import json
    import sys
    sys.path[:0] = [str(BENCH), str(BENCH.parent)]
    from harness.manifest import Manifest
    out = []
    for cfg in (BENCH / 'configs').glob('*.json'):
        c = json.loads(cfg.read_text())
        for ts in c.get('spans', {}).values():
            out.extend(ts)
        if 'last_round' in c:
            out.append(c['last_round'])
    man = Manifest(BENCH.parent)
    from harness.manifest import load_reader
    for m in man.data['per_layer']:
        out.extend(k.target for k in getattr(load_reader(m['name']),
                                             'KERNELS', ()))
    return out


def test_the_spans_and_kernels_name_only_the_port():
    for t in targets():
        assert t.split('.')[0] == 'pylabfea_tpu_torch', t


def test_every_function_named_resolves_and_a_missing_one_raises():
    import pytest
    from harness import instrument
    for t in targets():
        assert callable(instrument.resolve(t)[2]), t
    with pytest.raises(AttributeError):
        instrument.resolve('pylabfea_tpu_torch.ops.fe_kernels:no_such')
    with pytest.raises(AttributeError):
        instrument.Patches().patch('pylabfea_tpu_torch.ops.fe3d:no_such',
                                   lambda orig: orig)
