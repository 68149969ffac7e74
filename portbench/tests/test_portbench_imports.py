"""Nothing under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level module names are
compared whole: the port's own name starts with the JAX package's."""

import ast
import os
import subprocess
import sys

from portbench import manifest, run

HERE = os.path.join(manifest.ROOT, 'portbench')
JAX = {'jax', 'jaxlib', 'flax', 'corona13_tpu'}


def _imports(path):
    """Top-level names of the absolute imports of a file."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


def _files(top):
    for d, _, files in os.walk(top):
        yield from (os.path.join(d, f) for f in files if f.endswith('.py'))


def test_no_jax_anywhere():
    for path in _files(HERE):
        assert not set(_imports(path)) & JAX, path
    assert set(run.FORBIDDEN) == JAX


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, 'reference')
    for path in _files(ref):
        names = set(_imports(path))
        assert names <= {'__future__', 'collections', 'dataclasses', 'enum',
                         'functools', 'math', 'numpy', 'os', 're', 'struct',
                         'torch', 'types', 'typing'}, (path, names)
    code = ('import sys; import portbench.reference, '
            'portbench.reference.tracer.samplers.pt; '
            'print(sorted({m.split(".")[0] for m in sys.modules} & '
            '{"corona13_tpu_torch", "corona13_tpu", "jax"}))')
    out = subprocess.run([sys.executable, '-c', code], cwd=manifest.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == '[]'


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'corona13_tpu_torch_x', sys)
    assert 'corona13_tpu' not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'corona13_tpu.render', sys)
    assert run.forbidden_modules() == ['corona13_tpu']
