"""The port stands alone: no module of ``dgsqp_torch`` (nor ``chip_smoke.py``) imports
JAX or anything of the JAX package ``dgsqp_tpu``."""
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / 'dgsqp_torch'
# docstrings name each module's dgsqp_tpu counterpart by file; what must not appear is
# an import of it, static or through importlib
_IMPORT_TPU = re.compile(r'^\s*(from\s+dgsqp_tpu\b|import\s+dgsqp_tpu\b)'
                         r'|(import_module|__import__)\(\s*[\'"]dgsqp_tpu', re.M)
_IMPORT_JAX = re.compile(r'^\s*(from\s+jax\b|import\s+jax\b)'
                         r'|(import_module|__import__)\(\s*[\'"]jax', re.M)


def _modules():
    mods = []
    for path in sorted(PKG.rglob('*.py')):
        rel = path.relative_to(ROOT).with_suffix('')
        parts = list(rel.parts)
        if parts[-1] == '__init__':
            parts = parts[:-1]
        mods.append('.'.join(parts))
    return mods


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    assert 'dgsqp_torch.solvers.dgsqp' in mods and 'dgsqp_torch.ops.linalg' in mods
    code = ('import importlib, sys\n'
            f'for m in {mods!r}:\n'
            '    importlib.import_module(m)\n'
            'import chip_smoke\n'
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m.startswith('dgsqp_tpu'))\n"
            'print(bad)\n'
            'sys.exit(1 if bad else 0)\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_source_imports_the_jax_package():
    for path in sorted(PKG.rglob('*.py')) + [ROOT / 'chip_smoke.py']:
        src = path.read_text()
        assert not _IMPORT_TPU.search(src), path
        assert not _IMPORT_JAX.search(src), path
