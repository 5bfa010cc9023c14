"""The port stands alone: no module of ``dgsqp_torch`` (nor ``chip_smoke.py``, nor a
``scripts/torch_*.py`` script) imports JAX or anything of the JAX package ``dgsqp_tpu``."""
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / 'dgsqp_torch'
SCRIPTS = sorted((ROOT / 'scripts').glob('torch_*.py'))
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
    for new in ('solvers.dgsqp_v2', 'harness.mc_study', 'harness.analysis',
                'solvers.dgsqp_v2_frenet', 'dynamics.progress_augmented', 'tracks.bspline',
                'solvers.mcp', 'solvers.ibr', 'solvers.algames', 'solvers.backtrack'):
        assert f'dgsqp_torch.{new}' in mods
    scripts = [p.stem for p in SCRIPTS]
    assert 'torch_monte_carlo_main' in scripts and 'torch_profile_round' in scripts
    assert 'torch_gne_compare_main' in scripts
    code = ('import importlib, sys\n'
            f'for m in {mods!r}:\n'
            '    importlib.import_module(m)\n'
            'import chip_smoke\n'
            "sys.path.insert(0, 'scripts')\n"
            f'for m in {scripts!r}:\n'
            '    importlib.import_module(m)\n'
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m.startswith('dgsqp_tpu'))\n"
            'print(bad)\n'
            'sys.exit(1 if bad else 0)\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_source_imports_the_jax_package():
    for path in sorted(PKG.rglob('*.py')) + [ROOT / 'chip_smoke.py'] + SCRIPTS:
        src = path.read_text()
        assert not _IMPORT_TPU.search(src), path
        assert not _IMPORT_JAX.search(src), path


def test_new_entry_points_default_to_the_card():
    """Every entry point of the port takes ``device`` and defaults to ``'cuda'``."""
    import inspect

    from dgsqp_torch.harness.bench_setup import build_bench_solver
    from dgsqp_torch.harness.mc_study import run_mc_study
    from dgsqp_torch.harness.samplers import (sample_agents_initial_conditions,
                                              sample_duel_initial_conditions)
    from dgsqp_torch.harness.mc_study import run_mc_study_algames
    from dgsqp_torch.solvers.algames import ALGAMES
    from dgsqp_torch.solvers.dgsqp_v2 import DGSQPV2
    from dgsqp_torch.solvers.dgsqp_v2_frenet import DGSQPV2FrenetApprox
    from dgsqp_torch.solvers.ibr import IBR
    from dgsqp_torch.solvers.mcp import PATHMCP, PATHMCPFrenetApprox
    for fn in (build_bench_solver, run_mc_study, sample_agents_initial_conditions,
               sample_duel_initial_conditions, DGSQPV2.__init__,
               DGSQPV2FrenetApprox.__init__, run_mc_study_algames, ALGAMES.__init__,
               IBR.__init__, PATHMCP.__init__, PATHMCPFrenetApprox.__init__):
        params = inspect.signature(fn).parameters
        assert params['device'].default == 'cuda', fn
        assert 'dtype' in params, fn
    script = (ROOT / 'scripts' / 'torch_monte_carlo_main.py').read_text()
    assert "'--device', default='cuda'" in script and "'--dtype'" in script
