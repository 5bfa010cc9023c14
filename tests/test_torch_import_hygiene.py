"""The port stands alone: no module of ``dgsqp_torch`` (nor ``chip_smoke.py``, nor a
``scripts/torch_*.py`` script) imports JAX or anything of the JAX package ``dgsqp_tpu``,
or names a data file under ``dgsqp_tpu/`` or a reference checkout: the saved tracks and
racelines it loads are its own copies, and loading them opens no file of the JAX
package.  The port's shell scripts call only the port's scripts.  The port's
``solvers``, ``dynamics`` and ``tracks`` export every name their JAX counterparts
export."""
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / 'dgsqp_torch'
SCRIPTS = sorted((ROOT / 'scripts').glob('torch_*.py'))
# docstrings name each module's dgsqp_tpu counterpart by file; what must not appear is
# an import of it, static or through importlib
_IMPORT_TPU = re.compile(r'^\s*(from\s+dgsqp_tpu\b|import\s+dgsqp_tpu\b)'
                         r'|(import_module|__import__)\(\s*[\'"]dgsqp_tpu', re.M)
_IMPORT_JAX = re.compile(r'^\s*(from\s+jax\b|import\s+jax\b)'
                         r'|(import_module|__import__)\(\s*[\'"]jax', re.M)
# a line that names the JAX package beside a data file or folder, or a checkout of the
# reference project (the JAX package's track loader also looks in one)
_DATA_PATH = re.compile(r'dgsqp_tpu.*(track_data|[\'"/]data\b|\.npz|\.csv)'
                        r'|reference/DGSQP', re.M)


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
                'solvers.mcp', 'solvers.ibr', 'solvers.algames', 'solvers.backtrack',
                'ops.dynamics', 'harness.dynamic_study', 'harness.f1_study',
                'tracks.track_lib', 'solvers.ocp_qp', 'solvers.ca_ltv_mpc', 'solvers.pid',
                'solvers.abstract_solver', 'dynamics.simulator', 'harness.race',
                'harness.plotting', 'utils.profiling', 'parallel', 'parallel.mesh',
                'harness.bench'):
        assert f'dgsqp_torch.{new}' in mods
    scripts = [p.stem for p in SCRIPTS]
    assert 'torch_monte_carlo_main' in scripts and 'torch_profile_round' in scripts
    assert 'torch_gne_compare_main' in scripts and 'torch_f1_study_main' in scripts
    assert 'torch_race_main' in scripts
    for new in ('torch_diagnose_failures', 'torch_diagnose_approx',
                'torch_stalled_oracle_crosstab', 'torch_merge_oracles', 'torch_mcp_tune',
                'torch_regularization_study_main', 'torch_analyze_regularization',
                'torch_bench', 'torch_retry_probe', 'torch_profile_batch_scaling',
                'torch_bench_parting'):
        assert new in scripts, new
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


def test_no_source_names_a_jax_data_path():
    for path in sorted(PKG.rglob('*.py')) + [ROOT / 'chip_smoke.py'] + SCRIPTS:
        hit = _DATA_PATH.search(path.read_text())
        assert hit is None, (path, hit and hit.group(0))


def test_loading_tracks_and_racelines_opens_only_the_ports_files():
    """Every file opened while the saved tracks, both racelines and the dynamic and F1
    scenarios load lies in the port's own folders."""
    code = ('import sys\n'
            'opened = []\n'
            "sys.addaudithook(lambda ev, a: opened.append(str(a[0])) if ev == 'open' else None)\n"
            'from dgsqp_torch.tracks.track_lib import get_track\n'
            'from dgsqp_torch.harness.dynamic_study import ltrack_raceline\n'
            'from dgsqp_torch.harness.f1_study import build_f1_scenario, f1_raceline\n'
            'from dgsqp_torch.harness.scenarios import build_dynamic_duel\n'
            "get_track('L_track_barc'); get_track('f1_austin_tenth_scale')\n"
            'ltrack_raceline(); f1_raceline(); build_dynamic_duel(N=2); build_f1_scenario(N=2)\n'
            "data = [p for p in opened if p.endswith(('.npz', '.csv'))]\n"
            "bad = [p for p in opened if 'dgsqp_tpu' in p or 'reference/DGSQP' in p]\n"
            'print(len(data), bad)\n'
            'sys.exit(1 if bad or len(data) < 4 else 0)\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_new_entry_points_default_to_the_card():
    """Every entry point of the port takes ``device`` and defaults to ``'cuda'``."""
    import inspect

    from dgsqp_torch.harness.bench import run_bench
    from dgsqp_torch.harness.bench_setup import build_bench_solver
    from dgsqp_torch.harness.dynamic_study import (sample_dynamic_duel_initial_conditions,
                                                   sample_dynamic_pa_initial_conditions)
    from dgsqp_torch.harness.f1_study import run_f1_study, sample_f1_initial_conditions
    from dgsqp_torch.harness.mc_study import run_mc_study
    from dgsqp_torch.harness.samplers import (sample_agents_initial_conditions,
                                              sample_duel_initial_conditions)
    from dgsqp_torch.harness.mc_study import run_mc_study_algames
    from dgsqp_torch.solvers.algames import ALGAMES
    from dgsqp_torch.solvers.dgsqp_v2 import DGSQPV2
    from dgsqp_torch.solvers.dgsqp_v2_frenet import DGSQPV2FrenetApprox
    from dgsqp_torch.solvers.ibr import IBR
    from dgsqp_torch.solvers.mcp import PATHMCP, PATHMCPFrenetApprox
    for fn in (build_bench_solver, run_bench, run_mc_study, sample_agents_initial_conditions,
               sample_duel_initial_conditions, DGSQPV2.__init__,
               DGSQPV2FrenetApprox.__init__, run_mc_study_algames, ALGAMES.__init__,
               IBR.__init__, PATHMCP.__init__, PATHMCPFrenetApprox.__init__,
               sample_dynamic_duel_initial_conditions, sample_dynamic_pa_initial_conditions,
               sample_f1_initial_conditions, run_f1_study):
        params = inspect.signature(fn).parameters
        assert params['device'].default == 'cuda', fn
        assert 'dtype' in params, fn
    from dgsqp_torch.solvers.dgsqp import DGSQP
    params = inspect.signature(DGSQP.__init__).parameters
    assert params['device'].default == 'cuda' and 'dtype' in params
    for name in ('torch_monte_carlo_main', 'torch_f1_study_main', 'torch_diagnose_failures',
                 'torch_diagnose_approx', 'torch_stalled_oracle_crosstab',
                 'torch_regularization_study_main', 'torch_retry_probe'):
        script = (ROOT / 'scripts' / f'{name}.py').read_text()
        assert "'--device', default='cuda'" in script and "'--dtype'" in script, name
    assert "os.environ.get('DGSQP_DEVICE', 'cuda')" in \
        (ROOT / 'scripts' / 'torch_mcp_tune.py').read_text()
    # sharding names its devices: CUDA devices 0..K-1 unless a device a rank is named
    import pytest
    import torch
    from dgsqp_torch.parallel.mesh import games_mesh, resolve_devices, spawn_ranks
    assert inspect.signature(games_mesh).parameters['devices'].default is None
    assert inspect.signature(spawn_ranks).parameters['devices'].default is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA device'):
            resolve_devices(None, 1)
    script = (ROOT / 'scripts' / 'torch_monte_carlo_main.py').read_text()
    assert "'--devices', type=int, default=None" in script


def test_mpc_and_race_entry_points_default_to_the_card():
    """The closed loop's entry points take ``device`` (default ``'cuda'``) and
    ``dtype``; its script takes ``--device``/``--dtype`` and ``--no-plot``."""
    import inspect

    from dgsqp_torch.dynamics.simulator import DynamicsSimulator
    from dgsqp_torch.harness.race import RaceStack, make_game_planner, make_tracker
    from dgsqp_torch.solvers.ca_ltv_mpc import CA_LTV_MPC
    for fn in (CA_LTV_MPC.__init__, RaceStack.__init__, DynamicsSimulator.__init__,
               make_tracker, make_game_planner):
        params = inspect.signature(fn).parameters
        assert params['device'].default == 'cuda', fn
        assert 'dtype' in params, fn
    script = (ROOT / 'scripts' / 'torch_race_main.py').read_text()
    assert "'--device', default='cuda'" in script and "'--dtype'" in script
    assert "'--no-plot'" in script


def test_race_stack_opens_only_the_ports_files():
    """Building the race (the saved track, the recorded raceline) and the record that
    ``chip_smoke.py`` holds it to open only files in the port's own folders."""
    code = ('import sys\n'
            'opened = []\n'
            "sys.addaudithook(lambda ev, a: opened.append(str(a[0])) if ev == 'open' else None)\n"
            'from dgsqp_torch.harness.race import RaceStack\n'
            "RaceStack(device='cpu')\n"
            'import chip_smoke\n'
            'chip_smoke.race_record()\n'
            "data = [p for p in opened if p.endswith(('.npz', '.csv', '.json'))]\n"
            "bad = [p for p in opened if 'dgsqp_tpu' in p or 'reference/DGSQP' in p]\n"
            'print(data, bad)\n'
            'sys.exit(1 if bad or len(data) < 3 else 0)\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_shell_scripts_call_only_the_ports_scripts():
    """``scripts/torch_*.sh`` run only ``scripts/torch_*.py`` scripts that exist."""
    shells = sorted((ROOT / 'scripts').glob('torch_*.sh'))
    assert {p.name for p in shells} >= {'torch_run_regularization_study.sh',
                                        'torch_run_ablation_study.sh',
                                        'torch_run_studies.sh', 'torch_bench_sweep.sh',
                                        'torch_run_bench_matrix.sh'}
    for path in shells:
        called = re.findall(r'scripts/([A-Za-z0-9_]+)\.py', path.read_text())
        assert called, path
        for name in called:
            assert name.startswith('torch_') and (ROOT / 'scripts' / f'{name}.py').exists(), \
                (path.name, name)


def _exported(init: pathlib.Path) -> set:
    """The names a package's ``__init__.py`` imports (its exports)."""
    import ast
    tree = ast.parse(init.read_text())
    return {a.asname or a.name for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) for a in node.names}


@pytest.mark.parametrize('package', ['solvers', 'dynamics', 'tracks'])
def test_packages_export_the_jax_packages_names(package):
    """Every name the JAX package's ``solvers``, ``dynamics`` and ``tracks`` export, the
    port's export too (the port's extra names may stay), and each one imports."""
    import importlib
    jax_names = _exported(ROOT / 'dgsqp_tpu' / package / '__init__.py')
    port_names = _exported(PKG / package / '__init__.py')
    assert jax_names and not jax_names - port_names, sorted(jax_names - port_names)
    mod = importlib.import_module(f'dgsqp_torch.{package}')
    assert all(hasattr(mod, name) for name in port_names)
