"""Port parity: the closed-loop race stack (plants, CA-LTV-MPC trackers, game planner),
on the CPU in float64.

* A ``RaceStack`` on the ``CurveTrack`` of ``tests/test_race.py`` (``mpc_N = game_N =
  5``, ``sim_dt`` 0.02, 3 control steps) runs in both packages from the same start:
  every car's state after every step within ``STATE_ATOL``, the same tracker success
  flags, the same ``game_log`` (step, look-ahead index, ``msg``, ``num_iters``) and the
  planner's last prediction ``q_pred`` within ``PRED_ATOL``.
* The record that ``chip_smoke.py``'s ``race_path`` holds the card to,
  ``dgsqp_torch/harness/data/race_reference_f64.json``, is the JAX package's
  ``RaceStack(RaceConfig())`` (``L_track_barc``, the recorded raceline, ``mpc_N =
  game_N = 20``) in float64 on the CPU: :func:`jax_race_record` writes it (run this
  file as a script: ``python tests/test_torch_race.py --write-record``), and the
  ``slow`` test re-runs it and holds it to the file.
* ``scripts/torch_race_main.py --no-plot`` writes its summary on the CPU.
"""
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
RECORD = ROOT / 'dgsqp_torch' / 'harness' / 'data' / 'race_reference_f64.json'
# the record's steps: all of RaceConfig().n_steps
RECORD_STEPS = 50

# a car's state as the record keeps it, one number per field
STATE_FIELDS = ('x.x', 'x.y', 'v.v_long', 'v.v_tran', 'w.w_psi', 'p.e_psi', 'p.s',
                'p.x_tran', 'e.psi', 'u.u_a', 'u.u_steer', 't')
# float64 on both sides, the same iterations: rounding only, amplified by the loop
STATE_ATOL = 1e-8
PRED_ATOL = 1e-8


def state_vector(st):
    out = []
    for name in STATE_FIELDS:
        obj = st
        for part in name.split('.'):
            obj = getattr(obj, part)
        out.append(float(obj))
    return out


def initial_states(stack, state_cls):
    """``RaceStack.run``'s default start: the two cars at s = 0.5 and 1.2."""
    states = []
    for s0, ey0 in [(0.5, 0.2), (1.2, -0.2)]:
        st = state_cls(t=0.0)
        st.p.s, st.p.x_tran = s0, ey0
        st.v.v_long = stack.cfg.raceline_speed
        stack.track.local_to_global_typed(st)
        states.append(st)
    return states


def record_run(stack, state_cls, n_steps, on_step=None):
    """Run ``stack`` one control step at a time from its default start, recording each
    step's states, the trackers' success flags and the game solves of that step."""
    flags = []
    for mpc in stack.trackers:
        step = mpc.step

        def recorded(state, parameters=None, _step=step):
            out = _step(state, parameters)
            flags.append(bool(out['success']))
            return out
        mpc.step = recorded
    states = initial_states(stack, state_cls)
    rec = dict(states=[], tracker_success=[], game_log=[])
    for k in range(n_steps):
        n_games = len(stack.game_log)
        stack.run(initial_states=states, n_steps=1)
        rec['states'].append([state_vector(st) for st in states])
        rec['tracker_success'].append(flags[-2:])
        for g in stack.game_log[n_games:]:
            rec['game_log'].append(dict(step=k, idx=int(g['idx']), msg=g['info']['msg'],
                                        num_iters=int(g['info']['num_iters'])))
        if on_step is not None:
            on_step(k, rec)
    return rec


def jax_race_record(n_steps=RECORD_STEPS, verbose=False):
    """The JAX package's ``RaceStack(RaceConfig())`` in float64 on the CPU, recorded."""
    import dataclasses
    from dgsqp_tpu.harness.race import RaceConfig, RaceStack
    from dgsqp_tpu.types import VehicleState
    cfg = RaceConfig()
    stack = RaceStack(cfg)
    t0 = time.time()

    def progress(k, rec):
        if verbose:
            print(f'step {k}: {time.time() - t0:.1f} s, games {rec["game_log"]}',
                  flush=True)
    rec = record_run(stack, VehicleState, n_steps, progress)
    rec.update(config=dataclasses.asdict(cfg), n_steps=n_steps, dtype='float64',
               package='dgsqp_tpu', device='cpu', state_fields=list(STATE_FIELDS),
               seconds=time.time() - t0)
    return rec


CURVE = dict(enter_straight_length=4, curve_length=6, curve_swept_angle=np.pi / 2,
             exit_straight_length=6, width=2.0, slack=0.8)
CURVE_CFG = dict(control_dt=0.1, sim_dt=0.02, mpc_N=5, game_N=5, lookahead_time=0.4,
                 lookahead_window=5, n_steps=3, raceline_speed=1.2)


def _curve_stacks():
    """Both packages' stacks on ``tests/test_race.py``'s CurveTrack (the port's track
    with the JAX package's tables, so that both query identical geometry)."""
    import torch
    from dgsqp_tpu.harness import race as jrace
    from dgsqp_tpu.tracks import CurveTrack as JCurve
    from dgsqp_torch.harness import race as trace_
    from dgsqp_torch.interop import load_track_tables
    from dgsqp_torch.tracks.track_lib import CurveTrack as TCurve
    jt, tt = JCurve(**CURVE), TCurve(**CURVE)
    load_track_tables(tt, jt.key_pts, jt.cum_angle)
    return (jrace.RaceStack(jrace.RaceConfig(**CURVE_CFG), track=jt),
            trace_.RaceStack(trace_.RaceConfig(**CURVE_CFG), track=tt, device='cpu',
                             dtype=torch.float64))


@pytest.fixture(scope='module')
def curve_race(one_torch_thread):
    """3 control steps of both stacks, and the JAX stack's state after step 1."""
    from dgsqp_tpu.types import VehicleState as JState
    from dgsqp_torch.interop import race_state
    from dgsqp_torch.types import VehicleState as TState
    js, ts = _curve_stacks()
    mid = {}

    def keep(k, rec):
        if k == 1:
            mid['race'] = race_state(js)
            mid['states'] = [st.copy() for st in js.history[-1]]
    rec_j = record_run(js, JState, CURVE_CFG['n_steps'], keep)
    rec_t = record_run(ts, TState, CURVE_CFG['n_steps'])
    return js, ts, rec_j, rec_t, mid


def test_curve_race_states_match_jax(curve_race):
    js, ts, rec_j, rec_t, _ = curve_race
    assert len(ts.history) == CURVE_CFG['n_steps']
    np.testing.assert_allclose(np.asarray(rec_t['states']), np.asarray(rec_j['states']),
                               rtol=0, atol=STATE_ATOL)
    assert rec_t['tracker_success'] == rec_j['tracker_success']
    # the cars advance and stay on the track (tests/test_race.py's checks)
    for car in range(2):
        assert ts.history[-1][car].p.s > ts.history[0][car].p.s
        assert all(abs(snap[car].p.x_tran) <= ts.track.half_width + 0.3
                   for snap in ts.history)


def test_curve_race_game_log_and_prediction_match_jax(curve_race):
    js, ts, rec_j, rec_t, _ = curve_race
    assert rec_t['game_log'] == rec_j['game_log']
    assert any(g['msg'] in ('conv_abs_tol', 'conv_rel_tol') for g in rec_t['game_log'])
    np.testing.assert_allclose(ts.planner.q_pred, js.planner.q_pred, rtol=0, atol=PRED_ATOL)
    for a, b in zip(ts.game_refs, js.game_refs):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a[1], b[1], rtol=0, atol=PRED_ATOL)
    assert set(ts.timing) == {'trackers', 'planner', 'plant'}
    assert all(len(v) == CURVE_CFG['n_steps'] for v in ts.timing.values())


def test_race_continues_from_the_jax_stacks_state(curve_race):
    """``interop.race_state`` and ``vehicle_state`` carry the JAX stack after step 1
    into a fresh port stack, whose step 2 then matches the JAX stack's."""
    import torch
    from dgsqp_torch.harness import race as trace_
    from dgsqp_torch.interop import race_state, vehicle_state
    js, ts, rec_j, _, mid = curve_race
    fresh = trace_.RaceStack(trace_.RaceConfig(**CURVE_CFG), track=ts.track, device='cpu',
                             dtype=torch.float64)
    race_state(mid['race'], fresh)
    states = [vehicle_state(s) for s in mid['states']]
    fresh.run(initial_states=states, n_steps=1)
    np.testing.assert_allclose([state_vector(s) for s in states], rec_j['states'][2],
                               rtol=0, atol=STATE_ATOL)


def test_race_plot_writes_a_figure(curve_race, tmp_path):
    from dgsqp_torch.harness.plotting import plot_race_history
    _, ts, _, _, _ = curve_race
    out = tmp_path / 'race.png'
    plot_race_history(ts.history, track=ts.track, save_path=str(out))
    assert out.stat().st_size > 0


def test_committed_record_is_whole():
    """The record race_path holds the card to: the port's default configuration,
    RECORD_STEPS steps, and a converged intervention within the first 10 steps."""
    import dataclasses
    from dgsqp_torch.harness.race import RaceConfig
    rec = json.loads(RECORD.read_text())
    assert rec['config'] == dataclasses.asdict(RaceConfig())
    assert rec['n_steps'] == RECORD_STEPS == len(rec['states'])
    assert rec['state_fields'] == list(STATE_FIELDS)
    assert np.asarray(rec['states']).shape == (RECORD_STEPS, 2, len(STATE_FIELDS))
    assert np.isfinite(np.asarray(rec['states'])).all()
    assert any(g['msg'] in ('conv_abs_tol', 'conv_rel_tol') and g['step'] < 10
               for g in rec['game_log'])


def test_race_main_script_writes_its_summary(tmp_path):
    import subprocess
    out = subprocess.run([sys.executable, 'scripts/torch_race_main.py', '--no-plot',
                          '--steps', '2', '--mpc_N', '5', '--game_N', '5', '--device', 'cpu',
                          '--out', str(tmp_path)], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    summary = json.loads((tmp_path / 'race_summary.json').read_text())
    assert set(summary) == {'steps', 'wall_s', 'steps_per_s', 'game_solves', 'final_s'}
    assert summary['steps'] == 2 and len(summary['final_s']) == 2


@pytest.mark.slow
def test_race_record_matches_jax():
    """The committed record is what the JAX package computes now."""
    rec = json.loads(RECORD.read_text())
    new = jax_race_record(rec['n_steps'])
    np.testing.assert_allclose(np.asarray(new['states']), np.asarray(rec['states']),
                               rtol=0, atol=STATE_ATOL)
    assert new['tracker_success'] == rec['tracker_success']
    assert new['game_log'] == rec['game_log']


if __name__ == '__main__':
    if sys.argv[1:] != ['--write-record']:
        sys.exit('usage: python tests/test_torch_race.py --write-record')
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    sys.path.insert(0, str(ROOT))
    out = jax_race_record(verbose=True)
    RECORD.write_text(json.dumps(out) + '\n')
    print(f'wrote {RECORD} ({out["seconds"]:.0f} s)')
