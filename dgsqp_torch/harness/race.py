"""Closed-loop two-car race: plant simulation, tracking MPC and a game planner, ported
from ``dgsqp_tpu/harness/race.py``.

* Two dynamic-bicycle-combined plants stepped at the fine simulation rate (each step one
  ``dyn_step`` launch on the card).
* One CA-LTV-MPC raceline tracker per car at the control rate, the opponent's predicted
  position entering through per-stage collision-avoidance parameters.
* A DGSQP game planner on kinematic-unicycle-combined models, a batch of one on the
  flat round machine, triggered when the two cars' raceline look-aheads come within
  interaction range; its converged solution becomes a time-parametrized reference that
  overrides the raceline over the game's s-range.

The trigger, the references and the warm-start shifts are host numpy, as in the JAX
version, so that both packages take the same discrete decisions on the same states.
``RaceStack`` runs on ``device`` (default the card) in ``dtype`` (default float64).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from dgsqp_torch.dynamics import (DynamicBicycleCombined, DynamicBicycleConfig,
                                  KinematicUnicycleCombined, MultiAgentDynamicsModel,
                                  MultiAgentModelConfig, UnicycleConfig)
from dgsqp_torch.dynamics.simulator import DynamicsSimulator
from dgsqp_torch.solvers.ca_ltv_mpc import CA_LTV_MPC
from dgsqp_torch.solvers.dgsqp import DGSQP
from dgsqp_torch.solvers.solver_types import CALTVMPCParams, DGSQPParams
from dgsqp_torch.tracks.track_lib import (RacelineInterpolator, get_track,
                                          load_mpclab_raceline)
from dgsqp_torch.types import (BodyAngularVelocity, BodyLinearVelocity, OrientationEuler,
                               ParametricPose, Position, VehicleActuation, VehicleState)


def _host(a):
    """A host query tensor (float64, CPU) for the raceline's interpolators."""
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _centerline_raceline(track, v: float = 1.5, n: int = 400):
    """Synthetic raceline along the centerline at constant speed (used when no recorded
    raceline file is available).  Columns: [x, y, psi, v_long, v_tran, psidot, e_psi,
    s, e_y]."""
    L = track.track_length
    s = np.linspace(0, 2 * L, n)
    zeros = np.zeros(n)
    xyp = track.local_to_global(_host(np.stack([s, zeros, zeros], -1))).numpy()
    mat = np.stack([xyp[:, 0], xyp[:, 1], xyp[:, 2], np.full(n, v), zeros, zeros,
                    zeros, s, zeros], axis=-1)
    return RacelineInterpolator(s / v, mat)


def race_car_model(track, dt: float = 0.1):
    """The race's car: a dynamic bicycle (Pacejka tires, rk4) in the combined frame,
    the trackers' model and the plant."""
    cfg = DynamicBicycleConfig(dt=dt, model_name='dynamic_bicycle', noise=False,
                               discretization_method='rk4', simple_slip=False,
                               tire_model='pacejka', mass=2.2187, yaw_inertia=0.02723,
                               wheel_friction=0.96,
                               pacejka_b_front=0.99, pacejka_b_rear=0.99,
                               pacejka_c_front=11.04, pacejka_c_rear=11.04)
    return DynamicBicycleCombined(0.0, cfg, track=track)


def make_tracker(track, N: int = 20, dt: float = 0.1, obs_r: float = 0.21,
                 device='cuda', dtype=torch.float64):
    """One car's raceline-tracking CA-LTV-MPC on the race's car model."""
    L, H = track.track_length, track.half_width
    model = race_car_model(track, dt)

    ub = VehicleState(x=Position(x=10, y=10),
                      p=ParametricPose(s=2 * L, x_tran=H, e_psi=100),
                      v=BodyLinearVelocity(v_long=10, v_tran=10),
                      w=BodyAngularVelocity(w_psi=10),
                      u=VehicleActuation(u_a=2.1, u_steer=0.436))
    lb = VehicleState(x=Position(x=-10, y=-10),
                      p=ParametricPose(s=-2 * L, x_tran=-H, e_psi=-100),
                      v=BodyLinearVelocity(v_long=-10, v_tran=-10),
                      w=BodyAngularVelocity(w_psi=-10),
                      u=VehicleActuation(u_a=-2.1, u_steer=-0.436))
    du_ub = VehicleState(u=VehicleActuation(u_a=10.0, u_steer=4.5))
    du_lb = VehicleState(u=VehicleActuation(u_a=-10.0, u_steer=-4.5))

    W = torch.as_tensor(np.diag([0, 0, 1, 0, 0, 1, 1, 1]).astype(float), dtype=dtype,
                        device=device)

    def state_stage(q, P, k):
        dq = q - P['q_ref'][k]
        return 0.5 * dq @ W @ dq
    state_stage.stage_indexed = True

    def state_term(q, P, k):
        dq = q - P['q_ref'][k]
        return 0.5 * dq @ W @ dq - 1.0 * q[6]
    state_term.stage_indexed = True

    def input_cost(u):
        return 0.5 * (1e-4 * u[0] ** 2 + 1e-4 * u[1] ** 2)

    def rate_cost(du):
        return 0.5 * (0.01 * du[0] ** 2 + 1.0 * du[1] ** 2)

    def obs_avoid(q, u, P, k):
        d = q[0:2] - P['p_obs'][k]
        return torch.atleast_1d((2 * obs_r) ** 2 - torch.dot(d, d))
    obs_avoid.stage_indexed = True
    obs_avoid.n_out = 1

    costs = {'state': [state_stage] * N + [state_term],
             'input': [input_cost] * (N + 1),
             'rate': [rate_cost] * N}
    constraints = {'state_input': [None] + [obs_avoid] * N, 'rate': [None] * N}
    params = CALTVMPCParams(N=N, dt=dt, qp_iters=2, damping=0.75,
                            wrapped_state_idxs=[6], wrapped_state_periods=[L])
    mpc = CA_LTV_MPC(model, costs, constraints,
                     {'qu_ub': ub, 'qu_lb': lb, 'du_ub': du_ub, 'du_lb': du_lb},
                     params, print_method=None, dtype=dtype, device=device)
    return model, mpc


def make_game_planner(track, N: int = 20, dt: float = 0.1, obs_r: float = 0.21,
                      device='cuda', dtype=torch.float64):
    """DGSQP planner on kinematic-unicycle-combined models."""
    H = track.half_width
    models = [KinematicUnicycleCombined(0.0, UnicycleConfig(dt=dt), track=track)
              for _ in range(2)]
    joint = MultiAgentDynamicsModel(0.0, models, MultiAgentModelConfig(dt=dt))

    S1, S2 = 4, 10
    XY1, XY2 = (0, 1), (6, 7)
    obs_d = 2 * obs_r

    def make_cost(own_s, other_s):
        def stage(x, u, um):
            return 0.5 * (0.1 * u[..., 0] ** 2 + 0.1 * u[..., 1] ** 2) \
                + 0.5 * (0.1 * (u[..., 0] - um[..., 0]) ** 2
                         + 0.1 * (u[..., 1] - um[..., 1]) ** 2)

        def term(x):
            return -1.0 * x[..., own_s] + 5.0 * torch.atan(x[..., other_s] - x[..., own_s])
        return (stage, term)

    costs = [make_cost(S1, S2), make_cost(S2, S1)]

    def obs_avoid(x, u, um):
        d0 = x[..., XY1[0]] - x[..., XY2[0]]
        d1 = x[..., XY1[1]] - x[..., XY2[1]]
        return (obs_d ** 2 - (d0 * d0 + d1 * d1))[..., None]

    def obs_avoid_term(x):
        d0 = x[..., XY1[0]] - x[..., XY2[0]]
        d1 = x[..., XY1[1]] - x[..., XY2[1]]
        return (obs_d ** 2 - (d0 * d0 + d1 * d1))[..., None]

    shared = [None] + [obs_avoid] * (N - 1) + [obs_avoid_term]

    def bound(sign):
        return VehicleState(
            x=Position(x=sign * np.inf, y=sign * np.inf),
            p=ParametricPose(s=sign * np.inf, x_tran=sign * H, e_psi=sign * np.inf),
            e=OrientationEuler(psi=sign * np.inf),
            v=BodyLinearVelocity(v_long=sign * np.inf, v_tran=sign * np.inf),
            w=BodyAngularVelocity(w_psi=sign * np.inf),
            u=VehicleActuation(u_a=sign * 2.0, u_steer=sign * 2.0))

    params = DGSQPParams(N=N, dt=dt, reg=1e-3, nonmono_ls=True, line_search_iters=50,
                         sqp_iters=50, p_tol=1e-3, d_tol=1e-3, beta=0.01, tau=0.5)
    planner = DGSQP(joint, costs, [None, None], shared,
                    {'ub': [bound(1), bound(1)], 'lb': [bound(-1), bound(-1)]},
                    params, print_method=None, dtype=dtype, device=device)
    return joint, planner


@dataclass
class RaceConfig:
    track_name: str = 'L_track_barc'
    control_dt: float = 0.1
    sim_dt: float = 0.01
    mpc_N: int = 20
    game_N: int = 20
    obs_r: float = 0.21
    lookahead_time: float = 1.0
    lookahead_window: int = 10
    n_steps: int = 50
    raceline_speed: float = 1.5
    # the recorded raceline (dgsqp_torch/harness/data); None falls back to the
    # synthetic centerline, and time_scale slows the recorded line down
    raceline_file: Optional[str] = 'L_track_barc_raceline.npz'
    raceline_time_scale: float = 1.4


class RaceStack:
    """Two-car closed-loop race with game-planner interventions.

    ``timing`` holds, per control step, the seconds of the trackers, the game trigger
    with its solve (``planner``) and the plant simulation."""

    def __init__(self, config: RaceConfig = None, track=None, device='cuda',
                 dtype=torch.float64):
        cfg = config or RaceConfig()
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = dtype
        self.track = track if track is not None else get_track(cfg.track_name)
        self.raceline = None
        if cfg.raceline_file and track is None:
            # the recorded raceline is only valid on its own track
            path = Path(__file__).parent / 'data' / cfg.raceline_file
            if path.exists():
                self.raceline, _, _ = load_mpclab_raceline(
                    str(path), cfg.track_name, time_scale=cfg.raceline_time_scale)
        if self.raceline is None:
            self.raceline = _centerline_raceline(self.track, v=cfg.raceline_speed)
        self.L = self.track.track_length

        self.models, self.trackers = [], []
        for _ in range(2):
            m, mpc = make_tracker(self.track, N=cfg.mpc_N, dt=cfg.control_dt,
                                  obs_r=cfg.obs_r, device=device, dtype=dtype)
            self.models.append(m)
            self.trackers.append(mpc)
        self.sims = [DynamicsSimulator(0.0, m, device=device, dtype=dtype)
                     for m in self.models]
        self.game_joint, self.planner = make_game_planner(
            self.track, N=cfg.game_N, dt=cfg.control_dt, obs_r=cfg.obs_r, device=device,
            dtype=dtype)
        self.solve_game = True
        self.game_refs = [None, None]       # (t_grid, q_ref_game (n, 8), s_lim)
        self.history = []
        self.game_log = []
        self.timing = dict(trackers=[], planner=[], plant=[])

    def _raceline_cols(self, t):
        """The raceline's columns at times ``t`` as an (n, 9) numpy array."""
        return np.stack([c.numpy() for c in self.raceline(_host(t))], axis=-1)

    def _s2t(self, s) -> float:
        return float(self.raceline.s2t(_host(s)))

    # ----------------------------------------------------------------- helpers
    def _raceline_ref(self, state, car: int):
        """Per-stage reference states for the tracking MPC (raceline or game
        override)."""
        cfg = self.cfg
        N = cfg.mpc_N
        s = np.mod(state.p.s, self.L)
        refs = np.zeros((N + 1, 8))
        game = self.game_refs[car]
        if game is not None:
            t_grid, q_game, s_lim = game
            if s_lim[0] - 1e-3 <= s <= s_lim[1]:
                t0 = float(np.interp(s, q_game[:, 6], t_grid))
                tt = t0 + cfg.control_dt * np.arange(N + 1)
                for i in range(8):
                    refs[:, i] = np.interp(tt, t_grid, q_game[:, i])
                return refs
            if s > s_lim[1]:
                self.game_refs[car] = None
        t0 = self._s2t(s)
        mat = self._raceline_cols(t0 + cfg.control_dt * np.arange(N + 1))
        # raceline columns [x, y, psi, v_long, v_tran, psidot, e_psi, s, e_y]
        # -> model state  [x, y, v_long, v_tran, psidot, e_psi, s, e_y]
        refs[:, 0:2] = mat[:, 0:2]
        refs[:, 2] = mat[:, 3]
        refs[:, 3] = mat[:, 4]
        refs[:, 4] = mat[:, 5]
        refs[:, 5] = mat[:, 6]
        refs[:, 6] = mat[:, 7]
        refs[:, 7] = mat[:, 8]
        return refs

    def _maybe_solve_game(self, states):
        cfg = self.cfg
        if not self.solve_game:
            # re-arm once both cars have exited the game segment (their refs are
            # cleared by _raceline_ref when s passes s_lim)
            if all(ref is None for ref in self.game_refs):
                self.solve_game = True
            else:
                return
        t1 = self._s2t(np.mod(states[0].p.s, self.L))
        t2 = self._s2t(np.mod(states[1].p.s, self.L))
        window = cfg.lookahead_time + cfg.control_dt * np.arange(cfg.lookahead_window)
        la1 = self._raceline_cols(t1 + window)
        la2 = self._raceline_cols(t2 + window)
        d = np.linalg.norm(la1[:, :2] - la2[:, :2], axis=1)
        close = d <= 4 * cfg.obs_r
        free = d >= 2 * cfg.obs_r
        idxs = np.argwhere(close & free)
        if len(idxs) == 0:
            return
        i = int(idxs[0][0])
        # game initial states from the look-ahead points
        game_states = []
        for la in (la1, la2):
            st = VehicleState(t=0.0)
            st.x.x, st.x.y = la[i, 0], la[i, 1]
            st.v.v_long = la[i, 3]
            st.p.e_psi, st.p.s, st.p.x_tran = la[i, 6], la[i, 7], la[i, 8]
            game_states.append(st)

        # zero warm start for the unicycle game (Fx, wz ~ 0 hold speed)
        self.planner.set_warm_start(np.zeros((cfg.game_N, 4)))
        info = self.planner.solve(game_states)
        self.game_log.append(dict(info={k: v for k, v in info.items()
                                        if k in ('msg', 'num_iters', 'cond')},
                                  idx=i))
        if info['msg'] in ('conv_abs_tol', 'conv_rel_tol'):
            q_game = self.planner.q_pred       # (N+1, 12)
            t_base1 = t1 + cfg.lookahead_time + cfg.control_dt * i
            t_base2 = t2 + cfg.lookahead_time + cfg.control_dt * i
            for car, (blk, t_base) in enumerate([(q_game[:, :6], t_base1),
                                                 (q_game[:, 6:], t_base2)]):
                # unicycle state [x, y, v, epsi, s, ey] -> tracker reference
                # [x, y, vx, vy, psidot, epsi, s, ey]
                q_ref = np.zeros((blk.shape[0], 8))
                q_ref[:, 0:2] = blk[:, 0:2]
                q_ref[:, 2] = blk[:, 2]
                q_ref[:, 5:] = blk[:, 3:]
                t_grid = t_base + cfg.control_dt * np.arange(blk.shape[0])
                self.game_refs[car] = (t_grid, q_ref, (q_ref[0, 6], q_ref[-1, 6]))
            self.solve_game = False

    # --------------------------------------------------------------------- run
    def initial_states(self):
        """The default start: the two cars at s = 0.5 and 1.2, e_y = +-0.2."""
        states = []
        for s0, ey0 in [(0.5, 0.2), (1.2, -0.2)]:
            st = VehicleState(t=0.0)
            st.p.s, st.p.x_tran = s0, ey0
            st.v.v_long = self.cfg.raceline_speed
            self.track.local_to_global_typed(st)
            states.append(st)
        return states

    def run(self, initial_states=None, n_steps: Optional[int] = None):
        """Run ``n_steps`` control steps (default the configuration's) from
        ``initial_states`` (default :meth:`initial_states`), which advance in place."""
        cfg = self.cfg
        n_steps = n_steps or cfg.n_steps
        states = initial_states if initial_states is not None else self.initial_states()
        tensor = lambda a: torch.as_tensor(a, dtype=self.dtype, device=self.device)

        for step in range(n_steps):
            t0 = time.perf_counter()
            # references + opponent predictions
            Ps = []
            for car in range(2):
                other = 1 - car
                q_ref = self._raceline_ref(states[car], car)
                opp_pred = self.trackers[other].q_pred
                if np.allclose(opp_pred, 0):
                    p_obs = np.tile([states[other].x.x, states[other].x.y],
                                    (cfg.mpc_N + 1, 1))
                else:
                    p_obs = opp_pred[:, 0:2]
                Ps.append({'q_ref': tensor(q_ref), 'p_obs': tensor(p_obs)})

            for car in range(2):
                self.trackers[car].step(states[car], parameters=Ps[car])
            t1 = time.perf_counter()

            # game trigger
            self._maybe_solve_game(states)
            t2 = time.perf_counter()

            # plant simulation at the fine rate
            for car in range(2):
                for _ in range(int(round(cfg.control_dt / cfg.sim_dt))):
                    self.sims[car].step(states[car], T=cfg.sim_dt)
            t3 = time.perf_counter()

            self.history.append([states[0].copy(), states[1].copy()])
            for part, sec in (('trackers', t1 - t0), ('planner', t2 - t1), ('plant', t3 - t2)):
                self.timing[part].append(sec)
        return self.history
