"""Host-side plotting and video utilities, ported from
``dgsqp_tpu/harness/plotting.py``: one game iterate's predicted positions, a race's xy
traces and time series, a race video, and the converged/failed initial conditions on
the track map.  Each imports matplotlib inside the function (a host without it can
import this module and run everything else).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def plot_track(ax, track, pts_per_dist: Optional[float] = None):
    return track.plot_map(ax, pts_per_dist)


def plot_game_iterate(ax, problem, u_flat, x0, colors: Sequence[str] = ('b', 'g', 'r', 'm')):
    """Each agent's predicted xy positions for one iterate of one game."""
    import torch
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=problem.dtype,
                                  device=problem.device)[None]
    x = problem.rollout(t(u_flat), t(x0))[0].cpu().numpy()
    handles = []
    for a in range(problem.M):
        off = problem.q_offsets[a]
        handles.append(ax.plot(x[:, off], x[:, off + 1], f'{colors[a % len(colors)]}o-',
                               markersize=3)[0])
    ax.set_aspect('equal')
    return handles


def plot_race_history(history: List, track=None, save_path: Optional[str] = None):
    """xy traces + speed/progress time series of a closed-loop race run."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    n_cars = len(history[0])
    fig, (ax_xy, ax_v, ax_s) = plt.subplots(1, 3, figsize=(15, 5))
    if track is not None:
        plot_track(ax_xy, track)
    colors = ['b', 'g', 'r', 'm']
    t = np.arange(len(history))
    for car in range(n_cars):
        xs = [snap[car].x.x for snap in history]
        ys = [snap[car].x.y for snap in history]
        vs = [snap[car].v.v_long for snap in history]
        ss = [snap[car].p.s for snap in history]
        c = colors[car % len(colors)]
        ax_xy.plot(xs, ys, f'{c}-', label=f'car {car + 1}')
        ax_v.plot(t, vs, f'{c}-')
        ax_s.plot(t, ss, f'{c}-')
    ax_xy.set_title('trajectories')
    ax_xy.legend()
    ax_v.set_title('v_long')
    ax_s.set_title('progress s')
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
    return fig


def render_race_video(history: List, track, save_path: str, fps: int = 10,
                      agent_radii: Optional[Sequence[float]] = None):
    """Render an mp4 (a gif where no mp4 writer is found) of the race."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    from matplotlib import animation
    from matplotlib.patches import Circle

    n_cars = len(history[0])
    radii = agent_radii or [0.2] * n_cars
    fig, ax = plt.subplots(figsize=(8, 8))
    plot_track(ax, track)
    colors = ['b', 'g', 'r', 'm']
    patches = []
    trails = []
    for car in range(n_cars):
        c = colors[car % len(colors)]
        p = Circle((history[0][car].x.x, history[0][car].x.y), radii[car],
                   color=c, alpha=0.7)
        ax.add_patch(p)
        patches.append(p)
        trails.append(ax.plot([], [], f'{c}-', linewidth=0.8)[0])

    def update(i):
        for car in range(n_cars):
            patches[car].center = (history[i][car].x.x, history[i][car].x.y)
            trails[car].set_data([s[car].x.x for s in history[:i + 1]],
                                 [s[car].x.y for s in history[:i + 1]])
        return patches + trails

    anim = animation.FuncAnimation(fig, update, frames=len(history), blit=True)
    writer = animation.PillowWriter(fps=fps) if save_path.endswith('.gif') else \
        animation.FFMpegWriter(fps=fps)
    try:
        anim.save(save_path, writer=writer)
    except (FileNotFoundError, RuntimeError):
        gif_path = save_path.rsplit('.', 1)[0] + '.gif'
        anim.save(gif_path, writer=animation.PillowWriter(fps=fps))
        save_path = gif_path
    return save_path


def plot_success_locations(ax, results, track=None):
    """Converged/failed initial conditions on the track map."""
    import torch
    from dgsqp_torch.harness.analysis import success_locations
    locs = success_locations(results)
    if track is not None:
        plot_track(ax, track)
        xyp = track.local_to_global(torch.as_tensor(
            np.stack([locs[:, 0], locs[:, 1], np.zeros(len(locs))], axis=-1))).numpy()
        xs, ys = xyp[:, 0], xyp[:, 1]
    else:
        xs, ys = locs[:, 0], locs[:, 1]
    ok = locs[:, 2] > 0.5
    ax.plot(xs[ok], ys[ok], 'go', markersize=4, label='converged')
    ax.plot(xs[~ok], ys[~ok], 'rx', markersize=5, label='failed')
    ax.legend()
    return ax
