#!/usr/bin/env python3
"""Closed-loop two-car race of the PyTorch/CUDA port (``dgsqp_torch``), the counterpart
of ``scripts/race_main.py``: two cars track the raceline with CA-LTV-MPC while a DGSQP
game planner computes interaction manoeuvres; writes ``race_summary.json``, the
trajectory plot and (optionally) a video.

Usage:
    python scripts/torch_race_main.py --steps 100 --out results/race_torch
    python scripts/torch_race_main.py --steps 50 --no-plot --out build/race
    python scripts/torch_race_main.py --device cpu --steps 2 --mpc_N 5 --game_N 5 --no-plot

The race runs on ``--device`` (default the card) in ``--dtype`` (default float64).
Without ``--no-plot`` the plot needs matplotlib, and a host without it fails: pass
``--no-plot`` there.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import argparse
import json
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--track', default='L_track_barc')
    ap.add_argument('--steps', type=int, default=100)
    ap.add_argument('--mpc_N', type=int, default=20)
    ap.add_argument('--game_N', type=int, default=20)
    ap.add_argument('--dt', type=float, default=0.1)
    ap.add_argument('--raceline_speed', type=float, default=1.5)
    ap.add_argument('--out', default='results/race_torch')
    ap.add_argument('--video', action='store_true', help='render an mp4/gif of the race')
    ap.add_argument('--fps', type=int, default=10)
    ap.add_argument('--no-plot', dest='plot', action='store_false',
                    help='write no plot (a host without matplotlib)')
    ap.add_argument('--dtype', default='float64', choices=['float32', 'float64'])
    ap.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    import torch

    from dgsqp_torch.harness.race import RaceConfig, RaceStack

    cfg = RaceConfig(track_name=args.track, control_dt=args.dt,
                     mpc_N=args.mpc_N, game_N=args.game_N,
                     n_steps=args.steps, raceline_speed=args.raceline_speed)
    stack = RaceStack(cfg, device=args.device, dtype=getattr(torch, args.dtype))
    t0 = time.time()
    history = stack.run()
    wall = time.time() - t0

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.plot:
        from dgsqp_torch.harness.plotting import plot_race_history
        plot_race_history(history, track=stack.track,
                          save_path=str(out / 'race_trajectories.png'))
    summary = {
        'steps': len(history),
        'wall_s': round(wall, 2),
        'steps_per_s': round(len(history) / wall, 3),
        'game_solves': len(stack.game_log),
        'final_s': [float(history[-1][car].p.s) for car in range(2)],
    }
    (out / 'race_summary.json').write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary))
    if args.video:
        from dgsqp_torch.harness.plotting import render_race_video
        path = render_race_video(history, stack.track, str(out / 'race.mp4'), fps=args.fps)
        print(f'video: {path}')


if __name__ == '__main__':
    main()
