#!/usr/bin/env python3
"""Aggregate a regularization sweep into (reg x decay) success-rate tables.

The counterpart of ``scripts/analyze_regularization.py``, on the JSON summaries that
``scripts/torch_monte_carlo_main.py`` writes beside its pickles (their names carry
``regR_decayD_EVAL``): one success-rate table per eval type on stdout, and
``regularization_summary.json`` in the study directory.

Usage:
    python scripts/torch_analyze_regularization.py STUDY_DIR
"""
import json
import re
import sys
from pathlib import Path

_NAME = re.compile(r'reg([0-9.]+)_decay([0-9.]+)_(once|always).*\.json$')


def collect(study_dir: Path) -> dict:
    """{(eval, reg, decay): summary} of the sweep's JSONs in ``study_dir``."""
    cells = {}
    for f in sorted(study_dir.glob('*.json')):
        m = _NAME.search(f.name)
        if not m:
            continue
        d = json.loads(f.read_text())
        cells[(m.group(3), float(m.group(1)), float(m.group(2)))] = dict(
            success_rate=d.get('success_rate'), solves_per_s=d.get('solves_per_s'),
            mean_iters=d.get('mean_iters'), status_counts=d.get('status_counts'))
    return cells


def tables(cells: dict) -> tuple:
    """(printed tables, summary by eval type)."""
    lines, out = [], {}
    for ev in ('once', 'always'):
        regs = sorted({r for (e, r, _) in cells if e == ev})
        decays = sorted({d for (e, _, d) in cells if e == ev})
        if not regs:
            continue
        lines.append(f'\n=== eval_type={ev}: success rate (rows reg, cols decay) ===')
        lines.append('reg\\decay ' + ' '.join(f'{d:>7g}' for d in decays))
        for r in regs:
            row = [cells.get((ev, r, d), {}).get('success_rate') for d in decays]
            lines.append(f'{r:>9g} ' + ' '.join('   --  ' if v is None else f'{v:7.3f}'
                                                 for v in row))
        out[ev] = {f'reg{r}_decay{d}': cells[(ev, r, d)]
                   for r in regs for d in decays if (ev, r, d) in cells}
    return '\n'.join(lines), out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    study_dir = Path(argv[0] if argv else 'results')
    cells = collect(study_dir)
    if not cells:
        print(f'no regularization-sweep JSONs under {study_dir}', file=sys.stderr)
        sys.exit(1)
    text, out = tables(cells)
    print(text)
    (study_dir / 'regularization_summary.json').write_text(json.dumps(out, indent=2))
    print(f'\nwrote {study_dir / "regularization_summary.json"}')


if __name__ == '__main__':
    main()
