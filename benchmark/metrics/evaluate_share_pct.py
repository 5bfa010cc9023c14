"""Game derivatives: the share (%) of the traced request's wall time the host spent
inside the game's ``evaluate`` calls."""


def read(ctx):
    r = ctx['requests'][0]
    return 100.0 * r['eval_s'] / (r['t1'] - r['t0'])
