"""Device: the share (%) of the traced request in which no kernel, memory copy or
memory set ran (1 minus the union of their intervals over the request's span)."""


def read(ctx):
    tr = ctx['trace']
    if not tr['busy_ns']:
        return None
    return 100.0 * (1.0 - tr['busy_ns'] / tr['window_ns'])
