"""Round machine: the share (%) of the traced request in which the card was idle while
the host was inside the line search's merit evaluations (the harness's ``bench.merit``
span around ``merit_terms``): the grid of trial points over the games it takes."""


def read(ctx):
    idle = ctx['trace']['idle_by_host'].get('merit')
    return None if idle is None else 100.0 * idle / ctx['trace']['window_ns']
