"""Game derivatives: the share (%) of the traced request in which the card was idle while
the host was inside the game's ``evaluate`` calls (the harness's ``bench.evaluate``
span): eager calls and captures of signatures the graph cache had not replayed yet."""


def read(ctx):
    idle = ctx['trace']['idle_by_host'].get('evaluate')
    return None if idle is None else 100.0 * idle / ctx['trace']['window_ns']
