"""Round machine: device kernels, memory copies and memory sets of the traced request,
per round it ran (one QP a round)."""


def read(ctx):
    rounds = ctx['requests'][0]['rounds']
    events = ctx['trace']['device_events']
    return events / rounds if rounds and events else None
