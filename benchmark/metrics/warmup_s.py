"""Set-up: seconds from the solver's construction to the end of the warm-up slice
(the kernels' first use, and their build where the checkout has none yet)."""


def read(ctx):
    return ctx['warmup_s']
