"""``launches_per_kframe``: device operations (kernels, copies, fills) the
profiler saw in the timed window, per 1,000 frames the sweep point
counted: the host loop's and the streaming engine's launch cost."""


def read(ctx):
    w = ctx["trace"]
    if not w.kernels or not ctx["frames"]:
        return None
    return len(w.kernels) / (ctx["frames"] / 1000.0)
