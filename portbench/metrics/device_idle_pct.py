"""``device_idle_pct``: the share of the timed window in which no operation
ran on the card (the window's host-clock length less the union of the
device operations' intervals, over the length), in percent."""


def read(ctx):
    w = ctx["trace"]
    if not w.kernels:
        return None
    return 100.0 * (ctx["window_s"] - w.union_us() * 1e-6) / ctx["window_s"]
