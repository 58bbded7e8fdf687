"""``host_loop_idle_pct``: the share of the timed window in which the card
sat idle while the sweep's host loop was in one of its phases, in percent:
the device's idle time (the window less the union of the device
operations' intervals, as ``device_idle_pct`` reads it) that overlaps the
union of the program's ``ldpc.loop.*`` spans (dispatch, read, absorb, io:
``libldpc_tpu_torch/sim/driver.py``), by interval intersection, over the
window.  None where the window holds no such span (a program that opens
none)."""

PREFIX = "ldpc.loop."


def merged(intervals, lo, hi) -> list:
    """``intervals`` clipped to ``[lo, hi]``, sorted and merged."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(a, b) -> float:
    """The length common to two merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(ctx):
    w = ctx["trace"]
    loop = merged([(s, e) for n, s, e in w.host_ops if n.startswith(PREFIX)],
                  w.start_us, w.end_us)
    if not loop:
        return None
    busy = merged([(s, e) for _, s, e in w.kernels], w.start_us, w.end_us)
    idle_us = sum(e - s for s, e in loop) - overlap(loop, busy)
    return 100.0 * idle_us * 1e-6 / ctx["window_s"]
