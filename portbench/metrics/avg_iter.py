"""``avg_iter``: iterations a frame, the sweep's own counters over the
window (``iter_sum / frames``): what the schedule and the message form make
each frame cost."""


def read(ctx):
    if not ctx["frames"]:
        return None
    return ctx["iter_sum"] / ctx["frames"]
