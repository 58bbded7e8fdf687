"""``lane_occupancy_pct``: the streaming engine's useful work over what it
launched, in percent: the iterations the window's counted frames took
(the sweep's ``iter_sum``) over the lane-passes the engine launched (the
program's counter ``stream.lane_passes``, passes x lanes of every streaming
super-step while traced, ``libldpc_tpu_torch/utils/profiling.py``).  A lane
that waits for a reload burst, or holds a staged frame for a pass, is a
lane-pass with no iteration.  A frame holds its lane for its iteration
count and one pass more (the pass that finds it decoded counts none), so a
lane never idle reads ``100 x avg_iter / (avg_iter + 1)``.  The point's
discarded warm-up super-step is inside the window: its passes count and it
counts no frame (~50 of ~13,000 passes in a 10 s window, under 0.5 %).
None where the counter is absent: a batch-stepped sweep, or a program
without it."""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

COUNTER = "stream.lane_passes"


def read(ctx):
    from libldpc_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    passes = counters().get(COUNTER, 0) if counters is not None else 0
    if not passes:
        return None
    return 100.0 * ctx["iter_sum"] / passes
