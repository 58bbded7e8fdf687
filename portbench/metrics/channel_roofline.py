"""``channel_roofline``: the channel draw K8's share of its roofline, in
percent: the least time the card could take to draw the window's frames
(each frame's float32 LLRs and its codeword written once; 12 operations a
transmitted bit and the encode's word operations, ``portbench/roofline.py``) over the
device time of K8's kernels (its plans and its draws, by name)."""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from portbench import roofline  # noqa: E402

#: K8's kernels: the draw, the pool's plan and the reload's plan
K8 = ("pool_draw_kernel", "pool_plan_kernel", "reload_plan_kernel")


def read(ctx):
    t = ctx["trace"].device_us_of(lambda n: any(k in n for k in K8)) * 1e-6
    if t <= 0 or not ctx["frames_drawn"]:
        return None
    code = ctx["code"]
    n = ctx["frames_drawn"]
    least = roofline.least_seconds(n * roofline.draw_frame_ops(code.nc, code.kc, code.nct),
                                   n * roofline.draw_frame_bytes(code.nc))
    return 100.0 * least / t
