"""``decode_roofline``: the decode kernels' share of their roofline, in
percent: the least time the card could take for the window's decoding
(the frames decoded times the operations of a frame at the window's own
iterations a frame, the check combine, the variable sums and the
syndrome; each frame's LLRs read and its counts written once,
``portbench/roofline.py``) over the device time of the decode kernels
(``bp_*_kernel`` and ``bec_*_kernel``, by name)."""

import pathlib
import re
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from portbench import roofline  # noqa: E402

DECODE = re.compile(r"\b(bp|bec)_\w*_kernel")


def read(ctx):
    t = ctx["trace"].device_us_of(lambda n: DECODE.search(n) is not None) * 1e-6
    if t <= 0 or not ctx["frames"]:
        return None
    code = ctx["code"]
    n = ctx["frames_drawn"]
    avg = ctx["iter_sum"] / ctx["frames"]
    minsum = ctx["config"]["decoding"] in ("BP_MS", "BP_NMS", "BP_OMS")
    ops = n * roofline.decode_frame_ops(code.nc, code.nnz, code.cn_classes(), avg, minsum)
    least = roofline.least_seconds(ops, n * roofline.decode_frame_bytes(code.nc))
    return 100.0 * least / t
