"""The batch-stepped wifi 648 exact layered point's frames/s over a long
window, from any checkout of the port, for comparing two commits on one
card in one call.

    python3 tests_gpu/sweep_rates.py <root of a checkout> [reps]

It imports ``libldpc_tpu_torch`` from that root and runs the n=648
802.11n code on its exact layered schedule (K5) at 2.0 dB, ET, 50
iterations, B = 16384, seed 1, with no frame-error stop and ``max_frames``
48 batches (786,432 frames), in float32 BP and int8 BP_MS, ``reps`` times
each (default 3) after one warm run.  One ``rate`` line per run: the
``Simulator``'s own frames/s (its frame clock, as in the results file).
Run it on two trees in turns (parent, change, change, parent).
"""

import pathlib
import sys


def main() -> int:
    root = pathlib.Path(sys.argv[1]).resolve()
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    sys.path.insert(0, str(root))
    import torch

    from libldpc_tpu_torch.models import wifi_code
    from libldpc_tpu_torch.sim.driver import (
        ChannelParams, DecoderParams, SimulationParams, Simulator,
    )

    code = wifi_code(648)

    def sweep(dtype, form, batches):
        return Simulator(
            code, DecoderParams(iterations=50, layered=True, type=form, message_dtype=dtype),
            ChannelParams(seed=1, x_range=(2.0, 2.01, 1.0)),
            SimulationParams(batch_size=16384, fec=10**9, max_frames=batches * 16384),
            device=torch.device("cuda"), verbose=False, use_pallas=True,
        ).start()

    sweep("float32", "BP", 2)  # builds and loads the kernels
    for dtype, form in (("float32", "BP"), ("int8", "BP_MS")):
        for r in range(reps):
            res = sweep(dtype, form, 48)
            print(f"rate wifi648 layered {form} {dtype} ET 2.0 dB run {r}: "
                  f"{1.0 / res.time[0]:.0f} frames/s (avg_iter {res.avg_iter[0]:.3f}, FER "
                  f"{res.fer[0]:.3e}, {int(res.frames[0])} frames) [{root.name}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
