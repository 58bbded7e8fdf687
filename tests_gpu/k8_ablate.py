"""Where K8's draw spends its time, by taking its phases away one at a time.

Run from the repo root on a machine with one NVIDIA H100:

    python3 tests_gpu/k8_ablate.py

It copies ``libldpc_tpu_torch/csrc`` into ``build/ablate/<name>/``, edits
the draw kernel of each copy (``csrc/pool_refill.cu``) so that one phase
does no work (its results are then wrong: these builds are for timing
only), builds each copy into a library of its own and times K8's full
batch (``channel_batch``) on the 1152 (3,6) code, B = 16384, for the BEC at
0.40 and BPSK at 2.0 dB, with CUDA events spanning the device's work alone
(the card kept busy ahead of the start event).  The phases taken away:

* ``no_info``: the info words are not drawn and the generator tiles not
  staged (the encode reads what shared memory holds);
* ``no_encode``: no tensor-core encode (the codeword bits are what shared
  memory holds);
* ``no_draws``: no Philox call or normal / uniform transform (constant
  draws);
* ``no_stores``: the values and codewords are formed but not stored.

One ``time`` line per build and channel, with the card's name and power
limit; the full design first.
"""

from __future__ import annotations

import pathlib
import shutil
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

#: (name, [(text in pool_refill.cu, its replacement)])
ABLATIONS = (
    ("full", []),
    ("no_info", [("if (lane >= 0 && 4 * q < p.kwords) {", "if (lane >= 0 && 4 * q < p.kwords && p.M < 0) {"),
                 ("for (int i = tid; i < n16; i += kDrawThreads)",
                  "for (int i = tid; i < n16 && p.M < 0; i += kDrawThreads)")]),
    ("no_encode", [("for (int j = jt0 + warp / mt; j < jt1; j += wpm) {",
                    "for (int j = jt0 + warp / mt; j < jt1 && p.M < 0; j += wpm) {")]),
    ("no_draws", [("curand_init(seed, b, (unsigned long long)p.kw + 4ull * grp, &st);", ""),
                  ("r4 = curand_normal4(&st);", "r4 = make_float4(0.3f, -0.5f, 0.1f, 0.9f);"),
                  ("r4 = curand_uniform4(&st);", "r4 = make_float4(0.3f, 0.5f, 0.1f, 0.9f);")]),
    ("no_stores", [("((float*)d.fresh)[v * B + b] = (2.0f * y) * d.inv_s2;",
                    "if (p.M < 0) ((float*)d.fresh)[v * B + b] = (2.0f * y) * d.inv_s2;"),
                   ("((uint8_t*)d.fresh)[v * B + b] = r < d.eps ? kErasedSym : (uint8_t)c;",
                    "if (p.M < 0) ((uint8_t*)d.fresh)[v * B + b] = r < d.eps ? kErasedSym : (uint8_t)c;"),
                   ("    d.fresh_cw[v * B + b] = (uint8_t)c;\n  }\n}",
                    "    if (p.M < 0) d.fresh_cw[v * B + b] = (uint8_t)c;\n  }\n}")]),
)


def main() -> int:
    if not torch.cuda.is_available():
        print("k8_ablate: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from libldpc_tpu_torch.models import make_benchmark_code
    from libldpc_tpu_torch.ops import channel
    from libldpc_tpu_torch.ops.kernels import build
    from libldpc_tpu_torch.ops.kernels import pool_refill as pr
    from libldpc_tpu_torch.ops.sorted import to_sorted_device

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    dev = torch.device("cuda")
    sdc = to_sorted_device(make_benchmark_code(1152, 3, 6, seed=0, with_G=True), dev)
    key = pr.draw_keys(channel.make_generator(dev, 1), 1, dev)
    pools = {name: pr.pool_tables(sdc, ch, None) for name, ch in (("BEC", "BEC"), ("BPSK", "AWGN"))}
    x_of = {"BEC": 0.40, "BPSK": 2.0}
    original = (build.CSRC / "pool_refill.cu").read_text()
    for name, edits in ABLATIONS:
        src_dir = ROOT / "build" / "ablate" / name / "csrc"
        shutil.rmtree(src_dir.parent, ignore_errors=True)
        shutil.copytree(build.CSRC, src_dir)
        text = original
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in pool_refill.cu")
            text = text.replace(old, new)
        (src_dir / "pool_refill.cu").write_text(text)
        build.CSRC, build.BUILD_DIR, build._lib = src_dir, src_dir.parent / "kernels", None
        t0 = time.perf_counter()
        build.load()
        built = time.perf_counter() - t0
        for kind, pt in pools.items():
            fn = lambda: pr.channel_batch(pt, None, 16384, x_of[kind], key=key)  # noqa: E731
            fn()
            total = 0.0
            for _ in range(20):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                torch.cuda.synchronize()
                torch.cuda._sleep(2_000_000)
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
                total += start.elapsed_time(end)
            print(f"time K8 full batch bench1152 {kind} 16384 frames, {name}: {total / 20:.4f} ms "
                  f"(built in {built:.0f} s) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
