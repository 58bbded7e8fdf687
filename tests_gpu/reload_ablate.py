"""Where K8's reload form spends its time: its stores taken away one group
at a time, beside the staged reload that replaced it on the XLA
super-step's passes.

Run from the repo root on a machine with one NVIDIA H100:

    python3 tests_gpu/reload_ablate.py [OUT.json]

It builds ``libldpc_tpu_torch/csrc/dev/reload_ablate.cu`` (the library's
draw, included whole, with a sink whose two store groups are run-time
switches; an ablated draw's results are wrong by design) into
``build/dev/``, and times, on the 1152 (3,6) code, BPSK at 2.0 dB, B =
16384, with 1,536 idle lanes spread over the batch (``chip_smoke.py``
phase 16's ``RELOAD_IDLE``; a burst of the sweep at 2.0 dB): the plan
(``reload_plan``) and then the draw into the state four ways: whole;
without the first messages' stores (``lv2c``); without the LLR and
codeword stores; without both.  Then the library's two forms on the same
lanes and key: into the state (``stream_reload``) and staged
(``stream_reload(..., stage=)``), each in the pool's draw tiling (the
ablated builds') and in the reload's (``reload_tables``, the one the
super-step runs).  Last, K2's one-pass launch (f32 BP, the form its size
rule picks) on a state with every lane in flight, with no starts and with
those lanes' staged starts pending, and each reload form followed by the
K2 launch that starts its lanes (the pass's two launches, as the
super-step runs them).  CUDA events span the device's work
alone (the card kept busy ahead of the start event), 20 runs each.  The
whole ablated draw must equal the library's form into the state.  One
``time`` line per case with the card's name and power limit; the JSON is
also written to ``OUT.json`` when given.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BATCH = 16384
IDLE = 1536
REPS = 20
#: (name, planes, messages): the store groups each build runs
CASES = (("whole", 1, 1), ("no_lv2c_stores", 1, 0), ("no_llr_cw_stores", 0, 1),
         ("no_stores", 0, 0))


def build_dev(build):
    out_dir = ROOT / "build" / "dev"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / "libreload_ablate.so"
    src = build.CSRC / "dev" / "reload_ablate.cu"
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out))


def event_ms(fn, setup):
    """Mean device ms of ``fn()`` over ``REPS`` runs, ``setup()`` before
    each (CUDA events; the card kept busy ahead of the start event)."""
    setup()
    fn()
    total = 0.0
    for _ in range(REPS):
        setup()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / REPS


def main() -> int:
    if not torch.cuda.is_available():
        print("reload_ablate: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from libldpc_tpu_torch.models import make_benchmark_code
    from libldpc_tpu_torch.ops.kernels import build
    from libldpc_tpu_torch.ops.kernels import pool_refill as pr
    from libldpc_tpu_torch.ops.kernels.decode_fused import _p
    from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
    from libldpc_tpu_torch.ops.sorted import to_sorted_device

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    lib = build.load()
    dev_lib = build_dev(build)
    dev_lib.ldpc_reload_ablate.argtypes = [ctypes.c_int, ctypes.c_int,
                                           *lib.ldpc_pool_reload.argtypes]
    dev_lib.ldpc_reload_ablate.restype = ctypes.c_int
    dev = torch.device("cuda")
    tb = kernel_tables(to_sorted_device(make_benchmark_code(1152, 3, 6, seed=0, with_G=True), dev))
    sdc = tb.code
    pt = pr.pool_tables(sdc, "AWGN")
    g = torch.Generator(device="cpu").manual_seed(3)
    idle_lanes = torch.randperm(BATCH, generator=g)[:IDLE].to(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    planes = dict(done=torch.zeros(BATCH, **i32), llr=torch.zeros((sdc.nc, BATCH), device=dev),
                  cw=torch.zeros((sdc.nc, BATCH), dtype=torch.uint8, device=dev),
                  lv2c=torch.zeros((sdc.nnz, BATCH), device=dev), age=torch.zeros(BATCH, **i32),
                  iters=torch.zeros(BATCH, **i32), started=torch.zeros(1, **i32))
    stage = pr.ReloadStage.empty(sdc.nc, BATCH, dev)
    refill = torch.ones(1, **i32)
    key = torch.tensor([99], dtype=torch.int64, device=dev)
    thr = BATCH // 16

    def reset():
        planes["done"].zero_()
        planes["done"][idle_lanes] = 1
        planes["started"].zero_()
        stage.slot.fill_(-1)

    def ablated(on_planes, on_messages):
        def run():
            count, lanes = pr.reload_plan(refill, planes["done"], planes["started"], 10**9, thr)
            head, tail = pr._draw_args(pt, 2.0, planes["llr"], BATCH, key)
            err = dev_lib.ldpc_reload_ablate(
                on_planes, on_messages, *head, _p(planes["llr"]), _p(planes["cw"]), _p(lanes),
                _p(count), _p(key), None, None, *tail, _p(planes["lv2c"]), _p(tb.vn_ptr),
                _p(tb.perm_c2v), _p(planes["done"]), _p(planes["age"]), _p(planes["iters"]),
                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
            if err:
                raise RuntimeError(f"ldpc_reload_ablate: error {err}")
        return run

    args = lambda: (refill, planes["done"], planes["llr"], planes["cw"], planes["lv2c"],  # noqa: E731
                    planes["age"], planes["iters"], planes["started"], 10**9, thr)
    into_state = lambda: pr.stream_reload(pt, None, 2.0, *args(), vn_ptr=tb.vn_ptr,  # noqa: E731
                                          perm_c2v=tb.perm_c2v, key=key)
    staged = lambda: pr.stream_reload(pt, None, 2.0, *args(), key=key, stage=stage)  # noqa: E731
    rt = pr.reload_tables(pt)
    into_state_rt = lambda: pr.stream_reload(rt, None, 2.0, *args(), vn_ptr=tb.vn_ptr,  # noqa: E731
                                             perm_c2v=tb.perm_c2v, key=key)
    staged_rt = lambda: pr.stream_reload(rt, None, 2.0, *args(), key=key, stage=stage)  # noqa: E731
    # the whole ablated draw against the library's form into the state
    outs = []
    for fn in (ablated(1, 1), into_state):
        for name in ("llr", "cw", "lv2c"):
            planes[name].zero_()
        reset()
        fn()
        outs.append([planes[name].clone() for name in ("llr", "cw", "lv2c", "done")])
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    result = {"card": card, "code": "bench1152", "channel": "BPSK 2.0 dB", "batch": BATCH,
              "granted": IDLE, "ablated_whole_equals_library": same, "ms": {}}
    plan_ms = event_ms(lambda: pr.reload_plan(refill, planes["done"], planes["started"], 10**9,
                                              thr), reset)
    result["ms"]["plan"] = plan_ms
    for name, on_planes, on_messages in CASES:
        result["ms"][name] = event_ms(ablated(on_planes, on_messages), reset)
    result["ms"]["library_into_state"] = event_ms(into_state, reset)
    result["ms"]["library_staged"] = event_ms(staged, reset)
    result["ms"]["library_into_state_reload_tiling"] = event_ms(into_state_rt, reset)
    result["ms"]["library_staged_reload_tiling"] = event_ms(staged_rt, reset)
    # K2's one-pass launch: every lane in flight after one pass from a
    # channel batch, then the IDLE lanes idle and reloaded
    from libldpc_tpu_torch.ops.kernels import decode_fused as df

    ch = pr.channel_batch(pt, None, BATCH, 2.0, key=key)
    k2 = dict(llr=ch.llr, cw=ch.codeword, lv2c=ch.llr.index_select(0, sdc.col_sorted).contiguous(),
              done=torch.zeros(BATCH, **i32), iters=torch.zeros(BATCH, **i32),
              age=torch.ones(BATCH, **i32), avail=torch.zeros(BATCH, **i32),
              ctr=torch.zeros((5, BATCH), **i32))
    zero = torch.zeros(1, **i32)

    def k2_pass(with_stage):
        df.bp_stream_chunk_fused(tb, k2["llr"], k2["cw"], k2["lv2c"], k2["done"], k2["iters"],
                                 k2["age"], k2["avail"], k2["ctr"], k2["llr"], k2["cw"], zero,
                                 zero, k=1, cap=50, minsum_mode="BP",
                                 stage=stage if with_stage else None)

    k2_pass(False)
    saved = {name: v.clone() for name, v in k2.items()}
    k2_args = lambda: (refill, k2["done"], k2["llr"], k2["cw"], k2["lv2c"], k2["age"],  # noqa: E731
                       k2["iters"], planes["started"], 10**9, thr)

    def restore(idle: bool):
        for name, v in saved.items():
            k2[name].copy_(v)
        if idle:
            k2["done"][idle_lanes] = 1
        reset()

    def restore_staged():
        restore(True)
        pr.stream_reload(rt, None, 2.0, *k2_args(), key=key, stage=stage)

    def reload_then_k2(staged):
        def run():
            pr.stream_reload(rt, None, 2.0, *k2_args(), vn_ptr=tb.vn_ptr, perm_c2v=tb.perm_c2v,
                             key=key, stage=stage if staged else None)
            k2_pass(staged)
        return run

    result["ms"]["k2_one_pass_no_starts"] = event_ms(lambda: k2_pass(False), lambda: restore(False))
    result["ms"]["k2_one_pass_staged_starts"] = event_ms(lambda: k2_pass(True), restore_staged)
    result["ms"]["reload_into_state_then_k2"] = event_ms(reload_then_k2(False),
                                                         lambda: restore(True))
    result["ms"]["reload_staged_then_k2"] = event_ms(reload_then_k2(True), lambda: restore(True))
    for name, ms in result["ms"].items():
        what = "K2 and the reload" if "k2" in name else "plan and draw"
        print(f"time reload bench1152 BPSK {IDLE} of {BATCH} lanes granted, {name}: {ms:.4f} ms "
              f"({what}; plan alone {plan_ms:.4f}) [{card}]", flush=True)
    text = json.dumps(result, indent=1)
    print(text)
    if len(sys.argv) > 1:
        out = pathlib.Path(sys.argv[1])
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(text + "\n")
    if not same:
        print("reload_ablate: the whole ablated draw differs from the library's", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
