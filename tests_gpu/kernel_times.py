"""Device times of the flooding and fast layered kernels (K1-K4) and of the
BEC streaming kernel (K7) from any checkout of the port, for comparing two
commits on one card in one call.

    python3 tests_gpu/kernel_times.py <root of a checkout>

It imports ``libldpc_tpu_torch`` from that root and times, with CUDA
events at B = 16384, each kernel in the form its size rule picks: K1 on the
1152 (3,6) code and K3 on the 802.11n n=1944 code, 50 iterations without
early termination; K2 (1152) and K4 (n=1944), 6 passes from a full pool;
each in float32 BP, bfloat16 BP and int8 BP_MS, at 1.5 dB (the inputs of
``chip_smoke.py`` phase 10); K7 on both codes, 6 passes from a full pool
at erasure rate 0.40, in its word form and its byte form
(``decode_bec.FORCE_BYTES``), or in the byte form alone on a tree that has
no word form.  One ``time`` line per kernel and form, with the card's name
and power limit.  Run it on two trees in turns (parent, change, change,
parent).
"""

import pathlib
import subprocess
import sys

BATCH, ITERS = 16384, 50
FORMS = (("float32", "BP"), ("bfloat16", "BP"), ("int8", "BP_MS"))


def cuda_ms(torch, fn, reps, setup=None):
    """Mean device time of ``fn()`` over ``reps`` runs after one warm-up;
    ``setup()`` runs before each, outside the timing."""
    total = 0.0
    for i in range(reps + 1):
        if setup:
            setup()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end) if i else 0.0
    return total / reps


def main() -> int:
    root = pathlib.Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    import torch

    from libldpc_tpu_torch.models import make_benchmark_code, wifi_code
    from libldpc_tpu_torch.ops.channel import awgn_channel, bec_channel, make_generator
    from libldpc_tpu_torch.ops.kernels import decode_bec as db
    from libldpc_tpu_torch.ops.kernels import decode_fused as df
    from libldpc_tpu_torch.ops.kernels import decode_layered as dl
    from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
    from libldpc_tpu_torch.ops.sorted import to_sorted_device
    from libldpc_tpu_torch.ops.streaming_fused import init_state

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    dev = torch.device("cuda")
    tables = {key: kernel_tables(to_sorted_device(code, dev, with_layers=True)) for key, code in (
        ("bench1152", make_benchmark_code(1152, 3, 6, seed=0, with_G=True)),
        ("wifi1944", wifi_code(1944)))}
    ch = {key: awgn_channel(tb.code, make_generator(dev, 7, 2, 0), BATCH, 1.5)
          for key, tb in tables.items()}

    def chunk_ms(kernel, key, form, dtype):
        tb, box = tables[key], {}

        def reset():
            st = init_state(tb, BATCH, message_dtype=dtype)
            st.fresh_llr.copy_(ch[key].llr)
            st.fresh_cw.copy_(ch[key].codeword)
            st.avail.fill_(1)
            box["st"], box["rem"] = st, torch.full((1,), BATCH, dtype=torch.int32, device=dev)

        def run():
            st = box["st"]
            kernel(tb, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail,
                   st.ctr, st.fresh_llr, st.fresh_cw, torch.ones(1, dtype=torch.int32, device=dev),
                   box["rem"], k=6, cap=ITERS, minsum_mode=form, message_dtype=dtype)

        return cuda_ms(torch, run, 5, reset)

    for dtype, form in FORMS:
        for tag, key, ms in (
                ("K1", "bench1152", cuda_ms(torch, lambda: df.bp_decode_fused(
                    tables["bench1152"], ch["bench1152"].llr, ITERS, False, form, dtype), 5)),
                ("K3", "wifi1944", cuda_ms(torch, lambda: dl.bp_decode_layered_fast(
                    tables["wifi1944"], ch["wifi1944"].llr, ITERS, False, form, dtype), 5)),
                ("K2", "bench1152", chunk_ms(df.bp_stream_chunk_fused, "bench1152", form, dtype)),
                ("K4", "wifi1944", chunk_ms(dl.bp_stream_chunk_layered_fast, "wifi1944", form,
                                            dtype))):
            print(f"time {tag} {key} {dtype} {form} B={BATCH}: {ms:.3f} ms [{card}]", flush=True)

    def k7_ms(key, ch_bec):
        tb, box = tables[key], {}

        def reset():
            st = init_state(tb, BATCH, "BEC")
            st.fresh_llr.copy_(ch_bec.llr)
            st.fresh_cw.copy_(ch_bec.codeword)
            st.avail.fill_(1)
            box["st"], box["rem"] = st, torch.full((1,), BATCH, dtype=torch.int32, device=dev)

        def run():
            st = box["st"]
            db.bec_stream_chunk_fused(
                tb, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail, st.ctr,
                st.fresh_llr, st.fresh_cw, torch.ones(1, dtype=torch.int32, device=dev),
                box["rem"], k=6, cap=ITERS)

        return cuda_ms(torch, run, 5, reset)

    word_form = hasattr(db, "FORCE_BYTES")
    for key, tb in tables.items():
        ch_bec = bec_channel(tb.code, make_generator(dev, 8, 3, 0), BATCH, 0.40)
        for form in ("words", "bytes") if word_form else ("bytes",):
            if word_form:
                db.FORCE_BYTES = form == "bytes"
            ms = k7_ms(key, ch_bec)
            if word_form:
                db.FORCE_BYTES = False
            print(f"time K7 {key} {form} BEC eps 0.40 6 passes B={BATCH}: {ms:.3f} ms [{card}]",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
