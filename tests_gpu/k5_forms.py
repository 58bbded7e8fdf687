"""Every form of the exact layered kernel (K5) on the 802.11n n=1296 and
n=1944 codes, held against the plain version and timed, from any checkout
of the port, for choosing its size rule and comparing two commits on one
card in one call.

    python3 tests_gpu/k5_forms.py <root of a checkout> [OUT.json] [--codes wifi1944,qc4800,...] [--plain]

It imports ``libldpc_tpu_torch`` from that root.  Each form that fits a
block's shared memory is forced in turn (``decode_layered.EXACT_FORM_OVERRIDE``:
the tiles of 16, 8 and 4 frames a block, tables staged or not, and the
plane form, ``(0, False)``; on a tree with ``EXACT_PLANE_OVERRIDE``, the
plane form's earlier design, with the posterior of 16 or 8 frames on chip,
staged or not, and in device memory).  First each form decodes B = 1000 frames
(no multiple of 16) at 1.5 dB, 12 iterations, early termination on and
off, against ``bp_decode_layered_plain``: the min-sum family bit-exact, BP
in decisions and iteration counts on >= 99.9 % of frames.  Then every form
is timed with CUDA events at B = 16384, 50 iterations without early
termination (the inputs of ``chip_smoke.py`` phase 10), in turns (the forms,
then the forms reversed; the mean of the two), in float32 BP, float32
BP_MS, bfloat16 BP and int8 BP_MS.  One ``time`` line per code and message
form with the card's name and power limit, the rule's form and the
fastest; the JSON (with OUT.json) holds every time.  ``--codes`` limits
the run to some of the two codes; ``--plain`` also times the plain version
once per code and message form on the same inputs.  A code ``qcN`` is
the (3,6)-regular QC code of N variables in 50 columns of circulants
(``make_qc_benchmark_code(N, N // 50)``, one layer per base row: 25
layers), timed only in the message forms where no tile fits it, which
run the plane form.
"""

import json
import pathlib
import subprocess
import sys

BATCH, ITERS = 16384, 50
CHECK_B, CHECK_ITERS = 1000, 12
CASES = (("float32", "BP"), ("float32", "BP_MS"), ("bfloat16", "BP"), ("int8", "BP_MS"))


def cuda_ms(torch, fn):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def main() -> int:
    args = sys.argv[1:]
    plain = "--plain" in args
    if plain:
        args.remove("--plain")
    keys = ("wifi1296", "wifi1944")
    if "--codes" in args:
        i = args.index("--codes")
        keys = tuple(args[i + 1].split(","))
        del args[i:i + 2]
    root = pathlib.Path(args[0]).resolve()
    out = pathlib.Path(args[1]) if len(args) > 1 else None
    sys.path.insert(0, str(root))
    import torch

    from libldpc_tpu_torch.models import make_qc_benchmark_code, qc_natural_layers, wifi_code
    from libldpc_tpu_torch.ops.channel import awgn_channel, make_generator
    from libldpc_tpu_torch.ops.kernels import decode_layered as dl
    from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
    from libldpc_tpu_torch.ops.sorted import to_sorted_device

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    dev = torch.device("cuda")
    planes = hasattr(dl, "EXACT_PLANE_OVERRIDE")

    def forms_of(tb, dtype):
        """(label, tile override, plane override) of every form that fits."""
        forms = [(f"tile {f}{' staged' if s else ''}", (f, s), None)
                 for f in dl.EXACT_TILE_FRAMES for s in (True, False)
                 if dl.exact_tile_bytes(tb, f, dtype, s) <= dl.SMEM_BLOCK_BYTES]
        if not planes:
            return forms + [("plane", (0, False), None)]
        forms += [(f"plane, posterior of {f} on chip{' staged' if s else ''}", (0, False), (f, s))
                  for f in dl.EXACT_PLANE_FRAMES for s in (True, False)
                  if dl.exact_plane_bytes(tb, f, dtype, s) <= dl.SMEM_BLOCK_BYTES]
        return forms + [("plane, posterior in device memory", (0, False), (0, False))]

    def forced(tile, plane, fn):
        dl.EXACT_FORM_OVERRIDE = tile
        if planes:
            dl.EXACT_PLANE_OVERRIDE = plane
        try:
            return fn()
        finally:
            dl.EXACT_FORM_OVERRIDE = None
            if planes:
                dl.EXACT_PLANE_OVERRIDE = None

    def rule_label(tb, dtype):
        tile = dl.exact_form(tb, dtype)
        if tile[0] or not planes:
            return next(lbl for lbl, t, _ in forms_of(tb, dtype) if t == tile)
        plane = dl.exact_plane_form(tb, dtype)
        return next(lbl for lbl, t, p in forms_of(tb, dtype) if t == tile and p == plane)

    def code_of(key):
        if key.startswith("wifi"):
            return wifi_code(int(key[4:]))
        code = make_qc_benchmark_code(int(key[2:]), int(key[2:]) // 50, seed=0)
        qc_natural_layers(code)
        return code

    record = {"card": card, "root": str(root), "times": {}, "checks": {}}
    for key in keys:
        tb = kernel_tables(to_sorted_device(code_of(key), dev, with_layers=True))
        small = awgn_channel(tb.code, make_generator(dev, 7, 3, 0), CHECK_B, 1.5).llr
        llr = awgn_channel(tb.code, make_generator(dev, 7, 2, 0), BATCH, 1.5).llr
        for dtype, form in CASES:
            if key.startswith("qc") and dl.exact_form(tb, dtype)[0]:
                continue
            forms = forms_of(tb, dtype)
            for et in (True, False):
                want = dl.bp_decode_layered_plain(tb, small, CHECK_ITERS, et, form, dtype)
                for label, tile, plane in forms:
                    got = forced(tile, plane, lambda: dl.bp_decode_layered(
                        tb, small, CHECK_ITERS, et, form, dtype))
                    torch.cuda.synchronize()
                    same = (got.hard == want.hard).all(0) & (got.iterations == want.iterations)
                    agree = same.float().mean().item()
                    exact = (bool(same.all()) and torch.equal(got.llr_out, want.llr_out)
                             and torch.equal(got.is_codeword, want.is_codeword))
                    ok = agree >= 0.999 if form == "BP" else exact
                    record["checks"][f"{key} {dtype} {form} et={int(et)} {label}"] = {
                        "agree": agree, "bit_exact": exact, "ok": ok}
                    print(f"check {key} {dtype} {form} et={int(et)} {label}: frames agreeing "
                          f"{agree:.6f} bit-exact {exact}", flush=True)
                    if not ok:
                        raise SystemExit(f"{key} {dtype} {form} {label} disagrees with plain")
            ms = dict.fromkeys((lbl for lbl, _, _ in forms), 0.0)
            for label, tile, plane in forms:  # warm-up
                forced(tile, plane, lambda: dl.bp_decode_layered(tb, llr, ITERS, False, form,
                                                                 dtype))
            for label, tile, plane in forms + forms[::-1]:
                ms[label] += forced(tile, plane, lambda: cuda_ms(torch, lambda: (
                    dl.bp_decode_layered(tb, llr, ITERS, False, form, dtype)))) / 2
            rule = rule_label(tb, dtype)
            fastest = min(ms, key=ms.get)
            record["times"][f"{key} {dtype} {form}"] = {"ms": ms, "rule": rule,
                                                        "fastest": fastest}
            if plain:
                plain_ms = cuda_ms(torch, lambda: dl.bp_decode_layered_plain(
                    tb, llr, ITERS, False, form, dtype))
                record["times"][f"{key} {dtype} {form}"]["plain_ms"] = plain_ms
                print(f"time K5 plain {key} {dtype} {form} {ITERS} it no-ET B={BATCH}: "
                      f"{plain_ms:.3f} ms [{card}]", flush=True)
            print(f"time K5 forms {key} {dtype} {form} {ITERS} it no-ET B={BATCH} (the rule's: "
                  f"{rule} {ms[rule]:.3f} ms, {ms[rule] / ms[fastest] - 1:+.2%} on the fastest: "
                  f"{fastest}): {'; '.join(f'{k} {v:.3f} ms' for k, v in ms.items())} [{card}]",
                  flush=True)
    if out:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
