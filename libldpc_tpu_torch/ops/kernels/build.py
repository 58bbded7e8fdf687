"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

``libldpc_tpu_torch/csrc/*.cu`` is compiled at first use into one shared
library with a plain C interface (no PyTorch headers), under
``build/kernels/`` at the root of the checkout: one ``nvcc -c`` per source,
all started together, then one link.  Each kernel has a source file of its
own (the templates they share are ``*.cuh``), so the build takes as long as
its slowest kernel.  The file
name carries a hash of the sources (headers included) and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.  Nothing
is built when a module is imported.  A missing ``nvcc`` or a failed build
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"

#: ``-fmad=false``: no FMA contraction, so every multiply and add rounds on
#: its own, as in the plain PyTorch versions (the NMS scale and the BP_LIN
#: line would otherwise differ in the last bit).  No ``--use_fast_math``.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
#: The last build's command and compiler output (``-Xptxas -v`` register
#: and spill report), for the smoke run to print; None if loaded from cache.
last_build_log = None


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built from libldpc_tpu_torch/csrc at first use"
        )
    return nvcc


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libldpc_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; their output, each after its command
    and the seconds it took, or a RuntimeError with the compiler's output
    of every one that failed."""
    done = [None] * len(cmds)

    def run(i: int) -> None:
        t0 = time.perf_counter()
        proc = subprocess.run(cmds[i], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        done[i] = (proc.returncode, proc.stdout, time.perf_counter() - t0)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(cmds))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = [f"nvcc failed ({rc}): {' '.join(c)}\n{o}" for c, (rc, o, _) in zip(cmds, done) if rc]
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(f"{' '.join(c)}\n# {secs:.1f} s\n{o}" for c, (_, o, secs) in zip(cmds, done))


def build() -> pathlib.Path:
    """Compile the kernels unless this source hash is already built."""
    global last_build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"tmp{os.getpid()}"
    objs = []
    compiles = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        objs.append(obj)
        compiles.append([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
    tmp = out.with_suffix(f".{tag}.so")
    try:
        log = _run(compiles)
        log += _run([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                      "-o", str(tmp), *map(str, objs)]])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    last_build_log = log
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with every entry point's
    ``argtypes`` and ``restype`` declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.ldpc_bp_decode_fused.argtypes = [
                P, P, P, P, P, P,  # llr_in post iters iscw lv2c lc2v
                P, P, P, P,  # row_ptr col_sorted vn_ptr perm_c2v
                I, I, I, I,  # nc mc nnz B
                I, I, I, F, F,  # iterations early_term cn_mode scale offset
                I, F,  # msg_dtype inv_q
                P,  # stream
            ]
            lib.ldpc_bp_decode_fused.restype = I
            # its tile form: one entry per frames-a-block, the arguments
            # without the lv2c and lc2v scratch, plus `stage`
            for entry in (lib.ldpc_bp_decode_fused_tile16, lib.ldpc_bp_decode_fused_tile8,
                          lib.ldpc_bp_decode_fused_tile4):
                entry.argtypes = [
                    P, P, P, P,  # llr_in post iters iscw
                    P, P, P, P,  # row_ptr col_sorted vn_ptr perm_c2v
                    I, I, I, I,  # nc mc nnz B
                    I, I, I, F, F,  # iterations early_term cn_mode scale offset
                    I, F,  # msg_dtype inv_q
                    I,  # stage
                    P,  # stream
                ]
                entry.restype = I
            lib.ldpc_bp_stream_chunk_fused.argtypes = [
                P, P, P,  # llr cw lv2c
                P, P, P, P, P,  # done iters age avail ctr
                P, P, P, P, P,  # fresh_llr fresh_cw refill remaining grant
                P, P, P, I,  # slot stage_llr stage_cw S
                P, P,  # lc2v llr_post (scratch)
                P, P, P, P, P,  # row_ptr col_sorted vn_ptr perm_c2v bit_pos
                I, I, I, I, I,  # nc mc nnz nct B
                I, I, I, F, F,  # k cap cn_mode scale offset
                I, F,  # msg_dtype inv_q
                P,  # stream
            ]
            lib.ldpc_bp_stream_chunk_fused.restype = I
            # its tile form: one entry per frames-a-block, the arguments of
            # the HBM-plane form without its scratch, plus `stage`
            for entry in (lib.ldpc_bp_stream_chunk_tile16, lib.ldpc_bp_stream_chunk_tile8,
                          lib.ldpc_bp_stream_chunk_tile4):
                entry.argtypes = [
                    P, P, P,  # llr cw lv2c
                    P, P, P, P, P,  # done iters age avail ctr
                    P, P, P, P, P,  # fresh_llr fresh_cw refill remaining grant
                    P, P, P, I,  # slot stage_llr stage_cw S
                    P, P, P, P, P,  # row_ptr col_sorted vn_ptr perm_c2v bit_pos
                    I, I, I, I, I,  # nc mc nnz nct B
                    I, I, I, F, F,  # k cap cn_mode scale offset
                    I, F,  # msg_dtype inv_q
                    I,  # stage
                    P,  # stream
                ]
                entry.restype = I
            tables = [P, P, P, P, P, P]  # row_ptr col_sorted vn_ptr perm_c2v layer_ptr layer_checks
            lib.ldpc_bp_decode_layered_fast.argtypes = [
                P, P, P, P, P,  # llr_in app iters iscw lc2v
                *tables,
                I, I, I, I, I,  # nc mc nnz nl B
                I, I, I, F, F,  # iterations early_term cn_mode scale offset
                I, F,  # msg_dtype inv_q
                P,  # stream
            ]
            lib.ldpc_bp_decode_layered_fast.restype = I
            # its tile form, one entry per frames-a-block, plus nlc and `stage`
            for entry in (lib.ldpc_bp_decode_layered_fast_tile16,
                          lib.ldpc_bp_decode_layered_fast_tile8):
                entry.argtypes = [
                    P, P, P, P, P,  # llr_in app iters iscw lc2v
                    *tables,
                    I, I, I, I, I, I,  # nc mc nnz nl nlc B
                    I, I, I, F, F,  # iterations early_term cn_mode scale offset
                    I, F,  # msg_dtype inv_q
                    I,  # stage
                    P,  # stream
                ]
                entry.restype = I
            # the layered streaming kernel: one entry per form (16 or 8
            # frames a block on the tile form, the HBM-plane form)
            for entry in (lib.ldpc_bp_stream_chunk_layered_tile16,
                          lib.ldpc_bp_stream_chunk_layered_tile8,
                          lib.ldpc_bp_stream_chunk_layered_hbm):
                entry.argtypes = [
                    P, P, P,  # app cw lc2v
                    P, P, P, P, P,  # done iters age avail ctr
                    P, P, P, P, P,  # fresh_llr fresh_cw refill remaining grant
                    *tables, P,  # ..., bit_pos
                    I, I, I, I, I, I, I,  # nc mc nnz nl nlc nct B
                    I, I, I, F, F,  # k cap cn_mode scale offset
                    I, F,  # msg_dtype inv_q
                    I,  # stage
                    P,  # stream
                ]
                entry.restype = I
            # the exact layered kernel: the plane form (lc2v, the posterior
            # and the packed decisions in device memory) and the tile form,
            # one entry per frames-a-block; both take each layer's variables
            # (CSR), the tiles all eight tables 16-bit in one buffer
            lib.ldpc_bp_decode_layered.argtypes = [
                P, P, P, P, P, P,  # llr_in post iters iscw lc2v hard_scratch
                *tables, P, P,  # ..., layer_var_ptr layer_vars
                I, I, I, I, I, I, I,  # nc mc nnz nl nlc nlv B
                I, I, I, F, F,  # iterations early_term cn_mode scale offset
                I, F,  # msg_dtype inv_q
                P,  # stream
            ]
            lib.ldpc_bp_decode_layered.restype = I
            for entry in (lib.ldpc_bp_decode_layered_tile16, lib.ldpc_bp_decode_layered_tile8,
                          lib.ldpc_bp_decode_layered_tile4):
                entry.argtypes = [
                    P, P, P, P,  # llr_in post iters iscw
                    P,  # tables16 (KernelTables.exact16)
                    I, I, I, I, I, I, I,  # nc mc nnz nl nlc nlv B
                    I, I, I, F, F,  # iterations early_term cn_mode scale offset
                    I, F,  # msg_dtype inv_q
                    I, I,  # stage priors
                    P,  # stream
                ]
                entry.restype = I
            lib.ldpc_bec_decode_fused.argtypes = [
                P, P, P, P, P, P, P,  # sym_in cw sym_out hard iters resolved scratch (or null)
                P, P, P, P,  # row_ptr col_sorted vn_ptr perm_c2v
                I, I, I, I,  # nc mc nnz B
                I, I, I,  # iterations early_term stale
                P,  # stream
            ]
            lib.ldpc_bec_decode_fused.restype = I
            lib.ldpc_bec_stream_chunk_fused.argtypes = [
                P, P, P,  # sym cw lv2c
                P, P, P, P, P,  # done iters age avail ctr
                P, P, P, P, P,  # fresh_sym fresh_cw refill remaining grant
                P, P,  # lc2v post (scratch)
                P, P, P, P, P,  # row_ptr col_sorted vn_ptr perm_c2v bit_pos
                I, I, I, I, I,  # nc mc nnz nct B
                I, I, I,  # k cap stale
                P,  # stream
            ]
            lib.ldpc_bec_stream_chunk_fused.restype = I
            lib.ldpc_bec_stream_chunk_words.argtypes = [
                P, P, P,  # sym cw lv2c
                P, P, P, P, P,  # done iters age avail ctr
                P, P, P, P, P,  # fresh_sym fresh_cw refill remaining grant
                P, P, P, P, P,  # row_ptr col_sorted vn_ptr perm_c2v bit_pos
                I, I, I, I, I,  # nc mc nnz nct B
                I, I, I,  # k cap stale
                P,  # stream
            ]
            lib.ldpc_bec_stream_chunk_words.restype = I
            # K8, the channel draw (the refill's plan; the draw over listed
            # lanes or a full batch), and the streaming chunks' grants in
            # lane order
            L = ctypes.c_longlong
            lib.ldpc_pool_plan.argtypes = [
                P, P, P, L,  # avail ctr started quota
                P, I, I,  # refill watermark B
                P, P, P,  # ctl remaining lanes
                P,  # stream
            ]
            lib.ldpc_pool_plan.restype = I
            lib.ldpc_pool_draw.argtypes = [
                I, P, P, P, I, I, I,  # channel gtiles slab_tile0 col_src ksteps kwords kw
                P, P, I, I,  # item_src item_dst n_items bpi
                P, P, I, I,  # other_pos other_short n_other other_col0
                P, P, P, P, I,  # points logp label_of point_of M
                I, I, I, I,  # lane_tile items_per_slab others_per_slab slab_cols
                P, P, P, P, P, P, P, P,  # fresh fresh_cw avail lanes count key debug debug_info
                I, F, F, F, F, F, F,  # B sigma inv_s2 two_s2 delta eps shorten
                P,  # stream
            ]
            lib.ldpc_pool_draw.restype = I
            lib.ldpc_reload_plan.argtypes = [P, P, P, L, I, I, P, P, P]  # done refill started quota gen_threshold B count lanes stream
            lib.ldpc_reload_plan.restype = I
            lib.ldpc_pool_reload.argtypes = [
                I, P, P, P, I, I, I,  # channel gtiles slab_tile0 col_src ksteps kwords kw
                P, P, I, I,  # item_src item_dst n_items bpi
                P, P, I, I,  # other_pos other_short n_other other_col0
                P, P, P, P, I,  # points logp label_of point_of M
                I, I, I, I,  # lane_tile items_per_slab others_per_slab slab_cols
                P, P, P, P, P, P, P,  # llr cw lanes count key debug debug_info
                I, F, F, F, F, F, F,  # B sigma inv_s2 two_s2 delta eps shorten
                P, P, P, P, P, P,  # lv2c vn_ptr perm_c2v done age iters
                P,  # stream
            ]
            lib.ldpc_pool_reload.restype = I
            lib.ldpc_pool_reload_staged.argtypes = [
                I, P, P, P, I, I, I,  # channel gtiles slab_tile0 col_src ksteps kwords kw
                P, P, I, I,  # item_src item_dst n_items bpi
                P, P, I, I,  # other_pos other_short n_other other_col0
                P, P, P, P, I,  # points logp label_of point_of M
                I, I, I, I,  # lane_tile items_per_slab others_per_slab slab_cols
                P, P, I,  # stage_llr stage_cw S
                P, P, P, P, P,  # lanes count key debug debug_info
                I, F, F, F, F, F, F,  # B sigma inv_s2 two_s2 delta eps shorten
                P, P, P, P,  # slot done age iters
                P,  # stream
            ]
            lib.ldpc_pool_reload_staged.restype = I
            lib.ldpc_pool_draw_bytes.argtypes = [I, I, I, I]  # ksteps has_g lane_tile slab_cols
            lib.ldpc_pool_draw_bytes.restype = L
            lib.ldpc_stream_grant.argtypes = [P, P, P, P, P, I, P]  # done avail refill remaining grant B stream
            lib.ldpc_stream_grant.restype = I
            # the shared memory of the tile forms of K1 and K2, K3 and K4, and
            # K5, for the card tests to hold the size rules' byte counts to
            lib.ldpc_flood_tile_bytes.argtypes = [I] * 6  # nc mc nnz frames msg stage
            lib.ldpc_flood_tile_bytes.restype = ctypes.c_longlong
            lib.ldpc_fast_tile_bytes.argtypes = [I] * 7  # nc mc nnz nl nlc frames stage
            lib.ldpc_fast_tile_bytes.restype = ctypes.c_longlong
            # nc mc nnz nl nlc nlv frames msg stage priors
            lib.ldpc_exact_tile_bytes.argtypes = [I] * 10
            lib.ldpc_exact_tile_bytes.restype = ctypes.c_longlong
            lib.ldpc_error_string.argtypes = [I]
            lib.ldpc_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
