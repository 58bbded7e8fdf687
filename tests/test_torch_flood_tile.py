"""The identity the flooding streaming kernel's tile form rests on, against
the JAX stream kernel on the CPU, on the same numpy frames.

The tile form (``csrc/flood_stream.cuh``) carries each frame through a
chunk as its stored posterior ``post`` and its stored check messages
``lc2v``: a check recomputes the extrinsic ``lv2c = store(load(post[v]) -
load(lc2v[e]))``; a frame in flight at chunk entry runs its first pass from
the carried ``lv2c`` plane, a frame reloaded in the chunk starts from
``post = store(prior(x))`` with ``lc2v`` taken as 0, and at chunk exit every
frame that ran a pass writes ``lv2c = store(load(post) - load(lc2v))`` back
to the plane.  :func:`tile_chunk` is that chunk in plain PyTorch on the
port's ``cn_ops`` and ``messages``.  Chunk by chunk it is held against
``bp_stream_chunk_pallas`` in interpret mode (the MXU transport for int8),
from lanes injected at age 0 and lanes reloaded from a pool that is
refilled between chunks, until the lanes drain: after every chunk the
carried ``lv2c`` plane, LLRs, codewords, ``done``, ``iters``, ``age``,
``avail`` and counters must be equal.

Tolerances: the control state (counters, ``done``, ``iters``, ``age``,
``avail``) equal in every form at these seeds; the ``lv2c`` plane bit for
bit in the min-sum family in bfloat16 and int8, within 1e-4 in float32
(the XLA kernel may sum a node's messages in another order, the limit of
``tests/test_torch_sorted.py``) and within one bf16 step in bfloat16 BP
(XLA's and torch's ``exp``/``log1p`` may round a box-plus differently,
``tests/test_torch_messages.py``).  Against the port's plain chunk, the
HBM-plane form's plain version, every form is bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libldpc_tpu.models import make_benchmark_code
from libldpc_tpu.ops.pallas.decode_fused import bp_stream_chunk_pallas
from libldpc_tpu.ops.pallas.layout import to_pallas_device
from libldpc_tpu.ops.streaming_pallas import _edge_prior_pool
from libldpc_tpu_torch.convert import code_from_jax, position_major_slots
from libldpc_tpu_torch.ops.kernels import decode_fused as df
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.ops.messages import MessageForm
from libldpc_tpu_torch.ops.sorted import (
    cn_update_sorted, syndrome_ok_from_posterior, to_sorted_device, vn_posterior_sorted,
)

from test_torch_streaming import frames

torch.set_num_threads(2)

SCALE = 0.1875
B, K, CAP = 32, 3, 8
PLANE, FRESH, TILE = 0, 1, 2  # where a frame's check phase finds its extrinsics


def tile_chunk(tables, st, refill, remaining, k, cap, minsum_mode, form):
    """``k`` passes of the tile form over the state dict ``st`` (the port's
    stream state as tensors), in place; ``remaining`` is the quota."""
    sdc = tables.code
    col, perm = sdc.col_sorted.long(), sdc.perm_c2v.long()
    is_tx = torch.zeros(sdc.nc, dtype=torch.bool).index_fill_(0, sdc.bit_pos.long(), True)
    mode = form.cn_mode(minsum_mode)
    nb = st["done"].shape[0]
    post = torch.zeros((sdc.nc, nb), dtype=form.torch_dtype)  # the block's tiles
    lc2v = torch.zeros((sdc.nnz, nb), dtype=form.torch_dtype)
    src = torch.where(st["done"] == 0, PLANE, TILE)
    dirty = torch.zeros(nb, dtype=torch.bool)
    for _ in range(k):
        # reload in lane order within the quota: post = store(prior(x)), lc2v = 0
        eligible = bool(refill) & (st["done"] != 0) & (st["avail"] != 0)
        rs = eligible & (torch.cumsum(eligible.to(torch.int32), 0) <= remaining)
        remaining -= int(rs.sum())
        st["llr"] = torch.where(rs, st["fresh_llr"], st["llr"])
        st["cw"] = torch.where(rs, st["fresh_cw"], st["cw"])
        post = torch.where(rs, form.store(form.prior(st["fresh_llr"])), post)
        src = torch.where(rs, FRESH, src)
        r = rs.to(torch.int32)
        st["done"] *= 1 - r
        st["age"] = torch.where(rs, 1, st["age"])
        st["iters"] *= 1 - r
        st["avail"] -= r
        st["ctr"][4] += r
        # one pass over the frames in flight
        active = st["done"] == 0
        old = torch.where(src == FRESH, 0.0, form.load(lc2v))
        lv = torch.where(src == PLANE, st["lv2c"], form.store(form.load(post)[col] - old))
        lc2v_new = form.store(cn_update_sorted(sdc, form.load(lv), mode))
        post_new = form.store(vn_posterior_sorted(sdc, form.prior(st["llr"]),
                                                  form.load(lc2v_new)[perm]))
        lc2v = torch.where(active, lc2v_new, lc2v)
        post = torch.where(active, post_new, post)
        src = torch.where(active, TILE, src)
        dirty |= active
        checking = active & (st["age"] >= 1)
        ok = syndrome_ok_from_posterior(sdc, form.load(post)[col])
        st["iters"] += (checking & ~ok).to(torch.int32)
        st["age"] += active.to(torch.int32)
        f = (active & ((checking & ok) | (st["age"] >= cap + 1))).to(torch.int32)
        st["done"] += f
        biterr = (((form.load(post) <= 0) != (st["cw"] != 0)) & is_tx[:, None]).sum(0)
        st["ctr"][0] += f * biterr.to(torch.int32)
        st["ctr"][1] += f * (biterr > 0).to(torch.int32)
        st["ctr"][2] += f
        st["ctr"][3] += f * st["iters"]
    # chunk exit: every frame that ran a pass writes its extrinsics back
    st["lv2c"] = torch.where(dirty, form.store(form.load(post)[col] - form.load(lc2v)),
                             st["lv2c"])


@pytest.fixture(scope="module")
def setup():
    code = make_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True)
    pdc = to_pallas_device(code)
    tables = kernel_tables(to_sorted_device(code_from_jax(code), "cpu"))
    return code, pdc, tables


def jax_chunk(pdc, js, fresh_lv2c, refill, remaining, minsum_mode, dtype):
    out = bp_stream_chunk_pallas(
        pdc, js["llr"], js["cw"], js["lv2c"], js["done8"], js["iters8"], js["age8"],
        js["avail8"], js["ctr8"], js["fresh_llr"], js["fresh_cw"], fresh_lv2c,
        jnp.int32(refill), jnp.int32(remaining), k=K, cap=CAP, minsum_mode=minsum_mode,
        batch_tile=B, interpret=True, message_dtype=dtype, quant_scale=SCALE,
        permute="mxu" if dtype == "int8" else "benes")
    js.update(zip(("llr", "cw", "lv2c", "done8", "iters8", "age8", "avail8", "ctr8"), out))


def as_port(js, slots):
    """The JAX state's planes in the port's layout, as numpy."""
    lv2c = np.asarray(js["lv2c"]).astype(np.float32)[slots]
    return {"llr": np.asarray(js["llr"]), "cw": np.asarray(js["cw"]).astype(np.uint8),
            "lv2c": lv2c, "done": np.asarray(js["done8"])[0], "iters": np.asarray(js["iters8"])[0],
            "age": np.asarray(js["age8"])[0], "avail": np.asarray(js["avail8"])[0],
            "ctr": np.asarray(js["ctr8"])[:5]}


@pytest.mark.parametrize("dtype,form", [("float32", "BP_MS"), ("bfloat16", "BP_MS"),
                                        ("int8", "BP_MS"), ("int8", ("BP_OMS", 1.0, 0.375)),
                                        ("float32", "BP"), ("bfloat16", "BP")])
def test_tile_chunk_matches_jax_stream_kernel(setup, dtype, form):
    code, pdc, tables = setup
    form_ = MessageForm(dtype, SCALE)
    nnz = tables.code.nnz
    vn_perm = pdc.sorted_dc.vn_perm
    llr0, cw0 = frames(code, vn_perm, B, 1.5, seed=21)  # injected at age 0 in lanes 0..15
    pools = [frames(code, vn_perm, B, 1.5, seed=22 + i) for i in range(2)]
    inject = np.arange(B) < B // 2
    st = {"llr": torch.from_numpy(np.where(inject, llr0, 0).astype(np.float32)),
          "cw": torch.from_numpy(np.where(inject, cw0, 0).astype(np.uint8)),
          "lv2c": torch.zeros((nnz, B), dtype=form_.torch_dtype),
          "done": torch.from_numpy((~inject).astype(np.int32)),
          "iters": torch.zeros(B, dtype=torch.int32), "age": torch.zeros(B, dtype=torch.int32),
          "avail": torch.ones(B, dtype=torch.int32), "ctr": torch.zeros((5, B), dtype=torch.int32)}
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}[dtype]
    flag8 = lambda row: jnp.zeros((8, B), jnp.int32).at[0].set(jnp.asarray(row, jnp.int32))
    js = {"llr": jnp.asarray(st["llr"].numpy()), "cw": jnp.asarray(st["cw"].numpy().astype(np.int32)),
          "lv2c": jnp.zeros((pdc.n_pad, B), jdt), "done8": flag8(st["done"].numpy()),
          "iters8": jnp.zeros((8, B), jnp.int32), "age8": jnp.zeros((8, B), jnp.int32),
          "avail8": flag8(np.ones(B)), "ctr8": jnp.zeros((8, B), jnp.int32)}
    slots = position_major_slots(tables.code.cn_classes)
    quota, started = 3 * B // 2, 0
    for chunk in range(9):
        if chunk == 2:  # a new pool: every lane may reload once more
            st["avail"].fill_(1)
            js["avail8"] = flag8(np.ones(B))
        fresh_llr, fresh_cw = pools[chunk >= 2]
        st["fresh_llr"], st["fresh_cw"] = torch.from_numpy(fresh_llr), torch.from_numpy(fresh_cw)
        js["fresh_llr"] = jnp.asarray(fresh_llr)
        js["fresh_cw"] = jnp.asarray(fresh_cw.astype(np.int32))
        js["ctr8"] = jnp.zeros((8, B), jnp.int32)
        st["ctr"].zero_()
        refill, remaining = int(chunk < 5), quota - started
        fresh_lv2c = _edge_prior_pool(pdc.cn_edge_node, js["fresh_llr"], jdt, qscale=SCALE)
        jax_chunk(pdc, js, fresh_lv2c, refill, remaining, form, dtype)
        tile_chunk(tables, st, refill, remaining, K, CAP, form, form_)
        want = as_port(js, slots)
        started += int(want["ctr"][4].sum())
        for name in ("llr", "cw", "done", "iters", "age", "avail", "ctr"):
            np.testing.assert_array_equal(st[name].numpy(), want[name], err_msg=f"{chunk} {name}")
        got_lv2c = st["lv2c"].float().numpy()
        if dtype == "float32" or form == "BP":
            tol = 1e-4 if dtype == "float32" else 2 ** -8
            np.testing.assert_allclose(got_lv2c, want["lv2c"], rtol=tol, atol=tol)
        else:
            np.testing.assert_array_equal(got_lv2c, want["lv2c"], err_msg=f"{chunk} lv2c")
    assert started == quota and int(st["done"].sum()) == B  # drained, the quota exact


@pytest.mark.parametrize("dtype,form", [("float32", "BP_MS"), ("float32", ("BP_NMS", 0.75, 0.15)),
                                        ("float32", "BP"), ("float32", "BP_PHI"),
                                        ("bfloat16", "BP_MS"), ("bfloat16", "BP"),
                                        ("int8", "BP_MS"), ("int8", ("BP_OMS", 1.0, 0.375))])
def test_tile_chunk_matches_plain_chunk(setup, dtype, form):
    """The tile chunk leaves the HBM-plane form's plain chunk's state, bit
    for bit (BP too: the same torch arithmetic in the same order)."""
    code, pdc, tables = setup
    form_ = MessageForm(dtype, SCALE)
    llr, cw = frames(code, pdc.sorted_dc.vn_perm, B, 1.0, seed=31)
    st = {"llr": torch.from_numpy(llr), "cw": torch.from_numpy(cw),
          "lv2c": torch.zeros((tables.code.nnz, B), dtype=form_.torch_dtype),
          "done": torch.zeros(B, dtype=torch.int32), "iters": torch.zeros(B, dtype=torch.int32),
          "age": torch.zeros(B, dtype=torch.int32), "avail": torch.ones(B, dtype=torch.int32),
          "ctr": torch.zeros((5, B), dtype=torch.int32)}
    st["fresh_llr"], st["fresh_cw"] = (torch.from_numpy(x) for x in frames(
        code, pdc.sorted_dc.vn_perm, B, 1.0, seed=32))
    plain = {n: t.clone() for n, t in st.items()}
    for chunk in range(8):
        refill = torch.tensor([int(chunk < 3)], dtype=torch.int32)
        remaining = torch.tensor([B], dtype=torch.int32)
        tile_chunk(tables, st, int(refill), B, 2, CAP, form, form_)
        df.bp_stream_chunk_fused_plain(
            tables, plain["llr"], plain["cw"], plain["lv2c"], plain["done"], plain["iters"],
            plain["age"], plain["avail"], plain["ctr"], plain["fresh_llr"], plain["fresh_cw"],
            refill, remaining, k=2, cap=CAP, minsum_mode=form, message_dtype=dtype,
            quant_scale=SCALE)
        for name in ("llr", "cw", "lv2c", "done", "iters", "age", "avail", "ctr"):
            assert torch.equal(st[name], plain[name]), f"chunk {chunk}: {name}"
