"""The decode library's entry points (the JAX package's ``libldpc_tpu.ops``
exports).  Importing it builds and loads no kernel: the CUDA library is
built at the first launch."""

from .device import PAD_LLR, DeviceCode, to_device
from .decoder import DecodeOutput, bp_decode, bp_decode_jit
from .sorted import TorchSortedCode as SortedDeviceCode, bp_decode_sorted, to_sorted_device
from .bec import BECDecodeOutput, bec_decode, bec_decode_jit
from . import channel, cn_ops, modulation

__all__ = [
    "BECDecodeOutput",
    "PAD_LLR",
    "DeviceCode",
    "DecodeOutput",
    "SortedDeviceCode",
    "bec_decode",
    "bec_decode_jit",
    "bp_decode",
    "bp_decode_jit",
    "bp_decode_sorted",
    "channel",
    "cn_ops",
    "modulation",
    "to_device",
    "to_sorted_device",
]
