"""The runtime parameters (:mod:`.params`), the cost model
(:mod:`.roofline`) and the profiling helpers (:mod:`.profiling`)."""

from .params import (
    MAX_LLR,
    MIN_LLR,
    SHORTEN_LLR,
    ChannelParams,
    DecoderParams,
    SimulationParams,
)

__all__ = [
    "MAX_LLR",
    "MIN_LLR",
    "SHORTEN_LLR",
    "ChannelParams",
    "DecoderParams",
    "SimulationParams",
]
