"""The sweep driver (:mod:`.driver`) and its results (:mod:`.results`).
``Simulator`` is loaded at first use: the driver imports the kernel
wrappers."""

from .results import SimResults

__all__ = ["SimResults", "Simulator"]


def __getattr__(name):
    if name == "Simulator":
        from .driver import Simulator

        return Simulator
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
