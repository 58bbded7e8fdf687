"""The per-batch simulation step on one device or a mesh (:mod:`.mesh`),
and the multi-process glue (:mod:`.distributed`).  The names of
:mod:`.mesh` are loaded at first use: it imports the kernel wrappers."""

__all__ = ["FRAME_AXIS", "StepCounters", "default_mesh", "make_sim_step"]


def __getattr__(name):
    if name in __all__:
        from . import mesh

        return getattr(mesh, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
