"""The sweep driver and its results (import :mod:`.driver` directly)."""
