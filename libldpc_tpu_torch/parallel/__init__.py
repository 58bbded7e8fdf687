"""The per-batch simulation step (one device)."""
