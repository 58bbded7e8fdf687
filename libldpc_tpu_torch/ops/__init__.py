"""PyTorch ops: CN forms, the sorted layout, channels and streaming."""
