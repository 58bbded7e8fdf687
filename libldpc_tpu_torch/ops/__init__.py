"""PyTorch ops: CN forms, the sorted layout, channels, streaming and the layered engine."""
