"""The plain reference that decides ``correct``: the frames a run's seed
gives (``channel``, on curand's Philox from ``philox``), the decoders and
the streaming engine's lane schedule in float64 (``decoders``), and the
comparisons (``checks``).  Plain PyTorch and NumPy; it imports nothing of
the program under test and takes nothing it made."""
