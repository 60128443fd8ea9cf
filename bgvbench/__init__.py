"""Benchmark of the PyTorch and CUDA port of BigGraphVis (``repro_torch``):
one cell once per run, on the card it is started on (``run.py``)."""
