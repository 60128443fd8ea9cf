"""Plain PyTorch and NumPy reference of the BigGraphVis pipeline.

Written from the published algorithms and the configuration files alone: it
imports nothing of the program under test, takes only the generated edges,
and works out the degree threshold, the starting positions, the SCoDA
state, the supergraph, the layout and the image itself. Every module runs
on any device; on the card the benchmark runs it after the measured window.
"""
