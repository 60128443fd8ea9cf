"""Command-line launchers: ``serve`` (the tile-pyramid service),
``render_runner`` (pipeline + streaming rasterizer) and ``layout`` (the
paper's end-user command). Each runs on CUDA unless given ``--device cpu``,
and takes the shared ``--trace-out``/``--metrics-out``/``--profile`` flags
(``repro_torch.obs.cli``)."""
