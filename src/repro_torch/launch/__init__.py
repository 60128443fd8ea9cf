"""Command-line launchers: ``serve`` (the tile-pyramid service),
``render_runner`` (pipeline + streaming rasterizer), ``layout`` (the
paper's end-user command), ``stream_runner`` (the streaming engine, on
one rank or several) and ``train`` (training with checkpoint/restart).
Each runs on CUDA unless given ``--device cpu``, and takes the shared
``--trace-out``/``--metrics-out``/``--profile`` flags
(``repro_torch.obs.cli``). ``mesh`` builds the multi-device meshes
(``make_stream_mesh``; ``make_model_mesh``, ``make_host_mesh``,
``make_production_mesh``; ``spawn_local``); ``steps`` the step of each
(arch × shape) cell, on one device or a ``ModelMesh``."""
