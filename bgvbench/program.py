"""The system under test: the PyTorch and CUDA port, ``repro_torch``,
imported from the checkout's ``src/``. The harness reaches the program
only through the object ``load()`` returns."""
from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]


def load() -> SimpleNamespace:
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch
    from repro_torch.core.forceatlas2 import FA2Config

    return SimpleNamespace(
        biggraphvis=repro_torch.biggraphvis, default_config=repro_torch.default_config,
        StreamConfig=repro_torch.StreamConfig, RenderConfig=repro_torch.RenderConfig,
        layout=repro_torch.layout, FA2Config=FA2Config)
