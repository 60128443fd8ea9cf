"""The checkpoint functions, re-exported for the training substrate from
``repro_torch.resilience.checkpoint`` (the same file format as the
reference's ``train/checkpoint.py`` shim re-exports)."""
from repro_torch.resilience.checkpoint import (  # noqa: F401
    SEP,
    _leaves,
    _prune,
    latest_step,
    restore,
    save,
)
