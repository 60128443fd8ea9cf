"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions
(``*/ref.py``) and device-dispatching wrappers (``*/ops.py``); ``build``
compiles and loads them."""
