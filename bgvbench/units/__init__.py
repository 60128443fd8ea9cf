"""Kinds of units of work, one module each, found by the ``unit`` a traffic
mix names: ``units/<kind>.py`` defines ``Unit(program, config, mix, edges,
seed, device)`` with ``warm()``, ``run()`` (one repetition's record: its
stage seconds and a ``digest`` of its outputs), ``shapes()``, ``release()``
and ``check(digests, device)``, and, for ``control.py``, ``reference``,
``compare`` and ``control``."""
