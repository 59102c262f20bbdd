"""The loops that drive an entry, one module each, found by the mix's
``"loop"``. A module gives ``make(submit, outcome, n_distinct, mix)``, an
object whose ``run(warmup, seconds, on_open, on_close)`` returns a
``harness.window.Window``."""
from __future__ import annotations

import importlib


def load(name: str):
    if not name.isidentifier():
        raise ValueError(f"no loop {name!r}")
    return importlib.import_module(f"loops.{name}")
