"""Per-metric readers, one file each, named as the metric: ``read(view)``
returns the metric's number from a run's ``run.View``, or ``None`` where it
finds nothing to read."""
from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def reader(name: str):
    """The ``read`` of ``<name>.py`` beside this file."""
    spec = importlib.util.spec_from_file_location(
        "mmbench.metrics." + name.replace(".", "__"), HERE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
