"""Per-layer metric readers, one file a metric: ``metrics/<name>.py``
holds ``read(ctx)``, which takes the traced window (``ctx``, a
``portbench.trace.Window``) and returns the metric's number, or None
where the window has nothing for it to read; the harness then leaves the
metric out of the result.  Files whose names start with ``_`` are the
yardstick's shared arithmetic, not metrics."""

from __future__ import annotations

import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``, found by name."""
    path = os.path.join(HERE, f'{name}.py')
    if not os.path.exists(path):
        raise ValueError(f'no reader {path} for per-layer metric {name}')
    spec = importlib.util.spec_from_file_location(
        'portbench_metric_' + name.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
