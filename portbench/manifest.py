"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names its configuration, whose file
``configs/<config>.json`` holds the scene, the render settings and the
limits of the comparison, and its traffic, ``traffic/<traffic>.json``,
whose ``driver`` names the general generator ``drivers/<driver>.py``
that reads it.  The cell's metrics are the ``end_to_end`` and
``per_layer`` entries whose ``workloads`` list it (or that have no such
list).
"""

from __future__ import annotations

import importlib
import json
import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, 'portbench')

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        return json.load(f)


def _for_cell(metrics, cell):
    return [m for m in metrics if cell in m.get('workloads', [cell])]


def cell(name: str, root: str = ROOT) -> dict:
    """The cell ``name`` with its configuration, traffic and metrics."""
    bench = load(root)
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json; have '
                       f'{sorted(cells)}')
    w = cells[name]
    with open(os.path.join(HERE, 'configs', f"{w['config']}.json")) as f:
        config = json.load(f)
    with open(os.path.join(HERE, 'traffic', f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    return dict(workload=w, config=config, traffic=traffic,
                run_seconds=bench['run_seconds'],
                end_to_end=_for_cell(bench['end_to_end'], name),
                per_layer=_for_cell(bench['per_layer'], name))


def driver(traffic: dict):
    """The generator class ``drivers/<traffic['driver']>.py`` ``Driver``."""
    if not re.match(r'^[A-Za-z_][A-Za-z0-9_]*$', traffic['driver']):
        raise ValueError(f"bad driver name {traffic['driver']!r}")
    return importlib.import_module(
        f"portbench.drivers.{traffic['driver']}").Driver
