"""Scene inputs of the benchmark's configurations, handed alike to the
program and to the plain reference.

A configuration's ``scene`` names its maker by ``kind``: ``nra2`` loads a
scene file of the repository with the side's own ``scene.load_scene``;
any other kind is the module ``portbench/scenes/<kind>.py``, whose
``inputs(**params)`` returns raw arrays (triangles, their shaders,
materials as ``_ResolvedMat`` keywords with ``kind`` named as a string,
``CameraData`` keywords, and further ``assemble_scene`` keywords) that
the side's own ``assemble_scene`` builds on the device.  Each side builds
its own tree and tables from the same inputs.
"""

from __future__ import annotations

import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def maker(kind: str):
    """The module ``scenes/<kind>.py``, found by name."""
    path = os.path.join(HERE, f'{kind}.py')
    if not os.path.exists(path):
        raise ValueError(f'no scene maker {path}')
    spec = importlib.util.spec_from_file_location(f'portbench_scene_{kind}',
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(spec: dict, side, root: str, device, width: int, height: int):
    """The scene of ``spec`` (a configuration's ``scene``) built by
    ``side``, a namespace with the side's ``scene`` module, its
    ``assemble_scene`` and its ``cam_io`` module, on ``device``, its film
    fitted to width x height.  ``root``: the checkout, which relative scene
    paths start from."""
    params = {k: v for k, v in spec.items() if k != 'kind'}
    if spec['kind'] == 'nra2':
        sc = side.scene.load_scene(os.path.join(root, params['path']),
                                   device=device)[0]
    else:
        tri_v, tri_sh, mats, cam, kw = maker(spec['kind']).inputs(**params)
        mats = [side.scene._ResolvedMat(**dict(
            m, **({'kind': getattr(side.scene, m['kind'])}
                  if 'kind' in m else {}))) for m in mats]
        sc = side.assemble_scene(tri_v, tri_sh, mats,
                                 side.cam_io.CameraData(**cam),
                                 device=device, **kw)
    return side.scene.fit_film(sc, width, height)
