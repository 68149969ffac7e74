"""Parser for the reference's ``.nra2`` text scene format
(corona13_tpu/io/nra2.py).

Format (corona-13 src/shader.c:605-760, src/corona_common.c:30-68):
  line 1: sky shader name + args
  int N, then N shader lines ``<name> <args...>  [# comment]``
  int M, then M shape lines ``<shaderid> <geo-path-without-ext> [texture]``
Comments start at '#'.  Shader args are free-form per shader; this module
only tokenizes — semantic resolution (mult chains, slots) happens in
scene.py so the parse stays dumb and reusable.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class ShaderDesc:
    name: str
    args: list[str]


@dataclasses.dataclass
class ShapeDesc:
    shader: int
    geo_path: str      # absolute path with .geo extension resolved
    texture: str = ''


@dataclasses.dataclass
class SceneDesc:
    sky: ShaderDesc
    shaders: list[ShaderDesc]
    shapes: list[ShapeDesc]
    path: str


def _strip(line: str) -> str:
    i = line.find('#')
    return (line[:i] if i >= 0 else line).strip()


def parse_nra2(path: str, searchpath: str | None = None) -> SceneDesc:
    base = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        raw = f.readlines()
    # token stream like fscanf: the reference reads whitespace-separated
    # tokens but shader args run to end-of-line, so keep line structure.
    lines = [l for l in (_strip(l) for l in raw)]
    # drop trailing all-empty, keep internal structure
    it = iter(range(len(lines)))

    def next_nonempty(start):
        i = start
        while i < len(lines) and not lines[i]:
            i += 1
        return i

    i = next_nonempty(0)
    sky_tok = lines[i].split()
    sky = ShaderDesc(name=sky_tok[0], args=sky_tok[1:])
    i = next_nonempty(i + 1)
    n_shaders = int(lines[i].split()[0])
    shaders = []
    i += 1
    while len(shaders) < n_shaders:
        i = next_nonempty(i)
        tok = lines[i].split()
        shaders.append(ShaderDesc(name=tok[0], args=tok[1:]))
        i += 1
    i = next_nonempty(i)
    n_shapes = int(lines[i].split()[0])
    shapes = []
    i += 1
    while len(shapes) < n_shapes:
        i = next_nonempty(i)
        tok = lines[i].split()
        shader = int(tok[0])
        geo = tok[1]
        tex = tok[2] if len(tok) > 2 else ''
        cand = geo if geo.endswith('.geo') else geo + '.geo'
        for root in (base, searchpath or base):
            p = os.path.normpath(os.path.join(root, cand))
            if os.path.exists(p):
                cand = p
                break
        shapes.append(ShapeDesc(shader=shader, geo_path=cand, texture=tex))
        i += 1
    return SceneDesc(sky=sky, shaders=shaders, shapes=shapes, path=path)
