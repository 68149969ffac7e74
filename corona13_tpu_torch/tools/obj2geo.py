"""Wavefront OBJ -> reference .geo converter
(corona13_tpu/tools/obj2geo.py; corona-13 tools/geo/obj2geo.c analogue).

    python -m corona13_tpu_torch.tools.obj2geo input.obj output.geo

Triangulates polygon faces (fan), carries shading normals (per-vertex when
present, face normals otherwise) and texture coordinates.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io import geo as geo_io


def load_obj(path: str):
    """Minimal OBJ reader: v / vn / vt / f (poly faces fan-triangulated).
    Returns (tri_vtx [T,3,3], tri_ns [T,3,3] | None, tri_uv [T,3,2] | None).
    """
    vs, vns, vts = [], [], []
    faces = []  # list of [(vi, ti, ni), ...]
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith('#'):
                continue
            if tok[0] == 'v':
                vs.append([float(x) for x in tok[1:4]])
            elif tok[0] == 'vn':
                vns.append([float(x) for x in tok[1:4]])
            elif tok[0] == 'vt':
                vts.append([float(x) for x in tok[1:3]])
            elif tok[0] == 'f':
                corners = []
                for c in tok[1:]:
                    parts = (c.split('/') + ['', ''])[:3]
                    vi = int(parts[0])
                    ti = int(parts[1]) if parts[1] else 0
                    ni = int(parts[2]) if parts[2] else 0
                    corners.append((vi, ti, ni))
                for k in range(1, len(corners) - 1):  # fan triangulation
                    faces.append([corners[0], corners[k], corners[k + 1]])
    vs = np.asarray(vs, np.float32)
    vns = np.asarray(vns, np.float32) if vns else None
    vts = np.asarray(vts, np.float32) if vts else None

    def resolve(idx, n):
        return idx - 1 if idx > 0 else n + idx

    t = len(faces)
    tri = np.zeros((t, 3, 3), np.float32)
    tri_ns = np.zeros((t, 3, 3), np.float32) if vns is not None else None
    tri_uv = np.zeros((t, 3, 2), np.float32) if vts is not None else None
    has_ns = vns is not None
    for i, face in enumerate(faces):
        for c, (vi, ti, ni) in enumerate(face):
            tri[i, c] = vs[resolve(vi, len(vs))]
            if has_ns and ni:
                tri_ns[i, c] = vns[resolve(ni, len(vns))]
            elif has_ns:
                has_ns = False
            if tri_uv is not None and ti:
                tri_uv[i, c] = vts[resolve(ti, len(vts))]
    return tri, (tri_ns if has_ns else None), tri_uv


def main(argv=None):
    p = argparse.ArgumentParser(prog='obj2geo')
    p.add_argument('obj')
    p.add_argument('geo')
    args = p.parse_args(argv)
    tri, ns, uv = load_obj(args.obj)
    geo_io.write_geo(args.geo, tri, ns, uv)
    print(f'wrote {args.geo}: {len(tri)} triangles'
          f'{" +normals" if ns is not None else ""}'
          f'{" +uvs" if uv is not None else ""}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
