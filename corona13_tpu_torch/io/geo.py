"""Triangle reader for the reference's binary ``.geo`` geometry format
(the triangle part of corona13_tpu/io/geo.py).

Layout (corona-13 include/prims.h:26-47, include/geo.h): a 32-byte header
{magic 0xc01337, version 2, num_prims, vtxidx_offset, vertex_offset}, a
u64 primid bitfield per prim, a {v:u32, uv:u32} vertex-index array and
16-byte vertices {float3 pos, u32 payload}.  Quads split into the
triangles (v0,v1,v2) and (v0,v2,v3), in the reference loader's order:
all triangles, then every quad's first half, then every second half.
Spheres, lines and motion-blurred prims are not ported yet.
"""

from __future__ import annotations

import struct

import numpy as np

GEO_MAGIC = 0xC01337
GEO_VERSION = 2
PRIM_TRI = 3
PRIM_QUAD = 4


def load_tri_vtx(path: str) -> np.ndarray:
    """Triangle positions [T, 3, 3] float32 of a static mesh .geo file."""
    with open(path, 'rb') as f:
        data = f.read()
    magic, version, num_prims, vtxidx_off, vertex_off = struct.unpack_from(
        '<iiQQQ', data, 0)
    if magic != GEO_MAGIC:
        raise ValueError(f'{path}: bad magic {magic:#x}')
    if version != GEO_VERSION:
        raise ValueError(f'{path}: unsupported version {version}')
    primids = np.frombuffer(data, np.uint64, count=num_prims, offset=32)
    n_vtxidx = (vertex_off - vtxidx_off) // 8
    vtxidx = np.frombuffer(data, np.uint32, count=2 * n_vtxidx,
                           offset=vtxidx_off).reshape(-1, 2)
    nvtx = (len(data) - vertex_off) // 16
    vpos = np.frombuffer(data, np.float32, count=4 * nvtx,
                         offset=vertex_off).reshape(nvtx, 4)[:, :3]
    # primid bitfield (corona_common.h:45-55)
    vi = ((primids >> np.uint64(32)) & np.uint64((1 << 28) - 1)).astype(np.int64)
    mb = (primids >> np.uint64(60)) & np.uint64(1)
    vcnt = ((primids >> np.uint64(61)) & np.uint64(7)).astype(np.int64)
    if mb.any() or not np.isin(vcnt, (PRIM_TRI, PRIM_QUAD)).all():
        raise NotImplementedError(
            f'{path}: only static triangles and quads are ported yet')
    tri_sel = np.nonzero(vcnt == PRIM_TRI)[0]
    quad_sel = np.nonzero(vcnt == PRIM_QUAD)[0]

    def corners(sel, cs):
        return np.stack([vpos[vtxidx[vi[sel] + c, 0].astype(np.int64)]
                         for c in cs], axis=1).reshape(-1, 3, 3)

    return np.concatenate([corners(tri_sel, (0, 1, 2)),
                           corners(quad_sel, (0, 1, 2)),
                           corners(quad_sel, (0, 2, 3))]).astype(np.float32)
