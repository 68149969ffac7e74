"""Reader for the reference's binary ``.geo`` geometry format
(corona13_tpu/io/geo.py).

Layout (corona-13 include/prims.h:26-47, include/geo.h): a 32-byte header
{magic 0xc01337, version 2, num_prims, vtxidx_offset, vertex_offset}, a
u64 primid bitfield per prim, a {v:u32, uv:u32} vertex-index array (uv is
an encoded half2 texture coordinate, 0 = none) and 16-byte vertices
{float3 pos, u32 payload}: an oct-encoded normal for meshes, a bitcast
float radius for spheres and lines.  Motion blur doubles the vertex stride
(shutter-open / shutter-close pairs).  Quads split into the triangles
(v0,v1,v2) and (v0,v2,v3), in the reference loader's order: all
triangles, then every quad's first half, then every second half.

Everything decodes vectorised in numpy.  Lines and motion load here;
``ops/trace.py`` refuses them at trace time until their leaf tests are
ported.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

GEO_MAGIC = 0xC01337
GEO_VERSION = 2

# primid vcnt codes (reference corona_common.h:45-55 / geo headers)
PRIM_SPHERE = 1
PRIM_LINE = 2
PRIM_TRI = 3
PRIM_QUAD = 4
PRIM_SHELL = 5


def decode_oct_normal(enc: np.ndarray) -> np.ndarray:
    """Vectorized decode of the 32-bit octahedral normal (geo.h:25-46)."""
    enc = np.asarray(enc, np.uint32)
    p0 = (enc & 0xFFFF).astype(np.uint32)
    p1 = (enc >> 16).astype(np.uint32)

    def comp(p):
        bits = np.uint32(0x3F800000) | ((p & np.uint32(0x7FFF)) << np.uint32(8))
        val = bits.view(np.float32) if bits.flags['C_CONTIGUOUS'] else np.ascontiguousarray(bits).view(np.float32)
        mag = 2.0 * val - 2.0
        sign = np.where((p & np.uint32(0x8000)) != 0, -1.0, 1.0).astype(np.float32)
        return sign * mag

    x = comp(p0)
    y = comp(p1)
    z = 1.0 - (np.abs(x) + np.abs(y))
    fold = z < 0.0
    xf = (1.0 - np.abs(y)) * np.where(x < 0.0, -1.0, 1.0)
    yf = (1.0 - np.abs(x)) * np.where(y < 0.0, -1.0, 1.0)
    x = np.where(fold, xf, x)
    y = np.where(fold, yf, y)
    n = np.stack([x, y, z], axis=-1).astype(np.float32)
    l = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(l, 1e-20)).astype(np.float32)


def encode_oct_normal(n: np.ndarray) -> np.ndarray:
    """Vectorized encode, inverse of decode_oct_normal (geo.h:48-75)."""
    n = np.asarray(n, np.float32)
    inv = 1.0 / np.maximum(np.abs(n[..., 0]) + np.abs(n[..., 1]) + np.abs(n[..., 2]), 1e-20)
    x, y, z = n[..., 0] * inv, n[..., 1] * inv, n[..., 2] * inv
    fold = z < 0.0
    e0 = np.where(fold, (1.0 - np.abs(y)) * np.where(x < 0, -1.0, 1.0), x)
    e1 = np.where(fold, (1.0 - np.abs(x)) * np.where(y < 0, -1.0, 1.0), y)

    def comp(e):
        bits = ((np.abs(e) + 2.0) / 2.0).astype(np.float32).view(np.uint32)
        sign = (e.astype(np.float32).view(np.uint32) & np.uint32(0x80000000)) >> np.uint32(16)
        p = (sign | ((bits & np.uint32(0x7FFFFF)) >> np.uint32(8))).astype(np.uint32)
        return np.where((p & np.uint32(0x7FFF)) == 0, np.uint32(0), p)

    return (comp(e0) | (comp(e1) << np.uint32(16))).astype(np.uint32)


def decode_uv(enc: np.ndarray) -> np.ndarray:
    """u32 -> two half-precision texture coords (geo.h:79-92)."""
    enc = np.ascontiguousarray(np.asarray(enc, np.uint32))
    h = enc.view(np.uint16).reshape(enc.shape + (2,))
    return h.view(np.float16).astype(np.float32)


@dataclasses.dataclass
class GeoShape:
    """One loaded .geo file, decoded to SoA numpy arrays.

    Triangles: quads are split into two triangles at load (the reference
    intersects quads as (v0,v1,v2)+(v0,v2,v3), src/prims.c:652-664); the
    ``tri_quad_half`` flag (0 = real tri, 1/2 = quad halves) preserves the
    reference's quad uv convention for shading.
    """
    # triangle soup
    tri_vtx: np.ndarray        # [T, 3, 3] positions (shutter open)
    tri_vtx_t1: np.ndarray     # [T, 3, 3] shutter close (== tri_vtx if no mb)
    tri_ns: np.ndarray         # [T, 3, 3] shading normals per corner
    tri_ns_t1: np.ndarray      # [T, 3, 3]
    tri_uv: np.ndarray         # [T, 3, 2]
    tri_quad_half: np.ndarray  # [T] uint8
    tri_prim: np.ndarray       # [T] int32 source prim index within this shape
    # spheres
    sph_center: np.ndarray     # [S, 3]
    sph_center_t1: np.ndarray  # [S, 3]
    sph_radius: np.ndarray     # [S]
    sph_prim: np.ndarray       # [S] int32
    # lines (truncated cones)
    line_vtx: np.ndarray       # [L, 2, 3]
    line_vtx_t1: np.ndarray    # [L, 2, 3]
    line_radii: np.ndarray     # [L, 2]
    line_prim: np.ndarray      # [L] int32
    num_prims: int = 0
    has_motion: bool = False


def load_geo(path: str) -> GeoShape:
    with open(path, 'rb') as f:
        data = f.read()
    magic, version, num_prims, vtxidx_off, vertex_off = struct.unpack_from('<iiQQQ', data, 0)
    if magic != GEO_MAGIC:
        raise ValueError(f'{path}: bad magic {magic:#x}')
    if version != GEO_VERSION:
        raise ValueError(f'{path}: unsupported version {version}')

    primids = np.frombuffer(data, np.uint64, count=num_prims, offset=32)
    n_vtxidx = (vertex_off - vtxidx_off) // 8
    vtxidx = np.frombuffer(data, np.uint32, count=2 * n_vtxidx, offset=vtxidx_off).reshape(-1, 2)
    vraw = np.frombuffer(data, np.uint8, offset=vertex_off)
    nvtx = len(vraw) // 16
    vbytes = vraw[:nvtx * 16].reshape(nvtx, 16)
    vpos = np.ascontiguousarray(vbytes[:, :12]).view(np.float32).reshape(nvtx, 3)
    vpay = np.ascontiguousarray(vbytes[:, 12:16]).view(np.uint32).reshape(nvtx)

    # unpack primid bitfields (corona_common.h:45-55)
    vi = ((primids >> np.uint64(32)) & np.uint64((1 << 28) - 1)).astype(np.int64)
    mb = ((primids >> np.uint64(60)) & np.uint64(1)).astype(np.int64)
    vcnt = ((primids >> np.uint64(61)) & np.uint64(7)).astype(np.int64)
    has_motion = bool(mb.any())
    stride = mb + 1

    def vert(prim_sel, corner, close=False):
        """Positions of corner `corner` for selected prims."""
        vidx = vtxidx[vi[prim_sel] + corner, 0].astype(np.int64)
        idx = stride[prim_sel] * vidx + (mb[prim_sel] if close else 0)
        return vpos[idx]

    def payload(prim_sel, corner, close=False):
        vidx = vtxidx[vi[prim_sel] + corner, 0].astype(np.int64)
        idx = stride[prim_sel] * vidx + (mb[prim_sel] if close else 0)
        return vpay[idx]

    def uv(prim_sel, corner):
        return decode_uv(vtxidx[vi[prim_sel] + corner, 1])

    prim_index = np.arange(num_prims, dtype=np.int32)

    # --- triangles + quads -> triangle soup
    tri_sel = np.nonzero(vcnt == PRIM_TRI)[0]
    quad_sel = np.nonzero(vcnt == PRIM_QUAD)[0]

    def gather_tris(sel, corners, close):
        if len(sel) == 0:
            return np.zeros((0, 3, 3), np.float32)
        return np.stack([vert(sel, c, close) for c in corners], axis=1)

    def gather_ns(sel, corners, close):
        if len(sel) == 0:
            return np.zeros((0, 3, 3), np.float32)
        return np.stack([decode_oct_normal(payload(sel, c, close)) for c in corners], axis=1)

    def gather_uvs(sel, corners):
        if len(sel) == 0:
            return np.zeros((0, 3, 2), np.float32)
        return np.stack([uv(sel, c) for c in corners], axis=1)

    parts_v, parts_v1, parts_n, parts_n1, parts_uv, parts_half, parts_prim = [], [], [], [], [], [], []
    # plain triangles
    parts_v.append(gather_tris(tri_sel, (0, 1, 2), False))
    parts_v1.append(gather_tris(tri_sel, (0, 1, 2), True))
    parts_n.append(gather_ns(tri_sel, (0, 1, 2), False))
    parts_n1.append(gather_ns(tri_sel, (0, 1, 2), True))
    parts_uv.append(gather_uvs(tri_sel, (0, 1, 2)))
    parts_half.append(np.zeros(len(tri_sel), np.uint8))
    parts_prim.append(prim_index[tri_sel])
    # quad halves: (v0,v1,v2) and (v0,v2,v3)
    for half, corners in ((1, (0, 1, 2)), (2, (0, 2, 3))):
        parts_v.append(gather_tris(quad_sel, corners, False))
        parts_v1.append(gather_tris(quad_sel, corners, True))
        parts_n.append(gather_ns(quad_sel, corners, False))
        parts_n1.append(gather_ns(quad_sel, corners, True))
        parts_uv.append(gather_uvs(quad_sel, corners))
        parts_half.append(np.full(len(quad_sel), half, np.uint8))
        parts_prim.append(prim_index[quad_sel])

    # --- spheres: radius bitcast in the payload slot (geo/sphere.h:9-13)
    sph_sel = np.nonzero(vcnt == PRIM_SPHERE)[0]
    if len(sph_sel):
        sph_center = vert(sph_sel, 0, False)
        sph_center_t1 = vert(sph_sel, 0, True)
        sph_radius = np.ascontiguousarray(payload(sph_sel, 0)).view(np.float32)
    else:
        sph_center = np.zeros((0, 3), np.float32)
        sph_center_t1 = np.zeros((0, 3), np.float32)
        sph_radius = np.zeros((0,), np.float32)

    # --- lines / truncated cones (geo/line.h)
    line_sel = np.nonzero(vcnt == PRIM_LINE)[0]
    if len(line_sel):
        line_vtx = np.stack([vert(line_sel, 0, False), vert(line_sel, 1, False)], axis=1)
        line_vtx_t1 = np.stack([vert(line_sel, 0, True), vert(line_sel, 1, True)], axis=1)
        line_radii = np.stack([
            np.ascontiguousarray(payload(line_sel, 0)).view(np.float32),
            np.ascontiguousarray(payload(line_sel, 1)).view(np.float32)], axis=1)
    else:
        line_vtx = np.zeros((0, 2, 3), np.float32)
        line_vtx_t1 = np.zeros((0, 2, 3), np.float32)
        line_radii = np.zeros((0, 2), np.float32)

    return GeoShape(
        tri_vtx=np.concatenate(parts_v).astype(np.float32),
        tri_vtx_t1=np.concatenate(parts_v1).astype(np.float32),
        tri_ns=np.concatenate(parts_n).astype(np.float32),
        tri_ns_t1=np.concatenate(parts_n1).astype(np.float32),
        tri_uv=np.concatenate(parts_uv).astype(np.float32),
        tri_quad_half=np.concatenate(parts_half),
        tri_prim=np.concatenate(parts_prim).astype(np.int32),
        sph_center=sph_center, sph_center_t1=sph_center_t1,
        sph_radius=sph_radius, sph_prim=prim_index[sph_sel],
        line_vtx=line_vtx, line_vtx_t1=line_vtx_t1,
        line_radii=line_radii, line_prim=prim_index[line_sel],
        num_prims=int(num_prims), has_motion=has_motion,
    )
