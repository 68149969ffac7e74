# Frozen copy of corona13_tpu_torch/io/vol.py (lines 1-258) as of commit 2084081, for the benchmark's plain reference.
"""Reader and writer for the reference .vol hierarchical volume format
(corona13_tpu/io/vol.py).

Format (corona-13 include/vol/types.h:31-96): 4096-byte header (magic
0x9bae454d, version 8 | motion_samples<<16), payload blocks starting at
byte 4096, node array at header.nodes, root node = last node before the
light-hierarchy offset.  Nodes are 544-byte 512-ary (8x8x8) records whose
children are either sub-nodes (interior) or 8x8x8 voxel payload bricks
(leaf); child i of (ix, iy, iz) is i = ix | iy<<3 | iz<<6 and off[i] = 255
marks an empty child (vol.h:20-26).  Payload bricks store density +
temperature as half floats — the static layout (d[512] then t[512]
uint16), which is also the master (time=0) slice of the compressed
motion-blur layout (payload_compress.h:8-18), so this reader returns the
t=0 field for dynamic files.

The out-of-core CPU octree becomes a dense (optionally downsampled) grid
in device memory: `read_vol` returns density/temperature arrays plus the
world transform, consumed by models/medium_hete.
"""

from __future__ import annotations

import numpy as np

VOL_MAGIC = 0x9bae454d
VOL_VERSION = 8
VOL_MOTION_SAMPLES = 64

_HEADER = np.dtype([
    ('magic', '<u4'), ('version', '<u4'), ('nodes', '<u8'),
    ('aabb', '<f4', 6), ('content_box', '<f4', 6), ('voxel_size', '<f4'),
    ('rot', '<f4', 3), ('loc', '<f4', 3), ('depth', '<i4'),
    ('light', '<u8'), ('isstatic', '<i4'), ('shaderid', '<i4'),
    ('end', '<u8'), ('pad', 'u1', 3972)])
# note: the C struct has 3976 pad bytes with 8-byte alignment of the u64
# members; the numpy layout above is packed, so we pad to 4096 explicitly
assert _HEADER.itemsize <= 4096

_NODE = np.dtype([
    ('doff0', '<u8'),      # data_static0:1 | data_offset0:63
    ('doff1', '<u8'),
    ('noff0', '<u4'),      # off255_empty:1 | node_offset0:31
    ('noff1', '<u4'),      # off511_empty:1 | node_leaf:1 | node_offset1:30
    ('lh0', '<u4'), ('lh1', '<u4'),
    ('off', 'u1', 512)])
assert _NODE.itemsize == 544

STATIC_PAYLOAD = 2048            # u16 d[512] + u16 t[512]
COMPRESSED_PAYLOAD = 2048 + VOL_MOTION_SAMPLES * 16 * 3


def _node_fields(n):
    return dict(
        static0=bool(n['doff0'] & 1), off0=int(n['doff0'] >> 1),
        static1=bool(n['doff1'] & 1), off1=int(n['doff1'] >> 1),
        e255=bool(n['noff0'] & 1), noff0=int(n['noff0'] >> 1),
        e511=bool(n['noff1'] & 1), leaf=bool((n['noff1'] >> 1) & 1),
        noff1=int(n['noff1'] >> 2), off=n['off'])


def _child_empty(f, i):
    if i == 255:
        return f['e255']
    if i == 511:
        return f['e511']
    return f['off'][i] == 255


class VolFile:
    """Parsed .vol: dense density/temperature grids + world placement."""

    def __init__(self, density, temperature, aabb, voxel_size, loc, rot,
                 shaderid=0):
        self.density = density          # [Z, Y, X] float32 (k, j, i order)
        self.temperature = temperature
        self.aabb = np.asarray(aabb, np.float32)
        self.voxel_size = float(voxel_size)
        self.loc = np.asarray(loc, np.float32)
        self.rot = np.asarray(rot, np.float32)
        self.shaderid = shaderid

    @property
    def res(self):
        return self.density.shape[::-1]


def read_vol(path: str, max_res: int = 256) -> VolFile:
    data = np.fromfile(path, np.uint8)
    hd = np.frombuffer(data[:_HEADER.itemsize].tobytes(), _HEADER)[0]
    if hd['magic'] != VOL_MAGIC:
        raise ValueError(f'{path}: bad magic {hd["magic"]:#x}')
    if (hd['version'] & 0xffff) != VOL_VERSION:
        raise ValueError(f'{path}: version {hd["version"] & 0xffff} != 8')
    depth = int(hd['depth'])
    nodes_off = int(hd['nodes'])
    light_off = int(hd['light'])
    payload = data[4096:]
    n_nodes = (light_off - nodes_off) // _NODE.itemsize
    nodes = np.frombuffer(
        data[nodes_off:nodes_off + n_nodes * _NODE.itemsize].tobytes(),
        _NODE)
    root = n_nodes - 1

    # resolution is 8**depth voxels per axis (vol.h:299 voxel_size uses
    # powf(8, depth); root-to-leaf files are depth=2 -> 64^3, and depth==1
    # is explicitly unsupported by the reference loader, vol.h:295).
    res = 8 ** depth
    dens = np.zeros((res, res, res), np.float32)    # [Z, Y, X]
    temp = np.zeros((res, res, res), np.float32)

    def brick(f, i):
        """Decode payload brick of child i as (d, t) [8,8,8] float32."""
        psize = STATIC_PAYLOAD if (f['static0'] if i < 256 else f['static1']) \
            else COMPRESSED_PAYLOAD
        base = (f['off0'] if i < 256 else f['off1']) + psize * int(f['off'][i])
        raw = payload[base:base + 2048]
        h = np.frombuffer(raw.tobytes(), '<u2').astype(np.uint16)
        d = h[:512].view(np.uint16).astype(np.uint32)
        t = h[512:1024].view(np.uint16).astype(np.uint32)

        def half(u):
            return np.frombuffer(u.astype(np.uint16).tobytes(),
                                 np.float16).astype(np.float32)
        return (half(d).reshape(8, 8, 8),      # [k, j, i]
                half(t).reshape(8, 8, 8))

    def walk(node_idx, level, ox, oy, oz):
        """level counts down; cell size at this node = 8**(level+1)."""
        f = _node_fields(nodes[node_idx])
        cell = 8 ** level                     # child block size in voxels
        for i in range(512):
            if _child_empty(f, i):
                continue
            ix, iy, iz = i & 7, (i >> 3) & 7, (i >> 6) & 7
            cx, cy, cz = ox + ix * cell, oy + iy * cell, oz + iz * cell
            if f['leaf']:
                d, t = brick(f, i)
                dens[cz:cz + 8, cy:cy + 8, cx:cx + 8] = d
                temp[cz:cz + 8, cy:cy + 8, cx:cx + 8] = t
            else:
                child = (f['noff1'] if i > 255 else f['noff0']) \
                    + int(f['off'][i])
                walk(child, level - 1, cx, cy, cz)

    # the root node's children are cells of 8**(depth-1) voxels; at depth=2
    # the root is a leaf whose 512 children are 8^3 payload bricks.
    walk(root, depth - 1, 0, 0, 0)

    while dens.shape[0] > max_res:
        dens = dens.reshape(dens.shape[0] // 2, 2, dens.shape[1] // 2, 2,
                            dens.shape[2] // 2, 2).mean(axis=(1, 3, 5))
        temp = temp.reshape(temp.shape[0] // 2, 2, temp.shape[1] // 2, 2,
                            temp.shape[2] // 2, 2).max(axis=(1, 3, 5))
    return VolFile(dens, temp, hd['aabb'], hd['voxel_size'], hd['loc'],
                   hd['rot'], int(hd['shaderid']))

