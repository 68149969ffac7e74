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


def write_vol(path: str, density, temperature=None, aabb=None,
              voxel_size=1.0, loc=(0, 0, 0), rot=(0, 0, 0), shaderid=0):
    """Write a depth-2 static .vol (res <= 64 per axis; larger grids are
    written at 64^3 by nearest sampling).  density/temperature: [Z, Y, X].
    The analogue of tools/vol/ptc2vol.c's output stage.  depth=2 matches
    the reference convention (8**depth = 64 voxels per axis, root node is
    a leaf of 8^3 bricks; depth=1 files are rejected by vol.h:295)."""
    density = np.asarray(density, np.float32)
    if temperature is None:
        temperature = np.zeros_like(density)
    temperature = np.asarray(temperature, np.float32)
    if density.shape != temperature.shape:
        raise ValueError('density/temperature shape mismatch')
    res = 64
    if density.shape != (res, res, res):
        idx = [np.clip((np.arange(res) + 0.5) / res * s, 0, s - 1
                       ).astype(np.int32) for s in density.shape]
        density = density[np.ix_(idx[0], idx[1], idx[2])]
        temperature = temperature[np.ix_(idx[0], idx[1], idx[2])]
    if aabb is None:
        aabb = [0, 0, 0, res * voxel_size, res * voxel_size,
                res * voxel_size]
    else:
        # the reference derives the voxel grid resolution from
        # aabb extent / voxel_size (vol/types.h header contract), so an
        # explicit aabb overrides the voxel size to keep res = 64; the
        # single scalar voxel size in the header requires a cubic box
        ext = [float(aabb[3 + a]) - float(aabb[a]) for a in range(3)]
        if max(ext) - min(ext) > 1e-5 * max(ext):
            raise ValueError(
                f'write_vol needs a cubic aabb (one header voxel size); '
                f'got extents {ext}')
        voxel_size = ext[0] / res

    # depth-1 file: root node is a leaf whose 512 children are bricks
    bricks0 = []          # payload bricks of children 0..255
    bricks1 = []          # payload bricks of children 256..511
    off = np.full(512, 255, np.uint8)
    empty = np.ones(512, bool)
    for i in range(512):
        ix, iy, iz = i & 7, (i >> 3) & 7, (i >> 6) & 7
        d = density[iz * 8:iz * 8 + 8, iy * 8:iy * 8 + 8, ix * 8:ix * 8 + 8]
        t = temperature[iz * 8:iz * 8 + 8, iy * 8:iy * 8 + 8,
                        ix * 8:ix * 8 + 8]
        if not np.any(d) and not np.any(t):
            continue
        # each 256-half addresses its own payload run (off is u8 <= 254)
        bricks = bricks0 if i < 256 else bricks1
        off[i] = len(bricks)
        empty[i] = False
        bricks.append((d, t))

    def pack(brs):
        out = bytearray()
        for d, t in brs:
            out += d.astype(np.float16).tobytes()
            out += t.astype(np.float16).tobytes()
        return bytes(out)

    pay0 = pack(bricks0)
    pay1 = pack(bricks1)
    # root coarse mip payload (8x8x8 means) precedes the node array
    root_d = density.reshape(8, 8, 8, 8, 8, 8).mean(axis=(1, 3, 5))
    root_t = temperature.reshape(8, 8, 8, 8, 8, 8).mean(axis=(1, 3, 5))
    root_pay = root_d.astype(np.float16).tobytes() + \
        root_t.astype(np.float16).tobytes()

    payload_off0 = 0
    payload_off1 = len(pay0)
    nodes_off = 4096 + len(pay0) + len(pay1) + len(root_pay)

    node = np.zeros(1, _NODE)
    node['doff0'] = (payload_off0 << 1) | 1          # static
    node['doff1'] = (payload_off1 << 1) | 1
    node['noff0'] = 1 if empty[255] else 0
    node['noff1'] = (1 if empty[511] else 0) | (1 << 1)   # leaf
    node['off'][0] = off

    light_off = nodes_off + _NODE.itemsize
    hd = np.zeros(1, _HEADER)
    hd['magic'] = VOL_MAGIC
    hd['version'] = VOL_VERSION | (VOL_MOTION_SAMPLES << 16)
    hd['nodes'] = nodes_off
    hd['aabb'][0] = np.asarray(aabb, np.float32)
    hd['content_box'][0] = np.asarray(aabb, np.float32)
    hd['voxel_size'] = voxel_size
    hd['rot'][0] = np.asarray(rot, np.float32)
    hd['loc'][0] = np.asarray(loc, np.float32)
    hd['depth'] = 2
    hd['light'] = light_off
    hd['isstatic'] = 1
    hd['shaderid'] = shaderid
    hd['end'] = light_off

    with open(path, 'wb') as f:
        buf = hd.tobytes()
        f.write(buf + b'\0' * (4096 - len(buf)))
        f.write(pay0)
        f.write(pay1)
        f.write(root_pay)
        f.write(node.tobytes())
