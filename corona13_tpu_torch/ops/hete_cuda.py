"""The heterogeneous grid's march as one CUDA kernel a call.

``models/medium_hete.py`` marches the density grid with eager torch ops:
every lane of the wavefront, grid or not, makes [N, 64, 3] positions and
int64 voxel indices and [N, 64] densities, optical depths and their scan,
and ``models/medium.py`` then keeps the grid lanes' results with
``torch.where``.  ``csrc/hete_march.cu`` does the same per lane in
registers, one thread a lane, and writes the grid lanes' results in place
into the homogeneous results; lanes of any other medium return at once.

Modes: ``sample`` (``medium_hete.sample_dist`` with the three
``torch.where`` of ``medium.sample_dist_scene``: scatter, distance and
weight) and ``transmit`` (``medium_hete.transmittance``: exp(-tau) into
each hero lane of the transmittance row).  Each step's optical depth is
the plain path's bit for bit; the running sum is kept in double in index
order, so cum and T differ from the card's tree reductions in the last
bits (and a scatter decision can flip where cum meets its target within
them).

The kernel records no autograd graph; where one is needed the kernel
also writes a few sums a lane (``aux``) from which ``models/medium.py``
rebuilds the plain march's gradient (not the density's: no caller makes
the grid a parameter).

Build and launch: ``ops/cuda_lib.py`` (entry ``corona13_hete_march``,
``_build/libhete_march_<hash>.so``).  The grid's constants (lo, hi,
sigma_t, sigma_s) are read by the kernel from their device tensors: no
host sync.  ``tracing.launches`` counts 'hete_sample' and
'hete_transmit'.
"""

from __future__ import annotations

import torch

from . import cuda_lib

MODES = {'sample': 0, 'transmit': 1}


class _Args(cuda_lib.Args):
    """Corona13HeteArgs of csrc/hete_march.cu, field for field."""
    _p, _i = cuda_lib.PTR, cuda_lib.INT
    _fields_ = [
        ('mode', _i), ('n', _i), ('mf', _i), ('nx', _i), ('ny', _i),
        ('nz', _i), ('mat_id', cuda_lib.LONG), ('med_is64', _i),
        ('med', _p), ('org', _p), ('dir', _p), ('t_max', _p), ('rnd', _p),
        ('density', _p), ('lo', _p), ('hi', _p), ('sigma_t', _p),
        ('sigma_s', _p), ('scat', _p), ('dist', _p), ('weight', _p),
        ('aux', _p), ('stream', _p)]


def build():
    """``csrc/hete_march.cu``'s entry, built and loaded once a process
    (``cuda_lib.load``)."""
    return cuda_lib.load('hete_march', 'hete_cuda.build',
                         'corona13_hete_march', _Args)


def march(mode, grid, med, org, w, t_max, out, *, rnd=None, scat=None,
          dist=None, aux=None):
    """Launch the march on CUDA tensors.  ``mode`` 'sample': ``t_max`` is
    t_hit, and ``scat`` [N] bool, ``dist`` [N] and ``out`` [N, MF] (the
    weight) are updated at the grid's lanes; 'transmit': ``t_max`` is the
    segment's length and ``out`` [N, MF] gets T.  ``aux``: None, or an
    [N, 3] float tensor that gets, at the grid's lanes, what a gradient
    needs (``medium.grid_sample_graph`` / ``grid_transmit_graph``): for
    'sample' the first crossing's step k, the densities' sum before it and
    the density at it (0, 0, 0 where none crosses), for 'transmit' the
    densities' sum.  Returns ``out``."""
    dev = org.device
    n = org.shape[0]
    f32, ids = (torch.float32,), (torch.int32, torch.int64)
    if n < 1 or n >= 1 << 30:
        raise ValueError(f'hete_march: {n} lanes in one launch')
    if mode not in MODES:
        raise ValueError(f'hete_march: unknown mode {mode!r}')
    if out.dim() != 2 or grid.density.dim() != 3:
        raise ValueError('hete_march: out needs [N, MF] and density [Z, Y, X]')
    want = [('med', med, ids, (n,)), ('org', org, f32, (n, 3)),
            ('w', w, f32, (n, 3)), ('t_max', t_max, f32, (n,)),
            ('out', out, f32, (n, out.shape[1])),
            ('density', grid.density, f32, None), ('lo', grid.lo, f32, (3,)),
            ('hi', grid.hi, f32, (3,)), ('sigma_t', grid.sigma_t, f32, ()),
            ('sigma_s', grid.sigma_s, f32, ())]
    if mode == 'sample':
        want += [('rnd', rnd, f32, (n,)), ('scat', scat, (torch.bool,), (n,)),
                 ('dist', dist, f32, (n,))]
    if aux is not None:
        want.append(('aux', aux, f32, (n, 3)))
    cuda_lib.check_tensors(want, dev, 'hete_march')
    fn = build()
    ptr = lambda x: None if x is None else x.data_ptr()
    nz, ny, nx = grid.density.shape
    a = _Args(mode=MODES[mode], n=n, mf=out.shape[1], nx=nx, ny=ny, nz=nz,
              mat_id=int(grid.mat_id), med_is64=int(med.dtype == torch.int64),
              med=med.data_ptr(), org=org.data_ptr(), dir=w.data_ptr(),
              t_max=t_max.data_ptr(), rnd=ptr(rnd),
              density=grid.density.data_ptr(), lo=grid.lo.data_ptr(),
              hi=grid.hi.data_ptr(), sigma_t=grid.sigma_t.data_ptr(),
              sigma_s=grid.sigma_s.data_ptr(), scat=ptr(scat),
              dist=ptr(dist), weight=out.data_ptr(), aux=ptr(aux))
    cuda_lib.launch(fn, a, dev, 'hete_march', f'hete_{mode}')
    return out
