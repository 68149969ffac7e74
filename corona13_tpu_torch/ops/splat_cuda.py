"""The general splat's binned sum as one chain of CUDA kernels a call.

``ops/splat.py`` makes a scatter into the framebuffer reproducible by
sorting every filter tap twice by int64 keys (the pixel, then the bits of
its three colours) and summing each pixel's run serially; its 4x4 filters
first build their footprint as [N, 4, 4] tensors.  ``csrc/splat_general.cu``
forms the taps in registers (``footprint``: the 4x4 filters from the
splats' coordinates and colours; ``scatter``: taps given as flat pixels and
colours, for the box and bilin filters and the DBOR cascade), drops those
that add nothing (off the film, or +-0.0 in all three colours), bins the
rest by pixel through a count and a scan, sorts each bin by the sort
path's key and sums it serially from +0.0: the sort path's bits, with no
global sort.  Nothing is read back to the host; the kernels run on torch's
current stream.

The chain records no autograd graph: ``ops/splat.py`` wraps it in
``torch.autograd.Function``s whose backward is plain torch.

Build and launch: ``ops/cuda_lib.py`` (entry ``corona13_splat``,
``_build/libsplat_general_<hash>.so``), at the first call.
``tracing.launches`` counts the chains by entry ('splat_scatter',
'splat_footprint'); inside ``tracing.counting()`` each call records the
taps it summed (a device tensor) and the taps it was handed.
"""

from __future__ import annotations

import torch

from .. import tracing
from . import cuda_lib

FILTERS = {'blackmanharris': 0, 'gaussian': 1, 'spline': 2}
MAX_SPLATS = (1 << 27) - 1        # 16 taps a splat index an int32 bin


class _Args(cuda_lib.Args):
    """Corona13SplatArgs of csrc/splat_general.cu, field for field."""
    _p, _i = cuda_lib.PTR, cuda_lib.INT
    _fields_ = [
        ('mode', _i), ('filter', _i), ('n', _i), ('w', _i), ('h', _i),
        ('n_pix', _i), ('pix_i', _p), ('pix_j', _p), ('col', _p),
        ('flat', _p), ('keep', _p), ('vals', _p), ('fb', _p), ('out', _p),
        ('scratch', _p), ('bins', _p), ('stream', _p)]


def build():
    """``csrc/splat_general.cu``'s entry and its scratch size (ints a call
    over n_pix pixels), built and loaded once a process
    (``cuda_lib.load``)."""
    return (cuda_lib.load('splat_general', 'splat_cuda.build',
                          'corona13_splat', _Args),
            cuda_lib.load('splat_general', 'splat_cuda.build',
                          'corona13_splat_scratch', cuda_lib.INT,
                          cuda_lib.LONG))


def _check_fb(fb, dev):
    cuda_lib.check_tensors([('fb', fb, (torch.float32,), None)], dev,
                           'splat_cuda')
    if fb.dim() < 3 or fb.shape[-1] != 3:
        raise ValueError(f'splat_cuda: fb has shape {tuple(fb.shape)}, '
                         'needs [..., H, W, 3]')
    if not 0 < fb.numel() // 3 < 1 << 30:
        raise ValueError(f'splat_cuda: {fb.numel() // 3} pixels')


def _launch(entry, fb, taps, mode, n, **ptrs):
    """Run the chain into a new framebuffer; ``taps`` bins at most."""
    fn, scratch_ints = build()
    dev = fb.device
    n_pix = fb.numel() // 3
    out = torch.empty_like(fb)
    scratch = torch.empty(scratch_ints(n_pix), dtype=torch.int32, device=dev)
    bins = torch.empty((taps, 3), dtype=torch.int32, device=dev)
    a = _Args(mode=mode, n=n, n_pix=n_pix, fb=fb.data_ptr(),
              out=out.data_ptr(), scratch=scratch.data_ptr(),
              bins=bins.data_ptr() if taps else None, **ptrs)
    cuda_lib.launch(fn, a, dev, 'splat_cuda', f'splat_{entry}')
    tracing.count_splat(scratch[-1], taps)
    return out


def footprint(fb, pix_i, pix_j, col, filter_kind):
    """fb [H, W, 3] plus the splats' 4x4 filter taps (``filter_kind``
    'gaussian', 'spline' or anything else for Blackman-Harris, as
    ``splat._footprint``), out of place.  pix_i, pix_j [N], col [N, 3]:
    float32, contiguous, on fb's card."""
    dev = fb.device
    _check_fb(fb, dev)
    if fb.dim() != 3:
        raise ValueError(f'splat_cuda: fb has shape {tuple(fb.shape)}, '
                         'needs [H, W, 3]')
    n = pix_i.shape[0] if pix_i.dim() == 1 else -1
    if not 0 <= n <= MAX_SPLATS:
        raise ValueError(f'splat_cuda: pix_i has shape {tuple(pix_i.shape)}')
    f32 = (torch.float32,)
    cuda_lib.check_tensors([('pix_i', pix_i, f32, (n,)),
                            ('pix_j', pix_j, f32, (n,)),
                            ('col', col, f32, (n, 3))], dev, 'splat_cuda')
    h, w = fb.shape[0], fb.shape[1]
    return _launch('footprint', fb, 16 * n, 1, n, w=w, h=h,
                   filter=FILTERS.get(filter_kind, 0),
                   pix_i=pix_i.data_ptr(), pix_j=pix_j.data_ptr(),
                   col=col.data_ptr())


def scatter(fb, flat, keep, vals):
    """fb [..., H, W, 3] plus vals [M, 3] at the flat pixels flat [M]
    (int64, over fb's leading axes too), out of place; a tap where ``keep``
    [M] (bool, or None) is False or whose pixel is outside fb is left out."""
    dev = fb.device
    _check_fb(fb, dev)
    m = flat.shape[0] if flat.dim() == 1 else -1
    if not 0 <= m < 1 << 31:
        raise ValueError(f'splat_cuda: flat has shape {tuple(flat.shape)}')
    want = [('flat', flat, (torch.int64,), (m,)),
            ('vals', vals, (torch.float32,), (m, 3))]
    if keep is not None:
        want.append(('keep', keep, (torch.bool,), (m,)))
    cuda_lib.check_tensors(want, dev, 'splat_cuda')
    return _launch('scatter', fb, m, 0, m, flat=flat.data_ptr(),
                   keep=None if keep is None else keep.data_ptr(),
                   vals=vals.data_ptr())
