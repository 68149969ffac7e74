"""Command-line front end (corona13_tpu/__main__.py), pt/ptdl only:

    python -m corona13_tpu_torch scene.nra2 -s 64 -w 1024 -h 576 -x render
    python -m corona13_tpu_torch scene.nra2 --media --device cpu

Writes <output>_fb00.pfm (camera XYZ), a sidecar <output>.txt and a
resumable <output>.fb checkpoint.  Renders on CUDA unless ``--device cpu``
is given; without a CUDA device it exits non-zero rather than fall back.
The other samplers and ``--dbor`` are not ported yet and exit non-zero.
"""

from __future__ import annotations

import argparse
import sys
import time

_SAMPLERS = ['pt', 'ptdl', 'lt', 'ptlt', 'bdpt', 'bdpt1', 'kmlt', 'vmlt',
             'ppm', 'vis']


def main(argv=None):
    p = argparse.ArgumentParser(
        prog='corona13_tpu_torch', add_help=False,
        description='spectral path tracer on PyTorch/CUDA (corona-13 parity)')
    p.add_argument('--help', action='help')
    p.add_argument('scene', help='.nra2 scene file')
    p.add_argument('-s', '--spp', type=int, default=16,
                   help='progressions (samples per pixel)')
    p.add_argument('-w', '--width', type=int, default=1024)
    p.add_argument('-h', '--height', type=int, default=576)
    p.add_argument('-x', '--output', default='render', help='output basename')
    p.add_argument('-c', '--cam', default=None, help='.cam camera file')
    p.add_argument('--sampler', default='ptdl', choices=_SAMPLERS)
    p.add_argument('--max-verts', type=int, default=8)
    p.add_argument('--mf', type=int, default=4,
                   help='hero wavelengths per path')
    p.add_argument('--batch', type=int, default=0,
                   help='progressions per step (0 = auto)')
    p.add_argument('--media', action='store_true',
                   help='enable participating media')
    p.add_argument('--equiangular', action='store_true',
                   help='equiangular distance sampling for volume NEE')
    p.add_argument('--pointsampler', default='rand',
                   choices=['rand', 'halton'])
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--retain-framebuffer', action='store_true',
                   help='resume accumulation from an existing .fb')
    p.add_argument('--dbor', action='store_true',
                   help='density-based outlier rejection (not ported yet)')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    if args.sampler not in ('pt', 'ptdl') or args.dbor:
        what = '--dbor' if args.dbor else f'--sampler {args.sampler}'
        print(f'[corona13_tpu_torch] {what} is not ported yet',
              file=sys.stderr)
        return 2

    import torch
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        print('[corona13_tpu_torch] no CUDA device; pass --device cpu to '
              'render on the CPU', file=sys.stderr)
        return 1

    from . import render as render_mod
    from . import scene as scene_mod
    from .io import fb as fb_io
    from .io import pfm as pfm_io
    from .samplers import pt as pt_mod

    # the reference 32-aligns view dims and refits the film back to the
    # pixel aspect on every camera load (view.c:295-297, 938-947)
    args.width = scene_mod.align32(args.width)
    args.height = scene_mod.align32(args.height)

    t0 = time.time()
    scene, _ = scene_mod.load_scene(args.scene, args.cam, device=device)
    scene = scene_mod.fit_film(scene, args.width, args.height)
    name = (torch.cuda.get_device_name(device) if device.type == 'cuda'
            else 'cpu')
    print(f'[corona13_tpu_torch] scene loaded in {time.time() - t0:.1f}s on '
          f'{name}: {scene.geom.n_tris} tris, {scene.geom.n_spheres} spheres, '
          f'{scene.geom.n_lines} lines, {scene.lights.n_lights} lights',
          flush=True)

    cfg = pt_mod.PTConfig(
        width=args.width, height=args.height, max_verts=args.max_verts,
        mf=args.mf, use_nee=(args.sampler != 'pt'),
        pointsampler=args.pointsampler, seed=args.seed, media=args.media,
        equiangular=args.equiangular)
    fbf = fb_io.Framebuffer.open(args.output + '.fb', args.width, args.height,
                                 retain=args.retain_framebuffer)
    if fbf.spp:
        print(f'[corona13_tpu_torch] resuming at {fbf.spp} spp from '
              f'{args.output}.fb')
    res = render_mod.render(scene, cfg, spp=args.spp, batch=args.batch,
                            progress=True)
    fbf.accumulate(res.fb, res.spp)
    fbf.flush(iso=float(scene.camera.iso))
    img = fbf.image
    pfm_io.write_pfm(args.output + '_fb00.pfm', img)
    with open(args.output + '.txt', 'w') as f:
        f.write('corona13_tpu_torch render\n')
        f.write(f'scene    : {args.scene}\n')
        f.write(f'sampler  : {args.sampler}\n')
        f.write(f'device   : {name}\n')
        f.write(f'spp      : {fbf.spp}\n')
        f.write(f'size     : {args.width}x{args.height}\n')
        f.write(f'mean     : {float(img.mean()):.6f}\n')
    print(f'[corona13_tpu_torch] wrote {args.output}_fb00.pfm '
          f'({fbf.spp} spp total)')
    return 0


if __name__ == '__main__':
    sys.exit(main())
