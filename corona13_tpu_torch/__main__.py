"""Command-line front end (corona13_tpu/__main__.py): pt, ptdl, lt, bdpt,
ptlt, bdpt1, ppm, kmlt, vmlt and vis.

    python -m corona13_tpu_torch scene.nra2 -s 64 -w 1024 -h 576 -x render
    python -m corona13_tpu_torch scene.nra2 --media --device cpu
    python -m corona13_tpu_torch scene.nra2 --dbor
    python -m corona13_tpu_torch scene.nra2 --sampler bdpt
    python -m corona13_tpu_torch scene.nra2 --sampler kmlt
    python -m corona13_tpu_torch scene.nra2 --sampler vis --aov depth
    python -m corona13_tpu_torch scene.nra2 -s 4 --profile trace.json

Writes <output>_fb00.pfm (camera XYZ), a sidecar <output>.txt and a
resumable <output>.fb checkpoint; ``--dbor`` also the cascade levels
<output>_dborNN.pfm (pt and ptdl only, as in the JAX CLI); ``--sampler vis``
only the AOV image.  Every sampler but vis renders through
``render.render`` (``PTConfig.sampler``; ``--dbor`` through its cascade).
Renders on CUDA unless ``--device cpu`` is given;
without a CUDA device it exits non-zero rather than fall back.
``--profile PATH`` loads and renders under ``torch.profiler`` (the host's
ops, and the card's kernels on CUDA), writes its Chrome trace to PATH, in
which the program's spans (``corona13_tpu_torch/tracing.py``) and the
card's kernels lie on one clock, and prints each span's host ms, device
ms and calls, the set-up seconds, the nvcc runs and the hand-written
kernels' launches by key.
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
    p.add_argument('--aov', default='normals',
                   choices=['normals', 'depth', 'prim', 'shader', 'uv'],
                   help='AOV kind for --sampler vis')
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
                   help='density-based outlier rejection: splat pt/ptdl '
                        'through the log2 luminance cascade and write the '
                        'trust-merged image plus the per-level buffers')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    p.add_argument('--profile', default=None, metavar='PATH',
                   help='render under torch.profiler, write its Chrome '
                        'trace to PATH and print the time of each span')
    args = p.parse_args(argv)

    import torch
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        print('[corona13_tpu_torch] no CUDA device; pass --device cpu to '
              'render on the CPU', file=sys.stderr)
        return 1

    if args.profile is None:
        return _run(args, device)
    from torch.profiler import ProfilerActivity, profile

    from . import tracing
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == 'cuda' else [])
    with profile(activities=acts) as prof:
        rc = _run(args, device)
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(args.profile)
    print(f'[corona13_tpu_torch] wrote the profile {args.profile}')
    for line in tracing.report(prof.events()):
        print(line)
    return rc


def _run(args, device):
    """Load the scene and render as ``args`` say; the exit code."""
    import torch

    from . import render as render_mod
    from . import scene as scene_mod
    from .io import fb as fb_io
    from .io import pfm as pfm_io
    from .ops import splat as splat_mod
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
        equiangular=args.equiangular,
        sampler={'ptdl': 'pt', 'vis': 'pt'}.get(args.sampler, args.sampler))
    if args.sampler == 'vis':
        from .samplers import vis as vis_mod
        with torch.no_grad():
            img = vis_mod.render_aov(scene, cfg, 0, kind=args.aov)
        pfm_io.write_pfm(args.output + '_fb00.pfm', img.cpu().numpy())
        print(f'[corona13_tpu_torch] wrote {args.output}_fb00.pfm '
              f'({args.aov})')
        return 0

    fbf = fb_io.Framebuffer.open(args.output + '.fb', args.width, args.height,
                                 retain=args.retain_framebuffer)
    if fbf.spp:
        print(f'[corona13_tpu_torch] resuming at {fbf.spp} spp from '
              f'{args.output}.fb')
    if args.dbor and args.sampler in ('pt', 'ptdl'):
        # the ptdl_dbor technique (reference src/sampler.d/ptdl_dbor.c): the
        # samples of each progression land in the log2-luminance cascade;
        # the written image is the trust-merged reassembly
        fbs = _render_dbor(scene, cfg, fbf.spp, args.spp)
        merged = splat_mod.dbor_merge(fbs).cpu().numpy()
        for k in range(splat_mod.N_DBOR):
            pfm_io.write_pfm(f'{args.output}_dbor{k:02d}.pfm',
                             fbs[k].cpu().numpy())
        fbf.accumulate(merged, args.spp)
    else:
        # a resumed render goes on at the next sample index; pt and ptdl
        # start at 0, as in the JAX CLI
        res = render_mod.render(
            scene, cfg, spp=args.spp, batch=args.batch, progress=True,
            first=0 if cfg.sampler == 'pt' else fbf.spp)
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


def _render_dbor(scene, cfg, first: int, spp: int):
    """Progressions first .. first+spp-1 splatted through the DBOR cascade;
    returns it, [N_DBOR, H, W, 3], on the scene's device."""
    import torch

    from .ops import splat as splat_mod
    from .samplers import pt as pt_mod
    from .spectral import cie
    dev = scene.device
    pixels = torch.arange(cfg.width * cfg.height, dtype=torch.int64,
                          device=dev)
    fbs = torch.zeros((splat_mod.N_DBOR, cfg.height, cfg.width, 3),
                      dtype=torch.float32, device=dev)
    t0 = time.time()
    with torch.no_grad():
        for s in range(first, first + spp):
            accum, lam, pi, pj = pt_mod.sample_paths(scene, cfg, s, pixels)
            xyz = cie.spectral_to_xyz(lam, pt_mod._finite(accum))
            fbs = splat_mod.splat_dbor(fbs, pi, pj, xyz)
            done = s + 1 - first
            print(f'  [{done}/{spp}] {(time.time() - t0) / done:.3f}s/frame',
                  flush=True)
    return fbs


if __name__ == '__main__':
    sys.exit(main())
