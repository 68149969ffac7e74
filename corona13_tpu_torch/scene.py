"""Scene assembly: .nra2 + .geo + .cam -> device tables
(corona13_tpu/scene.py).

The reference's runtime shader plugins are resolved at load time: every
scene material is flattened into one row of a SoA material table (``mult``
pre-shader chains collapse into slot assignments) and the BSDF host
becomes an enum dispatched on the device.  Spectral albedos are fitted to
sigmoid-polynomial coefficients at load.

``load_scene`` reads texture lines (into a spectral-coefficient atlas),
``daylight`` skies and the heterogeneous grid into the same flags and
tables as the JAX package; daylight raises NotImplementedError when
rendered.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .io import cam as cam_io
from .io import fb as fb_io
from .io import geo as geo_io
from .io import nra2 as nra2_io
from .io import pfm as pfm_io
from .models.bsdf import DIELECTRIC, DIFFDIEL, DIFFUSE, HAIR, METAL, NULL  # noqa: F401
from .models.medium_hete import VolGrid
from .ops.trace import DeviceGeometry, make_device_geometry
from .spectral import fresnel_data, rgb2spec

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'data')

# sky kinds
SKY_BLACK = 0
SKY_CONST = 1
SKY_CLOUDY = 2
SKY_ENVMAP = 3
SKY_DAYLIGHT = 4


@dataclasses.dataclass
class MaterialTable:
    """SoA of resolved materials; one row per scene shader id."""
    kind: torch.Tensor          # [M] int64 host bsdf
    d_coeff: torch.Tensor       # [M, 3] sigmoid coeffs for diffuse albedo
    d_mul: torch.Tensor         # [M]
    g_coeff: torch.Tensor       # [M, 3] glossy
    g_mul: torch.Tensor         # [M]
    e_coeff: torch.Tensor       # [M, 3] emission
    e_mul: torch.Tensor         # [M]
    roughness: torch.Tensor     # [M]
    ior_nd: torch.Tensor        # [M] dielectric n_d
    ior_abbe: torch.Tensor      # [M] dielectric Abbe number
    use_checker: torch.Tensor   # [M] bool: diffuse albedo from the IT8 chart
    checker_spectra: torch.Tensor  # [140, 36] measured patch reflectances
    med_mut_coeff: torch.Tensor  # [M, 3]
    med_mut_mul: torch.Tensor   # [M]
    med_mus_coeff: torch.Tensor  # [M, 3]
    med_mus_mul: torch.Tensor   # [M]
    med_g: torch.Tensor         # [M] HG mean cosine
    med_enabled: torch.Tensor   # [M] bool
    tex_idx: torch.Tensor       # [M] int64 (-1 = none)
    tex_slot: torch.Tensor      # [M] int64: 0=d 1=g 2=e
    tex_mul: torch.Tensor       # [M]
    fres_n: torch.Tensor        # [M, 7]
    fres_k: torch.Tensor        # [M, 7]


@dataclasses.dataclass
class LightTable:
    """Flat emitter CDF over prims, area*L weighted."""
    prim: torch.Tensor         # [K] int64 global prim id of each light prim
    cdf: torch.Tensor          # [K] inclusive normalized CDF
    weight: torch.Tensor       # [K] L / sum(L*A): NEE area pdf of each prim
    area: torch.Tensor         # [K] prim area
    prim_weight: torch.Tensor  # [P] global prim -> light weight (0 if none)

    @property
    def n_lights(self):
        return self.prim.shape[0]


@dataclasses.dataclass
class CameraP:
    """Device camera (thin-lens parameters as 0-d float32 tensors)."""
    pos: torch.Tensor
    pos_t1: torch.Tensor
    orient: torch.Tensor
    orient_t1: torch.Tensor
    focus: torch.Tensor
    focal_length: torch.Tensor
    film_width: torch.Tensor
    film_height: torch.Tensor
    f_stop: torch.Tensor
    exposure_time: torch.Tensor
    iso: torch.Tensor
    crop_factor: torch.Tensor | None = None


@dataclasses.dataclass
class Scene:
    geom: DeviceGeometry
    materials: MaterialTable
    lights: LightTable
    camera: CameraP
    prim_shader: torch.Tensor   # [P] int64 global prim -> material id
    sky_kind: torch.Tensor      # 0-d int64
    sky_coeff: torch.Tensor     # [3] emission spectrum coeffs (const sky)
    sky_mul: torch.Tensor       # 0-d
    # BSDF kinds present: absent branches are skipped
    kinds_used: tuple = (0, 1, 2)
    has_envmap: bool = False
    has_daylight: bool = False
    has_hete: bool = False
    has_vol_emission: bool = False
    exterior_med: int = -1
    has_textures: bool = False
    vol: VolGrid | None = None  # heterogeneous medium grid (medium_hete)
    # image textures as spectral coefficients: [n_tex, H, W, 4] (c0..c2,
    # mul), padded to the largest; tex_dims [n_tex, 2] int64 (h, w)
    tex_atlas: torch.Tensor | None = None
    tex_dims: torch.Tensor | None = None

    @property
    def device(self):
        return self.prim_shader.device


@dataclasses.dataclass
class _ResolvedMat:
    kind: int = DIFFUSE
    d_rgb: tuple = (0.0, 0.0, 0.0)
    g_rgb: tuple = (0.0, 0.0, 0.0)
    e_rgb: tuple = (0.0, 0.0, 0.0)
    roughness: float = 1.0
    ior_nd: float = 1.5
    ior_abbe: float = 50.0
    use_checker: bool = False
    med_mfp_rgb: tuple = (0.0, 0.0, 0.0)
    med_albedo_rgb: tuple = (0.0, 0.0, 0.0)
    med_g: float = 0.0
    med_enabled: bool = False
    emissive_L: float = 0.0
    hete_file: str = ''
    hete_params: tuple = ()
    tex_file: str = ''
    tex_slot: int = 0
    tex_mul: float = 1.0
    metal_name: str = 'default'


def _exterior_med(desc: nra2_io.SceneDesc) -> int:
    """Material id of the `exterior <shader>` line's target (-1 none)."""
    for sh in desc.shaders:
        if sh.name == 'exterior' and sh.args:
            return int(sh.args[0])
    return -1


def _resolve_materials(desc: nra2_io.SceneDesc) -> list[_ResolvedMat]:
    """Flatten shader descriptions incl. mult chains into material rows."""
    out = []
    for idx, sh in enumerate(desc.shaders):
        m = _ResolvedMat()
        _apply_shader(desc, idx, sh, m, is_host=True)
        out.append(m)
    return out


def _apply_shader(desc, idx, sh, m: _ResolvedMat, is_host: bool):
    name = sh.name
    a = sh.args
    if name == 'diffuse':
        m.kind = DIFFUSE
    elif name == 'color':
        slot = a[0]
        rgb = tuple(float(x) for x in a[1:4])
        rough = float(a[4]) if len(a) > 4 else None
        if slot == 'd':
            m.d_rgb = rgb
        elif slot == 'g':
            m.g_rgb = rgb
            if rough is not None:
                m.roughness = rough
        elif slot == 's':
            m.g_rgb = rgb  # the specular slot folds into rg
        elif slot == 'e':
            m.e_rgb = rgb
            if rough is not None and rough != 1.0:
                m.roughness = rough
            m.emissive_L = max(rgb)
        elif slot == 'v':
            m.med_albedo_rgb = rgb
        if slot == 'd' and rough is not None:
            m.roughness = rough
    elif name == 'colorcheckersg':
        m.use_checker = True
        # neutral diffuse base: rd = d_mul * chart reflectance
        if m.d_rgb == (0.0, 0.0, 0.0):
            m.d_rgb = (1.0, 1.0, 1.0)
    elif name == 'dielectric':
        m.kind = DIELECTRIC
        m.ior_nd = float(a[0])
        m.ior_abbe = float(a[1]) if len(a) > 1 else 50.0
        if m.g_rgb == (0.0, 0.0, 0.0):
            m.g_rgb = (1.0, 1.0, 1.0)
    elif name == 'hair':
        # hair <eumelanin> <pheomelanin>: melanin concentrations -> fiber
        # albedo; rg stays the specular lobe
        m.kind = HAIR
        eu = float(a[0]) if len(a) > 0 else 0.1
        ph = float(a[1]) if len(a) > 1 else 0.5
        absorb = np.array([0.419, 0.697, 1.37]) * eu + \
            np.array([0.187, 0.4, 1.05]) * ph
        alb = np.exp(-absorb).clip(0.0, 1.0)
        m.d_rgb = tuple(float(x) for x in alb)
        if m.g_rgb == (0.0, 0.0, 0.0):
            m.g_rgb = (0.35, 0.35, 0.35)
        if m.roughness == 1.0:
            m.roughness = 0.15
    elif name == 'diffdiel':
        # diffdiel <n_d> [abbe]: diffuse-coated dielectric
        m.kind = DIFFDIEL
        m.ior_nd = float(a[0]) if a else 1.5
        m.ior_abbe = float(a[1]) if len(a) > 1 else 50.0
        if m.g_rgb == (0.0, 0.0, 0.0):
            m.g_rgb = (1.0, 1.0, 1.0)
    elif name == 'metal' or name == 'mmetal':
        m.kind = METAL
        if a:
            m.metal_name = a[0]
        if m.g_rgb == (0.0, 0.0, 0.0):
            m.g_rgb = (1.0, 1.0, 1.0)
    elif name in ('medium_rgb', 'medium_poe'):
        m.med_mfp_rgb = tuple(float(x) for x in a[0:3])
        m.med_g = float(a[3]) if len(a) > 3 else 0.0
        m.med_enabled = True
    elif name == 'medium_hete':
        # medium_hete <g0> <g1> <sigma_s> <sigma_t> <sigma_e> <vol file>;
        # as a shape shader it is a pass-through volume boundary
        if is_host:
            m.kind = NULL
        m.hete_params = tuple(float(x) for x in a[0:5])
        m.hete_file = a[5] if len(a) > 5 else ''
        m.med_g = float(a[0]) if a else 0.0
        m.med_enabled = True
    elif name == 'exterior':
        # exterior <medium shader id> [light]: the scene's global exterior
        # medium (_exterior_med); its medium props also resolve here
        if a:
            pi = int(a[0])
            _apply_shader(desc, pi, desc.shaders[pi], m, is_host=False)
    elif name == 'texture':
        # texture <slot char d/g/e/...> <file.fb|.pfm> [mul]
        if len(a) >= 2:
            m.tex_slot = {'d': 0, 'g': 1, 'e': 2}.get(a[0], 0)
            m.tex_file = a[1]
            m.tex_mul = float(a[2]) if len(a) > 2 else 1.0
    elif name == 'mult':
        # mult <num> <pre...> <host>
        num = int(a[0])
        pres = [int(x) for x in a[1:1 + num]]
        host = int(a[1 + num])
        if host < 0:
            host = idx + host
        for p in pres:
            pi = idx + p if p < 0 else p
            _apply_shader(desc, pi, desc.shaders[pi], m, is_host=False)
        _apply_shader(desc, host, desc.shaders[host], m, is_host=True)
    elif name == 'interior':
        # interior <medium shader id>
        if a:
            pi = int(a[0])
            _apply_shader(desc, pi, desc.shaders[pi], m, is_host=False)
    # unknown shaders keep the defaults


def _fit(rgbs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    coeff, mul = rgb2spec.fit_coeff_scaled(rgbs, space='ergb')
    # exact zero for black inputs (the sigmoid floor is ~1e-3, which would
    # otherwise make every surface an emitter in the light CDF)
    mul = np.where(rgbs.max(axis=-1) <= 0.0, 0.0, mul)
    return coeff.astype(np.float32), mul.astype(np.float32)


def _texture_coeffs(path: str) -> np.ndarray:
    """One texture file as [H, W, 4] spectral coefficients and multiplier."""
    if path.endswith('.fb'):
        c3 = fb_io.Framebuffer.load(path).data.astype(np.float32)
        return np.concatenate(
            [c3[..., :3], np.ones(c3.shape[:2] + (1,), np.float32)], axis=-1)
    rgb = pfm_io.read_pfm(path).astype(np.float32)
    c, mul = _fit(rgb.reshape(-1, 3))
    return np.concatenate([c, mul[:, None]],
                          axis=-1).reshape(rgb.shape[:2] + (4,))


def fit_film(scene: Scene, width: int, height: int) -> Scene:
    """Refit the camera film back to the render aspect: the 35mm back
    scaled by 1/crop_factor, the other side following the pixel aspect
    (the reference's view_cam_read)."""
    cam = scene.camera
    f32 = dict(dtype=torch.float32, device=cam.focus.device)
    crop = (cam.crop_factor if cam.crop_factor is not None
            else torch.tensor(1.0, **f32))
    full = torch.tensor(cam_io.FULL_FRAME_WIDTH, **f32) / crop
    if width > height:
        fw = full
        fh = full * (height / width)
    else:
        fh = full
        fw = full * (width / height)
    return dataclasses.replace(scene, camera=dataclasses.replace(
        cam, film_width=fw, film_height=fh))


def _concat(parts, empty_shape, dtype):
    return np.concatenate(parts) if parts else np.zeros(empty_shape, dtype)


def _tensor(a, device, dtype=None):
    """numpy -> contiguous tensor on ``device``; float64 becomes float32
    and int32 int64 (torch's index type) unless ``dtype`` says."""
    a = np.asarray(a)
    if dtype is None:
        dtype = {np.dtype(np.float64): np.float32,
                 np.dtype(np.int32): np.int64}.get(a.dtype, a.dtype)
    return torch.as_tensor(np.ascontiguousarray(a.astype(dtype)),
                           device=device)


def material_table(mats: list[_ResolvedMat], tex_idx: np.ndarray, *,
                   device) -> MaterialTable:
    """The SoA material table of resolved materials, spectral albedos,
    emission and medium coefficients fitted here; tex_idx [M] (-1 none)."""
    t = lambda a, dtype=None: _tensor(a, device, dtype)
    rows = lambda attr: np.array([getattr(m, attr) for m in mats], np.float32)
    d_c, d_m = _fit(rows('d_rgb'))
    g_c, g_m = _fit(rows('g_rgb'))
    e_c, e_m = _fit(rows('e_rgb'))
    mfp = rows('med_mfp_rgb')
    with np.errstate(divide='ignore'):
        mut = np.where(mfp > 0.0, 1.0 / np.maximum(mfp, 1e-20), 0.0)
    mut_c, mut_m = _fit(mut.astype(np.float32))
    mus_c, mus_m = _fit(rows('med_albedo_rgb'))
    checker = np.load(os.path.join(_DATA, 'colorchecker_sg.npy'))
    conductors = [fresnel_data.get_conductor(m.metal_name) for m in mats]
    return MaterialTable(
        kind=t([m.kind for m in mats], np.int64),
        d_coeff=t(d_c), d_mul=t(d_m), g_coeff=t(g_c), g_mul=t(g_m),
        e_coeff=t(e_c), e_mul=t(e_m),
        roughness=t(rows('roughness')), ior_nd=t(rows('ior_nd')),
        ior_abbe=t(rows('ior_abbe')),
        use_checker=t([m.use_checker for m in mats], bool),
        checker_spectra=t(checker, np.float32),
        med_mut_coeff=t(mut_c), med_mut_mul=t(mut_m),
        med_mus_coeff=t(mus_c), med_mus_mul=t(mus_m),
        med_g=t(rows('med_g')),
        med_enabled=t([m.med_enabled for m in mats], bool),
        tex_idx=t(tex_idx, np.int64),
        tex_slot=t([m.tex_slot for m in mats], np.int64),
        tex_mul=t(rows('tex_mul')),
        fres_n=t(np.stack([c[0] for c in conductors])),
        fres_k=t(np.stack([c[1] for c in conductors])))


def light_table(tri_v: np.ndarray, tri_sh: np.ndarray, n_prims: int,
                materials: MaterialTable) -> LightTable:
    """Flat emitter CDF over the emissive triangles: weight = area * L_avg
    with L_avg = mul * mean(sigmoid at 400/480/560/660 nm), like the
    reference's color.c shape_init (lights.d/list.c:56-128)."""
    device = materials.e_mul.device
    t = lambda a, dtype=None: _tensor(a, device, dtype)
    lam4 = torch.tensor([400.0, 480.0, 560.0, 660.0])
    e_eval = rgb2spec.eval_coeff(materials.e_coeff.cpu()[:, None, :],
                                 lam4[None, :]).numpy()
    L_mat = materials.e_mul.cpu().numpy() * e_eval.mean(axis=1)
    areas = 0.5 * np.linalg.norm(
        np.cross(tri_v[:, 1] - tri_v[:, 0], tri_v[:, 2] - tri_v[:, 0]),
        axis=-1)
    sel = np.nonzero(L_mat[tri_sh] > 0.0)[0]
    prim_weight = np.zeros(max(n_prims, 1), np.float32)
    if len(sel):
        lw = L_mat[tri_sh[sel]]
        la = areas[sel]
        wa = lw * la
        cdf = np.cumsum(wa) / wa.sum()
        weight = lw / wa.sum()   # NEE area pdf L/sum(L*A), list.c:125-128
        prim_weight[sel] = weight
    else:
        la = cdf = weight = np.zeros((0,), np.float32)
    return LightTable(prim=t(sel, np.int64), cdf=t(cdf, np.float32),
                      weight=t(weight, np.float32), area=t(la, np.float32),
                      prim_weight=t(prim_weight))


def load_scene(nra2_path: str, cam_path: str | None = None,
               searchpath: str | None = None,
               device='cuda') -> tuple[Scene, cam_io.CameraData]:
    """Load a .nra2 scene with its .geo shapes, .cam camera and .vol grid
    into device tables on ``device``: the card unless the caller asks for
    ``device='cpu'``; without a card the default raises torch's error."""
    from .io import vol as vol_io
    from .models import medium_hete as hete_mod
    desc = nra2_io.parse_nra2(nra2_path, searchpath)
    mats = _resolve_materials(desc)

    # --- geometry: all shapes concatenated into global prim arrays
    tri_v, tri_v1, tri_n, tri_uvs, tri_half, tri_sh = [], [], [], [], [], []
    sph_c, sph_c1, sph_r, sph_sh = [], [], [], []
    lin_vtx, lin_rad, lin_sh = [], [], []
    any_motion = False
    for shp in desc.shapes:
        if not os.path.exists(shp.geo_path):
            # the reference discards shapes whose .geo is missing
            # (prims_load, src/prims.c:784-788)
            print(f"[scene] could not load geo `{shp.geo_path}', skipping shape")
            continue
        g = geo_io.load_geo(shp.geo_path)
        any_motion = any_motion or g.has_motion
        tri_v.append(g.tri_vtx)
        tri_v1.append(g.tri_vtx_t1)
        tri_n.append(g.tri_ns)
        tri_uvs.append(g.tri_uv)
        tri_half.append(g.tri_quad_half)
        tri_sh.append(np.full(len(g.tri_vtx), shp.shader, np.int32))
        sph_c.append(g.sph_center)
        sph_c1.append(g.sph_center_t1)
        sph_r.append(g.sph_radius)
        sph_sh.append(np.full(len(g.sph_radius), shp.shader, np.int32))
        lin_vtx.append(g.line_vtx)
        lin_rad.append(g.line_radii)
        lin_sh.append(np.full(len(g.line_radii), shp.shader, np.int32))
    f32, i32 = np.float32, np.int32
    tri_v = _concat(tri_v, (0, 3, 3), f32)
    tri_v1 = _concat(tri_v1, (0, 3, 3), f32)
    tri_sh = _concat(tri_sh, (0,), i32)
    sph_c1 = _concat(sph_c1, (0, 3), f32)
    sph_sh = _concat(sph_sh, (0,), i32)
    lin_sh = _concat(lin_sh, (0,), i32)
    geom = make_device_geometry(
        tri_v=tri_v, tri_vn=_concat(tri_n, (0, 3, 3), f32),
        tri_uv=_concat(tri_uvs, (0, 3, 2), f32),
        tri_quad_half=_concat(tri_half, (0,), np.uint8).astype(i32),
        tri_shader=tri_sh, sph_c=_concat(sph_c, (0, 3), f32),
        sph_r=_concat(sph_r, (0,), f32), sph_shader=sph_sh,
        line_vtx=_concat(lin_vtx, (0, 2, 3), f32),
        line_radii=_concat(lin_rad, (0, 2), f32), line_shader=lin_sh,
        tri_v_t1=tri_v1 if any_motion else None,
        sph_c_t1=sph_c1 if any_motion else None, device=device)
    prim_shader = np.concatenate([tri_sh, sph_sh, lin_sh])

    t = lambda a, dtype=None: _tensor(a, device, dtype)
    f0 = lambda x: torch.tensor(float(x), dtype=torch.float32, device=device)

    # texture atlas: .pfm (RGB, fitted to coefficients here) or .fb
    # (coefficient framebuffers already fitted) in one padded array
    tex_files = []
    tex_idx = np.full(len(mats), -1, i32)
    for mi, m in enumerate(mats):
        if not m.tex_file:
            continue
        tp = m.tex_file
        if not os.path.isabs(tp):
            tp = os.path.join(os.path.dirname(nra2_path), tp)
        if not os.path.exists(tp):
            print(f"[scene] could not load texture `{m.tex_file}'")
            continue
        if tp not in tex_files:
            tex_files.append(tp)
        tex_idx[mi] = tex_files.index(tp)
    tex_atlas = tex_dims = None
    if tex_files:
        imgs = [_texture_coeffs(tp) for tp in tex_files]
        atlas = np.zeros((len(imgs), max(i.shape[0] for i in imgs),
                          max(i.shape[1] for i in imgs), 4), f32)
        dims = np.zeros((len(imgs), 2), i32)
        for k, img in enumerate(imgs):
            atlas[k, :img.shape[0], :img.shape[1]] = img
            dims[k] = img.shape[:2]
        tex_atlas = t(atlas)
        tex_dims = t(dims, np.int64)

    materials = material_table(mats, tex_idx, device=device)
    lights = light_table(tri_v, tri_sh, len(prim_shader), materials)

    # --- camera
    if cam_path is None:
        cand = os.path.join(os.path.dirname(nra2_path), 'test01.cam')
        cam_path = cand if os.path.exists(cand) else None
    cd = cam_io.read_cam(cam_path) if cam_path else cam_io.CameraData(
        pos=np.zeros(3, f32), pos_t1=np.zeros(3, f32),
        orient=np.array([1, 0, 0, 0], f32),
        orient_t1=np.array([1, 0, 0, 0], f32))
    camera = CameraP(
        pos=t(cd.pos, f32), pos_t1=t(cd.pos_t1, f32),
        orient=t(cd.orient, f32), orient_t1=t(cd.orient_t1, f32),
        focus=f0(cd.focus), focal_length=f0(cd.focal_length),
        film_width=f0(cd.film_width), film_height=f0(cd.film_height),
        f_stop=f0(cd.f_stop), exposure_time=f0(cd.exposure_time),
        iso=f0(cd.iso), crop_factor=f0(cd.crop_factor))

    # --- sky (daylight only sets its kind and flag: not ported)
    sky_kind = {'black': SKY_BLACK, 'sky_const': SKY_CONST,
                'const': SKY_CONST, 'cloudy': SKY_CLOUDY,
                'cloudy_sky': SKY_CLOUDY, 'clear_sky': SKY_CLOUDY,
                'daylight': SKY_DAYLIGHT}.get(desc.sky.name, SKY_BLACK)
    sky_rgb = np.zeros(3, f32)
    if sky_kind == SKY_CONST and len(desc.sky.args) >= 3:
        sky_rgb = np.array([float(x) for x in desc.sky.args[:3]], f32)
    elif sky_kind == SKY_CLOUDY:
        sky_rgb = np.array([0.5, 0.6, 0.8], f32)
    sc, sm = _fit(sky_rgb[None])

    # --- heterogeneous medium grid (at most one medium_hete per scene)
    vol_grid = None
    has_vol_emission = False
    for mi, m in enumerate(mats):
        if not m.hete_file:
            continue
        vp = m.hete_file
        if not os.path.isabs(vp):
            vp = os.path.join(os.path.dirname(nra2_path), vp)
        if not os.path.exists(vp):
            print(f"[scene] could not open volume data `{m.hete_file}'"
                  " — shape renders as empty boundary")
            continue
        g0, _g1, s_s, s_t, s_e = (tuple(m.hete_params) + (0.,) * 5)[:5]
        vol_grid = hete_mod.from_volfile(vol_io.read_vol(vp), s_s, s_t, s_e,
                                         g0, mat_id=mi, device=device)
        has_vol_emission = s_e > 0.0
        break

    scene = Scene(
        geom=geom, materials=materials, lights=lights, camera=camera,
        prim_shader=t(prim_shader, np.int64),
        sky_kind=torch.tensor(sky_kind, dtype=torch.int64, device=device),
        sky_coeff=t(sc[0]), sky_mul=f0(sm[0]),
        kinds_used=tuple(sorted({m.kind for m in mats})),
        has_daylight=sky_kind == SKY_DAYLIGHT, has_hete=vol_grid is not None,
        has_vol_emission=has_vol_emission, exterior_med=_exterior_med(desc),
        has_textures=bool(tex_files), vol=vol_grid,
        tex_atlas=tex_atlas, tex_dims=tex_dims)
    return scene, cd


def align32(n: int) -> int:
    """Round a view dimension up to a multiple of 32 like view_init
    (reference src/view.c:295-297)."""
    return (n + 31) & ~31
