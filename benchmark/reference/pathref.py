"""The plain reference of the path-integrator configurations: nart's path
tracer (pathintegrator.cpp) written out once more, path by path, in plain
PyTorch, from the scene file and its raw assets alone.

It shares no code with the program.  Its paths run all their bounces in
one loop, the live ones compacted after each bounce (no work queue, no
respawn, no round machine, no replay); its queries test every triangle
of each mesh whose box a ray meets, in float64 (no cluster or BVH walk);
its film adds every sample's filter taps with index_add_.  The semantics
are nart's, as the program states them:

  * streams: Xorshift32 (13/17/5) with the golden-ratio output scramble;
    a pixel's Latin square (sampling.cpp) from the stream seeded with its
    index in the bordered film, y * totalWidth + x; a path's stream seeded
    with the murmur3 finaliser of its (sample, pixel) id;
  * a bounce: the environment seen by a camera ray that misses; on a hit
    the direct light by both strategies with the power heuristic (a light
    picked, the BSDF sampled with the roughened alpha, the light sampled,
    one shadow ray each), then the BSDF sampled with the material's alpha,
    the roughening chain alpha' = 1 - (1 - alpha) * tweak, and Russian
    roulette past bounce 3; draws in that order, only on the lanes that
    make them;
  * materials lambert, glossy (Torrance-Sparrow, GGX, visible normals)
    and plastic (lambert + Torrance-Sparrow); textures read at the nearest
    texel; the environment light importance-sampled by its piecewise
    constant 2D distribution;
  * gradients (train): autograd with every sampling decision held fixed
    (directions, pdfs and the roulette's probability detached), mesh
    textures read in float32; an image (render) reads them as half floats,
    as nart keeps them.

What a configuration uses beyond this (area lights, dielectrics, normal
maps, media) is refused, not approximated.
``carry_dtype`` stores each path's carry (throughput, radiance, roughening
factor, ray) in that dtype after every bounce: the lower-precision
control (control.py).
"""

import json
import math
import os

import numpy as np
import torch

from .. import exrfile

MASK = 0xFFFFFFFF
ENV_TMAX = 2139095039.0  # nart's tMax for the environment (0x7f7fffff)
BIAS = float(np.float32(0.001))
BEFORE_ONE = float(np.float32(1.0) - np.float32(2.0 ** -23))
RR_SCALE = float(np.float32(0.33333))
PI = math.pi
LAMBERT, TS = 0, 1  # lobe codes
F_SPECULAR, F_GLOSSY, F_DIFFUSE = 1, 2, 4  # sampled-lobe flags
GLOSSY_MAT, PLASTIC_MAT, LAMBERT_MAT = "glossy", "plastic", "lambert"


# ---------------------------------------------------------------------------
# random numbers


def _mul(a, b):
    """(a * b) mod 2^32 for a uint32 held in int64 and a constant b: b
    split in 16-bit halves, so no product leaves 2^49."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK


class Streams:
    """One Xorshift32 stream a lane (int64 holding uint32 states)."""

    def __init__(self, states):
        self.s = states

    def _step(self, keep=None):
        y = self.s
        y = y ^ ((y << 13) & MASK)
        y = y ^ (y >> 17)
        y = y ^ ((y << 5) & MASK)
        self.s = y if keep is None else torch.where(keep, y, self.s)
        return y

    def uniform(self, keep=None):
        """A float in [0, 1) a lane; lanes outside `keep` keep their
        state (their value is not used)."""
        y = self._step(keep)
        f = _mul(y, 0x9E3779BB).to(torch.float32) * (2.0 ** -32)
        return torch.clamp(f, max=BEFORE_ONE)

    def integer(self, upto):
        """An integer in [0, upto] a lane."""
        y = self._step()
        return (_mul(y, 0x9E3779B9) * (upto + 1)) >> 32

    def subset(self, idx):
        return Streams(self.s[idx])


def pixel_seed(index):
    return (index + 2463534242) & MASK


def path_seed(item):
    """The stream of a (sample, pixel) item: murmur3's finaliser of its id,
    then the pixel seeding's offset."""
    h = item & MASK
    h = h ^ (h >> 16)
    h = _mul(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return pixel_seed(h)


def latin_square(width, height, total_w, spp, device):
    """Each pixel's spp image samples, (spp, width * height, 2): strata
    along the diagonal, then each dimension shuffled by swaps (sampling.cpp
    72-86), from the pixel's stream."""
    pix = torch.arange(width * height, dtype=torch.int64, device=device)
    st = Streams(pixel_seed((pix // width) * total_w + pix % width))
    sq = torch.empty((width * height, spp, 2), device=device)
    for i in range(spp):
        sq[:, i, 0] = (i + st.uniform()) * (1.0 / spp)
        sq[:, i, 1] = (i + st.uniform()) * (1.0 / spp)
    for i in range(spp):
        for k in (0, 1):
            j = st.integer(spp - 1 - i)
            col = sq[:, :, k]
            a = col[:, i].clone()
            b = col.gather(1, j[:, None])[:, 0]
            col.scatter_(1, j[:, None], a[:, None])
            col[:, i] = b
    return sq.transpose(0, 1).contiguous()


# ---------------------------------------------------------------------------
# the scene, read from its file


def _mat4(v):
    return np.asarray(v if v is not None else np.eye(4).ravel(),
                      np.float32).reshape(4, 4)


def read_geo(path, xf):
    """A .geo mesh as world-space triangles: (v, n, uv), each (T, 3, k),
    float32.  The file: face count, corner counts, vertex indices, vertex
    coordinates, normal indices, normals, then optionally uv indices and
    uvs; faces are fans; points move by xf, normals by its inverse
    transpose."""
    with open(path) as f:
        nums = np.array(f.read().split(), np.float64)
    at = 0

    def take(n):
        nonlocal at
        at += n
        return nums[at - n:at]

    nf = int(take(1)[0])
    counts = take(nf).astype(np.int64)
    nc = int(counts.sum())
    vi = take(nc).astype(np.int64)
    vs = take((vi.max() + 1) * 3).reshape(-1, 3)
    ni = take(nc).astype(np.int64)
    ns = take((ni.max() + 1) * 3).reshape(-1, 3)
    if at < len(nums):
        ui = take(nc).astype(np.int64)
        us = take((ui.max() + 1) * 2).reshape(-1, 2)
    else:
        ui = None
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    tris = [(f, f + j, f + j + 1) for f, c in zip(first, counts)
            for j in range(1, c - 1)]
    tris = np.array(tris, np.int64)
    a = xf.astype(np.float64)
    v = vs.astype(np.float32).astype(np.float64) @ a[:3, :3].T + a[:3, 3]
    nm = ns.astype(np.float32).astype(np.float64) @ np.linalg.inv(a)[:3, :3]
    nm = nm / np.maximum(np.linalg.norm(nm, axis=1, keepdims=True), 1e-20)
    uv = (us[ui[tris]] if ui is not None else
          np.broadcast_to(np.array([[0, 0], [0, 1], [1, 0]], np.float64),
                          (len(tris), 3, 2)))
    return (v[vi[tris]].astype(np.float32), nm[ni[tris]].astype(np.float32),
            np.asarray(uv, np.float32))


class Scene:
    """A path-integrator scene: triangles with their mesh ids, per-mesh
    materials, textures, the environment light and the camera, on
    `device`; ``theta()`` gives its trainable values with the program's
    keys (so gradients compare leaf by leaf)."""

    def __init__(self, scene_path, device):
        root = os.path.dirname(scene_path)
        with open(scene_path) as f:
            doc = json.load(f)

        def asset(p):
            return os.path.join(root, p.replace("//", "/"))

        self.device = device
        cam = doc["camera"]
        self.cam = torch.tensor(_mat4(cam.get("transform")), device=device)
        self.fov = float(cam.get("fov", 11.0))
        vs, ns, uvs, mids = [], [], [], []
        mats, rho_d, rho_s, eta, alpha, tex_paths = [], [], [], [], [], []
        before_one = np.float32(1.0) - np.float32(2.0 ** -23)
        for i, m in enumerate(doc["meshes"]):
            mat = m["material"]
            kind = mat["type"]
            if kind not in (GLOSSY_MAT, PLASTIC_MAT, LAMBERT_MAT):
                raise NotImplementedError(f"material {kind!r}")
            if "normal" in mat or m.get("priority", 0):
                raise NotImplementedError("normal maps or priorities")
            v, n, uv = read_geo(asset(m["filePath"]),
                                _mat4(m.get("transform")))
            vs.append(v), ns.append(n), uvs.append(uv)
            mids.append(np.full(len(v), i, np.int64))
            mats.append(kind)
            zero = np.zeros(3, np.float32)
            # rho_d: a bare array unclamped, a texture by index (-1: none)
            d = mat.get("rho_d", [0, 0, 0]) if kind != GLOSSY_MAT else zero
            if isinstance(d, dict):
                if d.get("type") != "texture":
                    raise NotImplementedError("pattern " + str(d.get("type")))
                if asset(d["filePath"]) not in tex_paths:
                    tex_paths.append(asset(d["filePath"]))
                rho_d.append((zero, tex_paths.index(asset(d["filePath"]))))
            else:
                rho_d.append((np.asarray(d, np.float32), -1))
            s = mat.get("rho_s", zero) if kind != LAMBERT_MAT else zero
            rho_s.append(np.minimum(np.asarray(s, np.float32), before_one)
                         if kind != LAMBERT_MAT else zero)
            e = np.float32(mat.get("eta", 0.0)) if kind != LAMBERT_MAT else 0
            r = np.float32(mat.get("roughness", 0.0))
            eta.append(np.float32(e))
            alpha.append(r * r if kind != LAMBERT_MAT else np.float32(0))
        self.tri_v = torch.tensor(np.concatenate(vs), device=device)
        self.tri_n = torch.tensor(np.concatenate(ns), device=device)
        self.tri_uv = torch.tensor(np.concatenate(uvs), device=device)
        self.tri_mesh = torch.tensor(np.concatenate(mids), device=device)
        self.is_plastic = torch.tensor([k == PLASTIC_MAT for k in mats],
                                       device=device)
        self.is_lambert = torch.tensor([k == LAMBERT_MAT for k in mats],
                                       device=device)
        self.rho_d_tex = torch.tensor([t for _, t in rho_d], device=device)
        texels = [exrfile.read(p) for p in tex_paths] or \
            [np.zeros((1, 1, 3), np.float32)]
        self.tex_w = torch.tensor([t.shape[1] for t in texels], device=device)
        self.tex_h = torch.tensor([t.shape[0] for t in texels], device=device)
        self.tex_off = torch.tensor(
            np.concatenate([[0], np.cumsum([t.shape[0] * t.shape[1]
                                            for t in texels])[:-1]]),
            dtype=torch.int64, device=device)
        self._theta = {
            "rho_d_const": torch.tensor(np.stack([c for c, _ in rho_d])),
            "rho_s_const": torch.tensor(np.stack(rho_s)),
            "tau_const": torch.zeros((len(mats), 3)),
            "alpha_const": torch.tensor(np.array(alpha, np.float32)),
            "eta_const": torch.tensor(np.array(eta, np.float32)),
            "tex_data": torch.tensor(np.concatenate(
                [t.reshape(-1, 3) for t in texels])),
        }
        lights = doc.get("lights", [])
        if len(lights) != 1 or lights[0].get("type") != "environment" or \
                not isinstance(lights[0].get("Le"), dict):
            raise NotImplementedError("one textured environment light only")
        env = exrfile.read(asset(lights[0]["Le"]["filePath"]))
        self._theta["light_le"] = [torch.zeros(3)]
        self._theta["light_le_tex"] = [torch.tensor(env)]
        self._theta["light_intensity"] = [
            torch.tensor(np.float32(lights[0].get("intensity", 1.0)))]
        self.n_lights = 1
        self._env_distribution(env)
        lo = self.tri_v.double().amin(1)
        hi = self.tri_v.double().amax(1)
        self.meshes = []
        for i in range(len(mats)):
            sel = torch.nonzero(self.tri_mesh == i)[:, 0]
            self.meshes.append((sel, lo[sel].amin(0), hi[sel].amax(0)))
        self.tri_v64 = self.tri_v.double()

    def theta(self, factors=None):
        """The trainable values on the device, each times its factor
        (factors: {leaf path: float}, the seed's draws)."""
        out = {}
        for k, v in self._theta.items():
            if isinstance(v, list):
                out[k] = [self._scaled(x, (k, i), factors)
                          for i, x in enumerate(v)]
            else:
                out[k] = self._scaled(v, (k,), factors)
        return out

    def _scaled(self, x, path, factors):
        x = x.to(self.device)
        return x * factors[path] if factors is not None else x.clone()

    def _env_distribution(self, img):
        """Piecewise-constant 2D distribution of the map's luminance
        (texturepattern.cpp 3-70), rows flipped so that row j is image row
        h - 1 - j, in float64, kept in float32."""
        h, w, _ = img.shape
        dev = self.device
        lum = torch.tensor(np.abs(img[::-1]).sum(axis=2, dtype=np.float64),
                           device=dev)
        marg = lum.mean(1)
        cond = torch.where(marg[:, None] != 0,
                           lum / torch.where(marg == 0, 1.0, marg)[:, None],
                           torch.ones_like(lum))
        marg = marg / marg.mean()
        mcdf = torch.zeros(h + 1, dtype=torch.float64, device=dev)
        mcdf[1:] = torch.cumsum(marg, 0) / h
        mcdf[h] = 1.0
        ccdf = torch.zeros((h, w + 1), dtype=torch.float64, device=dev)
        ccdf[:, 1:] = torch.cumsum(cond, 1) / w
        ccdf[:, w] = 1.0
        self.env_h, self.env_w = h, w
        self.marg_pdf = marg.float()
        self.marg_cdf = mcdf.float()
        self.cond_pdf = cond.float().reshape(-1)
        self.cond_cdf = ccdf.float()
        # every row's cdf lifted by twice its row index, in float64 (exact
        # for float32 entries): one sorted sequence a search can take
        rows = torch.arange(h, dtype=torch.float64, device=dev)[:, None]
        self.cond_cdf_lifted = (self.cond_cdf.double()
                                + 2.0 * rows).reshape(-1)


# ---------------------------------------------------------------------------
# vector helpers (safe where a denominator or a root's argument is 0)


def dot(a, b):
    return (a * b).sum(-1)


def sdiv(a, b):
    ok = b != 0
    return torch.where(ok, a / torch.where(ok, b, torch.ones_like(b)),
                       torch.zeros_like(a))


def ssqrt(x):
    pos = x > 0
    root = torch.sqrt(torch.where(pos, x, torch.ones_like(x)))
    return torch.where(pos, root, torch.zeros_like(x))


def normalize(v):
    n2 = (v * v).sum(-1, keepdim=True)
    z = n2 == 0
    return v / torch.where(z, 1.0, torch.sqrt(torch.where(z, 1.0, n2)))


def on(mask, fn, *args):
    """fn on the lanes of mask only (the others never compute, so no
    gradient of theirs can be NaN): each output (n, ...) with zeros
    elsewhere."""
    idx = torch.nonzero(mask)[:, 0]
    outs = fn(*[a[idx] for a in args])
    single = not isinstance(outs, tuple)
    outs = (outs,) if single else outs
    full = []
    for o in outs:
        base = torch.zeros((mask.shape[0],) + o.shape[1:], dtype=o.dtype,
                           device=o.device)
        full.append(base.index_put((idx,), o))
    return full[0] if single else tuple(full)


# ---------------------------------------------------------------------------
# ray queries (float64, every triangle of each mesh whose box a ray meets)

_PAIRS = 1 << 24  # ray-triangle pairs a block


def _box(o, d, lo, hi, tmax):
    pad = 1e-6 * (hi - lo).abs().max() + 1e-9
    lo, hi = lo - pad, hi + pad
    inv = 1.0 / torch.where(d == 0, 1e-300, d)
    a, b = (lo - o) * inv, (hi - o) * inv
    t0 = torch.minimum(a, b).amax(-1).clamp(min=0.0)
    t1 = torch.maximum(a, b).amin(-1)
    return (t0 <= t1) & (t0 < tmax)


def _tests(o, d, v):
    """Möller-Trumbore of rays (r, 3) against triangles (c, 3, 3):
    (t, b1, b2, hit), each (r, c)."""
    v0, e1, e2 = v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    p = torch.linalg.cross(d[:, None, :], e2[None], dim=-1)
    det = dot(e1[None], p)
    inv = 1.0 / torch.where(det == 0, 1.0, det)
    s = o[:, None, :] - v0[None]
    b1 = dot(s, p) * inv
    q = torch.linalg.cross(s, e1[None].expand_as(s), dim=-1)
    b2 = dot(d[:, None, :], q) * inv
    t = dot(e2[None], q) * inv
    hit = (det != 0) & (b1 >= 0) & (b2 >= 0) & (b1 + b2 <= 1) & (t > 0)
    return t, b1, b2, hit


def closest(scene, o, d, tmax):
    """The nearest hit closer than tmax of each ray: (tri (-1 where none),
    b1, b2), barycentric weights of a triangle's second and third corner."""
    o, d = o.double(), d.double()
    n = o.shape[0]
    best = torch.full((n,), tmax, dtype=torch.float64, device=o.device)
    tri = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    b1s = torch.zeros(n, dtype=torch.float64, device=o.device)
    b2s = torch.zeros_like(b1s)
    for sel, lo, hi in scene.meshes:
        rays = torch.nonzero(_box(o, d, lo, hi, best))[:, 0]
        step = max(1, _PAIRS // max(1, len(sel)))
        for r0 in range(0, len(rays), step):
            r = rays[r0:r0 + step]
            t, b1, b2, hit = _tests(o[r], d[r], scene.tri_v64[sel])
            t = torch.where(hit & (t < best[r][:, None]), t, math.inf)
            tmin, j = t.min(1)
            got = torch.isfinite(tmin)
            rr = r[got]
            jj = j[got]
            best[rr] = tmin[got]
            tri[rr] = sel[jj]
            b1s[rr] = b1[got, jj]
            b2s[rr] = b2[got, jj]
    return tri, b1s.float(), b2s.float()


def occluded(scene, o, d, tmax):
    """Whether anything lies between o and o + tmax d (t > 0)."""
    o, d = o.double(), d.double()
    n = o.shape[0]
    blocked = torch.zeros(n, dtype=torch.bool, device=o.device)
    for sel, lo, hi in scene.meshes:
        rays = torch.nonzero(_box(o, d, lo, hi, tmax) & ~blocked)[:, 0]
        step = max(1, _PAIRS // max(1, len(sel)))
        for r0 in range(0, len(rays), step):
            r = rays[r0:r0 + step]
            t, _, _, hit = _tests(o[r], d[r], scene.tri_v64[sel])
            blocked[r] |= (hit & (t < tmax)).any(1)
    return blocked


def surface(scene, tri, b1, b2):
    """Point, geometric normal, interpolated (unnormalised) shading
    normal, texture coordinates, dp/ds and mesh id at the hits."""
    v, n, uv = scene.tri_v[tri], scene.tri_n[tri], scene.tri_uv[tri]
    w1, w2 = b1[:, None], b2[:, None]
    w0 = 1.0 - w1 - w2
    p = v[:, 0] * w0 + v[:, 1] * w1 + v[:, 2] * w2
    gn = normalize(torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0],
                                      dim=-1))
    sn = n[:, 0] * w0 + n[:, 1] * w1 + n[:, 2] * w2
    st = uv[:, 0] * w0 + uv[:, 1] * w1 + uv[:, 2] * w2
    du02 = uv[:, 0, 0] - uv[:, 2, 0]
    du12 = uv[:, 1, 0] - uv[:, 2, 0]
    dv02 = uv[:, 0, 1] - uv[:, 2, 1]
    dv12 = uv[:, 1, 1] - uv[:, 2, 1]
    det = du02 * dv12 - dv02 * du12
    dpds = ((v[:, 0] - v[:, 2]) * dv12[:, None]
            - (v[:, 1] - v[:, 2]) * dv02[:, None]) / det[:, None]
    return p, gn, sn, st, dpds, scene.tri_mesh[tri]


# ---------------------------------------------------------------------------
# the environment light


def _texel(img, s, t):
    """Nearest texel of an (h, w, 3) map at (s, t), v flipped, with nart's
    clamps to [1e-4, 0.9999]."""
    h, w, _ = img.shape
    iu = (w * torch.clamp(s, 1e-4, 0.9999)).long()
    iv = (h * torch.clamp(1.0 - t, 1e-4, 0.9999)).long()
    return img.reshape(-1, 3)[iv * w + iu]


def env_eval(scene, th, wi):
    """(radiance, pdf) of the environment seen along world directions wi:
    lat-long (s, t) with nart's pi offset of phi; the pdf is the map's
    times 1 / (4 pi |sin theta|)."""
    theta = torch.arccos(torch.clamp(wi[:, 2], -1.0, 1.0))
    phi = torch.atan2(wi[:, 1], wi[:, 0]) + PI
    phi = torch.where(phi > 2 * PI, phi - 2 * PI, phi)
    phi = torch.where(phi < 0, phi + 2 * PI, phi)
    s, t = 1.0 - phi / (2 * PI), 1.0 - theta / PI
    u = (torch.clamp(s, max=0.9999) * scene.env_w).long()
    v = (torch.clamp(t, max=0.9999) * scene.env_h).long()
    pdf = scene.marg_pdf[v] * scene.cond_pdf[v * scene.env_w + u]
    sin_t = torch.sin(theta).abs()
    pdf = pdf * float(np.float32(0.25 / PI)) * sdiv(torch.ones_like(sin_t),
                                                    sin_t)
    le = _texel(th["light_le_tex"][0], s, t) * th["light_intensity"][0]
    return le, pdf


def env_sample(scene, th, u0, u1):
    """(radiance, world direction, pdf) of the environment sampled by
    (u0, u1): the marginal's row, then the row's column, each inverting
    its cdf linearly inside the bin."""
    h, w = scene.env_h, scene.env_w
    lb = (torch.searchsorted(scene.marg_cdf, u1.contiguous(), right=True)
          - 1).clamp(0, h)
    vc = (sdiv(u1 - scene.marg_cdf[lb], scene.marg_pdf[lb.clamp(max=h - 1)])
          + lb.float() * float(np.float32(1.0 / h)))
    vc = torch.clamp(vc, max=0.9999999)
    v = (vc * h).long()
    mv = scene.marg_pdf[v]
    q = (u0.double() + 2.0 * v.double()).contiguous()
    lb2 = (torch.searchsorted(scene.cond_cdf_lifted, q, right=True) - 1
           - v * (w + 1)).clamp(0, w)
    uc = (sdiv(u0 - scene.cond_cdf[v, lb2],
               scene.cond_pdf[v * w + lb2.clamp(max=w - 1)])
          + lb2.float() * float(np.float32(1.0 / w)))
    uc = torch.clamp(uc, max=0.9999999)
    u = (uc * w).long()
    ok = mv > 0
    pdf = torch.where(ok, mv * scene.cond_pdf[v * w + u], 0.0)
    uc = torch.where(ok, uc, 0.0)
    theta = (1.0 - vc) * PI
    phi = (1.0 - uc) * (2 * PI) + PI
    phi = torch.where(phi > 2 * PI, phi - 2 * PI, phi)
    phi = torch.where(phi < 0, phi + 2 * PI, phi)
    sin_t = torch.sin(theta)
    wi = torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t,
                      torch.cos(theta)], -1)
    le = _texel(th["light_le_tex"][0], uc, vc) * th["light_intensity"][0]
    pdf = pdf * float(np.float32(0.25 / PI)) * sdiv(
        torch.ones_like(sin_t), sin_t.abs())
    return le, wi, pdf


# ---------------------------------------------------------------------------
# BSDF lobes (torrancesparrowbrdf.cpp, lambertbrdf.cpp, bxdf.cpp)


def fresnel(eta_o, eta_i, cos):
    """Unpolarised dielectric Fresnel reflectance, 1 under total internal
    reflection, 0 between equal indices."""
    co = torch.clamp(cos.abs(), max=1.0)
    so = ssqrt(1.0 - co * co)
    si = sdiv(eta_o, eta_i) * so
    ci = ssqrt(1.0 - torch.clamp(si, max=1.0) ** 2)
    para = sdiv(eta_i * co - eta_o * ci, eta_i * co + eta_o * ci)
    perp = sdiv(eta_o * co - eta_i * ci, eta_o * co + eta_i * ci)
    fr = (para * para + perp * perp) * 0.5
    fr = torch.where((co + ci).abs() < 1e-5, 0.0, fr)
    fr = torch.where(si > 1.0, 1.0, fr)
    return torch.where(eta_o == eta_i, 0.0, fr)


def smith_lambda(w, a):
    z = w[:, 2]
    tan = sdiv(ssqrt(1.0 - z * z), z)
    return (-1.0 + torch.sqrt(1.0 + a * a * tan * tan)) * 0.5


def ggx_d(wh, a):
    z = wh[:, 2]
    z2 = z * z
    tan2 = sdiv(torch.clamp(1.0 - z2, min=0.0), z2)
    a2 = a * a
    den = (PI * a2 * (z2 * z2)) * (1.0 + tan2 / a2) ** 2
    return torch.where(z == 0, 0.0, sdiv(torch.ones_like(den), den))


def ts_f(rho_s, eta, a, wo, wi):
    """Torrance-Sparrow (GGX, Smith) reflection; 0 below either side."""
    den = 4.0 * wo[:, 2] * wi[:, 2]
    good = (wo[:, 2] >= 0) & (wi[:, 2] >= 0) & (den != 0)

    def f(rs, e, al, o, i):
        wh = normalize(o + i)
        g = 1.0 / (1.0 + smith_lambda(o, al) + smith_lambda(i, al))
        fr = fresnel(torch.ones_like(e), e, dot(wh, i))
        return rs * sdiv(g * ggx_d(wh, al) * fr,
                         4.0 * o[:, 2] * i[:, 2])[:, None]

    return on(good, f, rho_s, eta, a, wo, wi)


def ts_pdf(a, wo, wi):
    wh = normalize(wo + wi)
    ch = torch.clamp(dot(wo, wh), max=1.0)
    g1 = 1.0 / (1.0 + smith_lambda(wo, a))
    pdf = sdiv(ggx_d(wh, a) * ch * g1, wo[:, 2])
    pdf = torch.clamp(sdiv(pdf, 4.0 * ch), min=0.0)
    return torch.where(wh[:, 2] < 0, 0.0, pdf)


def vndf(wo, a, u0, u1):
    """A visible microfacet normal (Heitz's stretch, vertical-wo guard)."""
    oh = normalize(torch.stack([wo[:, 0] * a, wo[:, 1] * a, wo[:, 2]], -1))
    t1 = torch.stack([oh[:, 1], -oh[:, 0], torch.zeros_like(a)], -1)
    vert = (wo[:, 0] == 0) & (wo[:, 1] == 0)
    x = torch.zeros_like(t1)
    x[:, 0] = 1.0
    t1 = normalize(torch.where(vert[:, None], x, t1))
    t2 = normalize(torch.linalg.cross(t1, oh, dim=-1))
    r, ang = torch.sqrt(u0), u1 * (2 * PI)
    dx, dy = r * torch.cos(ang), r * torch.sin(ang)
    s = (1.0 + oh[:, 2]) * 0.5
    dy = s * dy + (1.0 - s) * torch.sqrt(torch.clamp(1.0 - dx * dx, min=0.0))
    hx = torch.sqrt(torch.clamp(1.0 - dx * dx - dy * dy, min=0.0))
    wh = hx[:, None] * oh + dx[:, None] * t1 + dy[:, None] * t2
    return normalize(torch.stack([wh[:, 0] * a, wh[:, 1] * a, wh[:, 2]], -1))


class Bsdf:
    """The lobes of each hit: lobe 0 (lambert or Torrance-Sparrow) and, on
    plastic, Torrance-Sparrow as lobe 1; alpha0 = max(alpha, 1e-4) and the
    roughened alpha' = 1 - (1 - alpha) tweak."""

    def __init__(self, scene, th, mesh, st, tweak, tex):
        self.plastic = scene.is_plastic[mesh]
        lam = scene.is_lambert[mesh]
        tid = scene.rho_d_tex[mesh]
        rho_d = th["rho_d_const"][mesh]
        if bool((tid >= 0).any()):
            t = tid.clamp(min=0)
            w, h = scene.tex_w[t], scene.tex_h[t]
            iu = (w.float() * torch.clamp(st[:, 0], 1e-4, 0.9999)).long()
            iv = (h.float() * torch.clamp(1.0 - st[:, 1], 1e-4, 0.9999)).long()
            texel = tex[scene.tex_off[t] + iv * w + iu]
            rho_d = torch.where((tid >= 0)[:, None], texel, rho_d)
        self.rho_d = rho_d
        self.rho_s = th["rho_s_const"][mesh]
        self.eta = th["eta_const"][mesh]
        alpha = th["alpha_const"][mesh]
        self.alpha0 = torch.clamp(alpha, min=1e-4)
        self.alpha_p = 1.0 - (1.0 - alpha) * tweak
        # a lobe below these alphas is a mirror: not in these materials
        spec = torch.where(self.plastic, self.alpha_p <= 1e-3,
                           self.alpha_p <= 1e-4) & ~lam
        if bool(spec.any()):
            raise NotImplementedError("a specular lobe")
        self.l0 = torch.where(self.plastic | lam, LAMBERT, TS)
        self.n = torch.where(self.plastic, 2, 1)

    def _alpha(self, prime):
        return self.alpha_p if prime else self.alpha0

    def lobe_f(self, code, wo, wi, prime):
        lam = torch.where((code == LAMBERT)[:, None], self.rho_d / PI, 0.0)
        ts = on(code == TS, ts_f, self.rho_s, self.eta, self._alpha(prime),
                wo, wi)
        return lam + ts

    def lobe_pdf(self, code, wo, wi, prime):
        with torch.no_grad():
            return torch.where(code == LAMBERT, wi[:, 2] / PI,
                               torch.where(code == TS,
                                           ts_pdf(self._alpha(prime).detach(),
                                                  wo, wi), 0.0))

    def eval(self, wo, wi, prime):
        """(f, pdf) summed over the lobes, the pdf their mean."""
        l1 = torch.full_like(self.l0, TS)
        f = self.lobe_f(self.l0, wo, wi, prime) + torch.where(
            self.plastic[:, None], self.lobe_f(l1, wo, wi, prime), 0.0)
        pdf = self.lobe_pdf(self.l0, wo, wi, prime) + torch.where(
            self.plastic, self.lobe_pdf(l1, wo, wi, prime), 0.0)
        return f, pdf / self.n.float()

    def sample(self, wo, u_lobe, u0, u1, prime):
        """(f, wi, pdf, flags, alpha_i): one lobe picked by u_lobe and
        sampled; where its flags are not specular the other lobe's f and
        pdf are added (its pdf > 0) and the pdf divided by the lobes."""
        nf = self.n.float()
        pick = (u_lobe * nf).long().clamp(0, 1)
        code = torch.where(pick == 0, self.l0, TS)
        other = torch.where(pick == 1, self.l0, TS)
        a = self._alpha(prime)
        with torch.no_grad():
            r = torch.sqrt(u0)
            ang = u1 * (2 * PI)
            x, y = r * torch.cos(ang), r * torch.sin(ang)
            cos_wi = torch.stack(
                [x, y, torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))],
                -1)
            wh = vndf(wo, a.detach(), u0, u1)
            ts_wi = normalize(2.0 * dot(wo, wh)[:, None] * wh - wo)
            wi = torch.where((code == LAMBERT)[:, None], cos_wi, ts_wi)
            flags = torch.where(
                code == LAMBERT, F_DIFFUSE,
                torch.where(a >= 1.0, F_DIFFUSE, F_GLOSSY))
            flags = torch.where((code == TS) & (a <= 0.001), F_SPECULAR,
                                flags)
        f = self.lobe_f(code, wo, wi, prime)
        pdf = self.lobe_pdf(code, wo, wi, prime)
        alpha_i = torch.where(code == LAMBERT, torch.ones_like(a), a)
        non_spec = (flags & F_SPECULAR) == 0
        mix = non_spec & (self.n >= 2)
        p_o = self.lobe_pdf(other, wo, wi, prime)
        add = mix & (p_o > 0)
        f = f + torch.where(add[:, None], self.lobe_f(other, wo, wi, prime),
                            0.0)
        pdf = pdf + torch.where(add, p_o, 0.0)
        pdf = torch.where(non_spec, pdf / nf, pdf)
        return f, wi, pdf, flags, alpha_i


def frame_of(sn, dpds):
    t = normalize(dpds - dot(dpds, sn)[:, None] * sn)
    b = normalize(torch.linalg.cross(sn, t, dim=-1))
    return t, b, sn


def to_local(fr, v):
    return normalize(torch.stack([dot(v, fr[0]), dot(v, fr[1]),
                                  dot(v, fr[2])], -1))


def to_world(fr, v):
    return normalize(v[:, 0:1] * fr[0] + v[:, 1:2] * fr[1] + v[:, 2:3] * fr[2])


# ---------------------------------------------------------------------------
# paths


def camera_rays(scene, px, py, jit, width, height):
    tan = float(np.float32(np.tan(np.radians(np.float32(scene.fov)))))
    aspect = float(np.float32(width / height))
    x = (((px.float() + jit[:, 0]) / float(width)) * 2.0 - 1.0) * tan * aspect
    y = (((py.float() + jit[:, 1]) / float(height)) * -2.0 + 1.0) * tan
    d = normalize(torch.stack([x, y, -torch.ones_like(x)], -1))
    a = scene.cam
    return a[:3, 3].expand(d.shape).contiguous(), d @ a[:3, :3].T


def trace(scene, th, o, d, streams, bounces, roughening, tex,
          carry_dtype=None):
    """Every path's radiance (n, 3), its bounces in one loop."""
    n = o.shape[0]
    dev = o.device
    gamma = float(np.float32(roughening ** 2))
    L = torch.zeros((n, 3), device=dev)
    ids = torch.arange(n, device=dev)
    beta = torch.ones((n, 3), device=dev)
    tweak = torch.ones(n, device=dev)
    flags = torch.zeros(n, dtype=torch.int64, device=dev)
    st = streams

    def store(x):
        return x if carry_dtype is None else x.to(carry_dtype).float()

    for bounce in range(bounces):
        if ids.numel() == 0:
            break
        tri, b1, b2 = closest(scene, o, d, ENV_TMAX)
        hit = tri >= 0
        if bounce == 0:  # a camera ray that misses sees the environment
            miss = torch.nonzero(~hit)[:, 0]
            le, _ = env_eval(scene, th, d[miss])
            L = store(L.index_add(0, ids[miss], le))
        keep = torch.nonzero(hit)[:, 0]
        ids, o, d, beta, tweak, flags = (x[keep] for x in
                                         (ids, o, d, beta, tweak, flags))
        st = st.subset(keep)
        tri, b1, b2 = tri[keep], b1[keep], b2[keep]
        p, gn, sn, uvs, dpds, mesh = surface(scene, tri, b1, b2)
        bs = Bsdf(scene, th, mesh, uvs, tweak, tex)
        fr = frame_of(sn, dpds)
        wo = to_local(fr, -d)

        # direct light: a light picked, both strategies
        u_pick = st.uniform()
        del u_pick  # one light: the pick is always light 0
        ua = (st.uniform(), st.uniform(), st.uniform())
        ub = (st.uniform(), st.uniform())
        liB, wiBw, lpB = env_sample(scene, th, ub[0], ub[1])
        wiBw, lpB = wiBw.detach(), lpB.detach()
        wiB = to_local(fr, wiBw).detach()
        fA, wiA, pdfA, flA, _ = bs.sample(wo, ua[2], ua[0], ua[1], True)
        fB, pdfB = bs.eval(wo, wiB, True)
        wiAw = to_world(fr, wiA).detach()
        liA, lpA = env_eval(scene, th, wiAw)
        lpA = lpA.detach()
        specA = (flA & F_SPECULAR) != 0
        needA = (pdfA > 0) & (specA | (lpA > 0))
        needB = (lpB > 0) & (pdfB > 0)
        sign = lambda z: torch.where(z > 0, 1.0, -1.0)  # noqa: E731
        oA = p + gn * (BIAS * sign(wiA[:, 2]))[:, None]
        oB = p + gn * (BIAS * sign(wiB[:, 2]))[:, None]
        occA = on(needA, lambda a, b: occluded(scene, a, b, ENV_TMAX), oA,
                  wiAw)
        occB = on(needB, lambda a, b: occluded(scene, a, b, ENV_TMAX), oB,
                  wiBw)
        misA = (pdfA * pdfA) / torch.clamp(pdfA * pdfA + lpA * lpA, min=1e-30)
        wA = torch.where(specA, 1.0, misA)
        cA = fA * liA * (wiA[:, 2].abs() * wA
                         / torch.where(pdfA > 0, pdfA, 1.0))[:, None]
        misB = (lpB * lpB) / torch.clamp(pdfB * pdfB + lpB * lpB, min=1e-30)
        cB = fB * liB * (wiB[:, 2].abs() * misB
                         / torch.where(lpB > 0, lpB, 1.0))[:, None]
        direct = (torch.where((needA & ~occA)[:, None], cA, 0.0)
                  + torch.where((needB & ~occB)[:, None], cB, 0.0))
        L = store(L.index_add(0, ids, direct * float(scene.n_lights) * beta))

        # the scattered ray
        us = (st.uniform(), st.uniform(), st.uniform())
        fS, wiS, pdfS, flS, alpha_i = bs.sample(wo, us[2], us[0], us[1],
                                                False)
        go = pdfS > 0
        tweak = torch.where(go, (1.0 - gamma * alpha_i) * tweak, tweak)
        beta = torch.where(go[:, None], beta * fS * (
            wiS[:, 2].abs() / torch.where(go, pdfS, 1.0))[:, None], beta)
        o = p + gn * (BIAS * sign(wiS[:, 2]))[:, None]
        d = to_world(fr, wiS).detach()
        flags = flS
        live = go
        if bounce > 3:  # Russian roulette
            u_rr = st.uniform(go)
            q = torch.clamp(beta.sum(-1) * RR_SCALE, min=0.0).detach()
            survive = q >= u_rr
            beta = torch.where((go & survive)[:, None],
                               beta / torch.where(q > 0, q, 1.0)[:, None],
                               beta)
            live = go & survive
        keep = torch.nonzero(live)[:, 0]
        ids, o, d, beta, tweak, flags = (x[keep] for x in
                                         (ids, o, d, beta, tweak, flags))
        beta, tweak, o, d = (store(x) for x in (beta, tweak, o, d))
        st = st.subset(keep)
    return L


def item_paths(scene, th, samples, base, grid, image, bounces, roughening,
               tex, lo=0, hi=None, carry_dtype=None):
    """The radiance (m, 3) of the items lo..hi of a chunk of samples
    (spp_chunk, P, 2) of the pixel grid (gw, gh), P = gw * gh, whose first
    sample is `base`: item i is sample i // P of pixel i % P, its stream
    seeded by (base + sample) * P + pixel; the camera maps the image
    (width, height) onto its view."""
    (gw, gh), (width, height) = grid, image
    npix = gw * gh
    hi = samples.shape[0] * npix if hi is None else hi
    item = torch.arange(lo, hi, device=samples.device)
    s, pix = item // npix, item % npix
    jit = samples.reshape(-1, 2)[item]
    o, d = camera_rays(scene, pix % gw, pix // gw, jit, width, height)
    st = Streams(path_seed((base + s) * npix + pix))
    return trace(scene, th, o, d, st, bounces, roughening, tex, carry_dtype)


# ---------------------------------------------------------------------------
# the film (render.cpp 23-70, 208-228)


def filter_table(device):
    """64 entries of a Gaussian of width 63 (sigma 21), 0 from 63 on."""
    x = np.arange(64, dtype=np.float64)
    s = 63.0 / 3.0
    g = np.exp(-(x * x) / (2 * s * s)) / np.sqrt(2 * np.pi * s * s)
    g[x >= 63] = 0.0
    return torch.tensor(g.astype(np.float32), device=device)


def splat(film, jit, la, width, height, filter_width, table):
    """Add one sample a pixel of the grid (width, height) (jit (P, 2), la
    (P, 4) RGBA) to the film (image + 2b on each axis, 5): each filter tap
    within the filter's reach gets its weight times the sample, and the
    weight; taps off the film are dropped."""
    b = int(math.ceil(filter_width))
    fw = float(np.float32(filter_width))
    th_, tw_ = film.shape[:2]
    pix = torch.arange(width * height, device=jit.device)
    px, py = pix % width, pix // width
    sx, sy = b + jit[:, 0], b + jit[:, 1]
    x0, x1 = torch.floor(sx - fw), torch.ceil(sx + fw)
    y0, y1 = torch.floor(sy - fw), torch.ceil(sy + fw)
    flat = film.view(-1, 5)
    for dy in range(2 * b + 1):
        for dx in range(2 * b + 1):
            inside = (dx >= x0) & (dx < x1) & (dy >= y0) & (dy < y1)
            dist = torch.sqrt((dx + 0.5 - sx) ** 2 + (dy + 0.5 - sy) ** 2)
            k = ((dist / fw) * 64).long() & 0xFF
            w = table[k.clamp(max=63)] * inside.float()
            fy, fx = py + dy, px + dx
            on_film = (fy < th_) & (fx < tw_)
            rows = torch.cat([la * w[:, None], w[:, None]], -1)[on_film]
            flat.index_add_(0, (fy * tw_ + fx)[on_film], rows)
    return film


def finalize(film, width, height, filter_width):
    b = int(math.ceil(filter_width))
    crop = film[b:b + height, b:b + width]
    return crop[..., :4] / crop[..., 4:5]
