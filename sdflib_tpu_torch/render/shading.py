"""Shading for sphere-traced renders: normal shading, Blinn-Phong/PBR-lite,
ambient occlusion, soft shadows, iteration heatmaps.

Port of the JAX package's ``render/shading.py`` (reference:
shaders/sdfOctreeRender.comp: getAO :258-271, softshadow :273-309,
Cook-Torrance mapColor :329-389, palette :410-427), as batched torch
ops. AO and soft shadows re-march the SDF through a distance callable,
as the reference does.

Every function runs on the device of its first tensor argument (the
normals, positions, hits, iteration counts or shading terms); non-tensor
arguments join it there. A call with no tensor argument runs on its
``device``: the card unless the caller passes the CPU (through
``resolve_device``, so without a card it raises).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..sdf.sdf_function import resolve_device

__all__ = ["normal_color", "shade_lambert", "shade_pbr", "ambient_occlusion",
           "soft_shadow", "iteration_heatmap"]

# 5-color heatmap palette of the reference compute shader for
# iteration/step visualization (sdfOctreeRender.comp:410-427); moved to
# the counts' device on use.
ITER_PALETTE = torch.tensor(
    [
        [1.0, 0.0, 1.0],
        [0.0, 0.0, 1.0],
        [0.0, 1.0, 0.0],
        [1.0, 1.0, 0.0],
        [1.0, 0.0, 0.0],
    ],
    dtype=torch.float32,
)


def _t(x, device, dtype=torch.float32):
    """``x`` (tensor, array or sequence) as a ``dtype`` tensor on
    ``device``; arrays are copied."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def _device(*args, device) -> torch.device:
    """The device of the first tensor among ``args``, else ``device``."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return resolve_device(device)


def _unit(v):
    """A light direction normalized (one vector)."""
    return v / (v * v).sum().sqrt()


def _normalize(v):
    return v / (v * v).sum(-1, keepdim=True).sqrt().clamp_min(1e-9)


def normal_color(normal, hit, background=(0.9, 0.9, 0.9), *, device="cuda"):
    """Classic 0.5*(n+1) normal visualization for hit pixels."""
    normal = _t(normal, _device(normal, hit, device=device))
    hit = _t(hit, normal.device, torch.bool)
    col = 0.5 * (normal + 1.0)
    return torch.where(hit[..., None], col, _t(background, normal.device))


def shade_lambert(
    position,
    normal,
    hit,
    light_dir=(0.577, 0.577, 0.577),
    base_color=(0.8, 0.75, 0.7),
    ambient=0.25,
    specular=0.3,
    shininess=32.0,
    view_dir=None,
    ao=None,
    shadow=None,
    background=(0.9, 0.9, 0.9),
    *,
    device="cuda",
):
    """Lambert + Blinn specular with optional AO/shadow modulation: the
    role of mapColor (comp shader :329-389) without the Cook-Torrance
    microfacet terms. Without ``view_dir`` there is no specular term."""
    dev = _device(position, normal, hit, view_dir, ao, shadow, device=device)
    normal = _t(normal, dev)
    hit = _t(hit, dev, torch.bool)
    l = _unit(_t(light_dir, dev))
    diffuse = (normal * l).sum(-1).clamp_min(0.0)
    if shadow is not None:
        shadow = _t(shadow, dev)
        diffuse = diffuse * shadow
    amb = ambient if ao is None else ambient * _t(ao, dev)
    intensity = amb + (1.0 - ambient) * diffuse
    col = _t(base_color, dev) * intensity[..., None]
    if view_dir is not None:
        h = _normalize(l - _t(view_dir, dev))
        spec = specular * (normal * h).sum(-1).clamp_min(0.0).pow(shininess)
        if shadow is not None:
            spec = spec * shadow
        col = col + spec[..., None]
    return torch.where(hit[..., None], col, _t(background, dev)).clamp(0.0, 1.0)


def shade_pbr(
    position,
    normal,
    hit,
    view_dir,
    light_dir=(0.577, 0.577, 0.577),
    light_color=(1.0, 1.0, 1.0),
    base_color=(0.8, 0.75, 0.7),
    metallic=0.0,
    roughness=0.45,
    ambient=0.22,
    ao=None,
    shadow=None,
    background=(0.9, 0.9, 0.9),
    *,
    device="cuda",
):
    """Cook-Torrance microfacet shading (GGX distribution, Smith geometry,
    Fresnel-Schlick): the reference compute shader's mapColor pipeline
    (sdfOctreeRender.comp:82-121 BRDF terms, :329-389 composition)."""
    dev = _device(position, normal, hit, view_dir, ao, shadow, device=device)
    n = _t(normal, dev)
    hit = _t(hit, dev, torch.bool)
    v = _normalize(-_t(view_dir, dev))
    l = _unit(_t(light_dir, dev))
    h = _normalize(l + v)

    albedo = _t(base_color, dev)
    lc = _t(light_color, dev)
    ndotl = (n * l).sum(-1).clamp_min(0.0)
    ndotv = (n * v).sum(-1).clamp_min(1e-4)
    ndoth = (n * h).sum(-1).clamp_min(0.0)
    hdotv = (h * v).sum(-1).clamp_min(0.0)

    # GGX normal distribution (comp shader DistributionGGX)
    a = roughness * roughness
    a2 = a * a
    denom = ndoth * ndoth * (a2 - 1.0) + 1.0
    D = a2 / (math.pi * denom * denom).clamp_min(1e-9)

    # Smith geometry with Schlick-GGX (comp shader GeometrySmith)
    k = (roughness + 1.0) ** 2 / 8.0
    g1 = ndotv / (ndotv * (1.0 - k) + k)
    g2 = ndotl / (ndotl * (1.0 - k) + k).clamp_min(1e-9)
    G = g1 * g2

    # Fresnel-Schlick (comp shader fresnelSchlick)
    f0 = 0.04 * (1.0 - metallic) + metallic  # scalar workflow
    F = f0 + (1.0 - f0) * (1.0 - hdotv).clamp(0.0, 1.0).pow(5.0)

    spec = (D * G * F) / (4.0 * ndotv * ndotl).clamp_min(1e-4)
    kd = (1.0 - F) * (1.0 - metallic)

    radiance = ndotl
    if shadow is not None:
        radiance = radiance * _t(shadow, dev)
    direct = (kd[..., None] * albedo / math.pi + spec[..., None]) * lc * radiance[..., None]

    amb = ambient if ao is None else ambient * _t(ao, dev)[..., None]
    col = amb * albedo + direct
    # simple tonemap + gamma (comp shader :443-445)
    col = col / (col + 1.0)
    col = col.clamp(0.0, 1.0).pow(1.0 / 2.2)
    return torch.where(hit[..., None], col, _t(background, dev))


def ambient_occlusion(distance_fn, position, normal, *, taps: int = 8, device="cuda"):
    """8-tap AO along the normal (comp shader getAO :258-271):
    occ += max(h - d(p + n*h), 0) for h = 0.002 + 0.1*i/8; 1 - 1.9*occ."""
    position = _t(position, _device(position, normal, device=device))
    normal = _t(normal, position.device)
    occ = torch.zeros(position.shape[:-1], dtype=torch.float32, device=position.device)
    for i in range(taps):
        h = 0.002 + 0.1 * i / taps
        d = distance_fn(position + normal * h)
        occ = occ + (h - d).clamp_min(0.0)
    return (1.0 - 1.9 * occ).clamp(0.0, 1.0)


def soft_shadow(distance_fn, position, light_dir, *, k: float = 8.0,
                t_min: float = 0.005, t_max: float = 5.0, steps: int = 64,
                device="cuda"):
    """Improved soft shadow march toward the light
    (comp shader softshadow :273-309 semantics, fixed step count)."""
    position = _t(position, _device(position, light_dir, device=device))
    dev = position.device
    l = _unit(_t(light_dir, dev))
    shape = position.shape[:-1]
    res = torch.ones(shape, dtype=torch.float32, device=dev)
    t = torch.full(shape, t_min, dtype=torch.float32, device=dev)
    ph = torch.full(shape, 1e20, dtype=torch.float32, device=dev)
    for _ in range(steps):
        h = distance_fn(position + l * t[..., None])
        y = h * h / (2.0 * ph.clamp_min(1e-9))
        d = (h * h - y * y).clamp_min(0.0).sqrt()
        res = torch.minimum(res, k * d / (t - y).clamp_min(1e-6))
        ph = h
        t = (t + h.clamp(0.001, 0.2)).clamp_max(t_max)
    return res.clamp(0.0, 1.0)


def iteration_heatmap(iterations, max_iters: int, *, device="cuda"):
    """Map march-iteration counts through the 5-color palette."""
    iterations = _t(iterations, _device(iterations, device=device))
    t = (iterations / max_iters).clamp(0.0, 1.0)
    idx = (t * 4.0).clamp(0.0, 3.999)
    i0 = idx.to(torch.int64)
    frac = (idx - i0)[..., None]
    pal = ITER_PALETTE.to(iterations.device)
    return pal[i0] * (1.0 - frac) + pal[(i0 + 1).clamp_max(4)] * frac
