"""Procedural raw-omni-image renderer: the POV-Ray replacement.

JAX replacement for the reference's POV-Ray synthetic render pipeline
(SURVEY.md C17 [P1/K]): instead of an external ray tracer, the scene is an
analytically-intersectable textured room (cylinder wall + floor + ceiling
with hash-based value-noise texture) ray-cast IN JAX through the exact same
sensor model the pipeline uses. Every rendered image therefore comes with
exact ground truth by construction, and rendering itself jits/vmaps (a whole
sequence renders as one device program).

The raw image contains both annular views, like the physical sensor: each
pixel inside a view's annulus is lifted through that view to a rig-frame ray
from that view's viewpoint, transformed by the ground-truth pose, and
intersected with the room.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from sosvo.geom.lie import rotate_dirs
from sosvo.sensor.model import annulus_mask, lift, viewpoint
from sosvo.sensor.rig import OmnistereoRig


class RoomScene(NamedTuple):
    """Analytic room: vertical cylinder wall + two horizontal planes."""

    radius: float = 6.0
    floor_z: float = -1.8
    ceiling_z: float = 2.2
    texture_scale: float = 1.2
    seed: int = 1234


def _hash3(ix: jnp.ndarray, iy: jnp.ndarray, iz: jnp.ndarray, seed: int) -> jnp.ndarray:
    """Deterministic lattice hash -> [0, 1) floats (integer mix, no tables)."""
    n = (
        ix.astype(jnp.uint32) * jnp.uint32(73856093)
        ^ iy.astype(jnp.uint32) * jnp.uint32(19349663)
        ^ iz.astype(jnp.uint32) * jnp.uint32(83492791)
        ^ jnp.uint32(seed)
    )
    n = n * jnp.uint32(2654435761)
    n = n ^ (n >> 13)
    n = n * jnp.uint32(1274126177)
    n = n ^ (n >> 16)
    return (n & jnp.uint32(0x00FFFFFF)).astype(jnp.float32) / jnp.float32(0x01000000)


def value_noise(p: jnp.ndarray, seed: int) -> jnp.ndarray:
    """Trilinear value noise at (..., 3) points."""
    p0 = jnp.floor(p)
    f = p - p0
    f = f * f * (3.0 - 2.0 * f)  # smoothstep
    i = p0.astype(jnp.int32)

    def corner(dx, dy, dz):
        return _hash3(i[..., 0] + dx, i[..., 1] + dy, i[..., 2] + dz, seed)

    c000, c100 = corner(0, 0, 0), corner(1, 0, 0)
    c010, c110 = corner(0, 1, 0), corner(1, 1, 0)
    c001, c101 = corner(0, 0, 1), corner(1, 0, 1)
    c011, c111 = corner(0, 1, 1), corner(1, 1, 1)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    x00 = c000 + (c100 - c000) * fx
    x10 = c010 + (c110 - c010) * fx
    x01 = c001 + (c101 - c001) * fx
    x11 = c011 + (c111 - c011) * fx
    y0 = x00 + (x10 - x00) * fy
    y1 = x01 + (x11 - x01) * fy
    return y0 + (y1 - y0) * fz


def texture(p: jnp.ndarray, scene: RoomScene) -> jnp.ndarray:
    """Multi-octave value-noise texture in [0, 1]; corner-rich for Harris."""
    s = scene.texture_scale
    t = (
        0.55 * value_noise(p * s, scene.seed)
        + 0.3 * value_noise(p * (s * 3.1), scene.seed + 1)
        + 0.15 * value_noise(p * (s * 9.7), scene.seed + 2)
    )
    # Superimpose a faint checker to guarantee strong corners everywhere.
    checker = jnp.mod(jnp.floor(p[..., 0] * s * 2) + jnp.floor(p[..., 1] * s * 2) + jnp.floor(p[..., 2] * s * 2), 2.0)
    return jnp.clip(0.75 * t + 0.25 * checker, 0.0, 1.0)


def _ray_room(origin: jnp.ndarray, d: jnp.ndarray, scene: RoomScene) -> jnp.ndarray:
    """Nearest positive intersection parameter t of ray with the room (inside)."""
    big = jnp.float32(1e9)
    # Cylinder x^2 + y^2 = R^2 (infinite; capped by planes below).
    a = d[..., 0] ** 2 + d[..., 1] ** 2
    b = 2.0 * (origin[..., 0] * d[..., 0] + origin[..., 1] * d[..., 1])
    c = origin[..., 0] ** 2 + origin[..., 1] ** 2 - scene.radius**2
    disc = b * b - 4.0 * a * c
    a_safe = jnp.where(a > 1e-9, a, 1.0)
    t_cyl = (-b + jnp.sqrt(jnp.maximum(disc, 0.0))) / (2.0 * a_safe)  # outgoing root
    z_cyl = origin[..., 2] + t_cyl * d[..., 2]
    cyl_ok = (a > 1e-9) & (disc > 0.0) & (t_cyl > 1e-4) & (z_cyl >= scene.floor_z) & (z_cyl <= scene.ceiling_z)
    t_cyl = jnp.where(cyl_ok, t_cyl, big)
    # Planes.
    dz_safe = jnp.where(jnp.abs(d[..., 2]) > 1e-9, d[..., 2], 1.0)
    t_fl = (scene.floor_z - origin[..., 2]) / dz_safe
    t_ce = (scene.ceiling_z - origin[..., 2]) / dz_safe
    fl_ok = (jnp.abs(d[..., 2]) > 1e-9) & (t_fl > 1e-4)
    ce_ok = (jnp.abs(d[..., 2]) > 1e-9) & (t_ce > 1e-4)
    t_fl = jnp.where(fl_ok, t_fl, big)
    t_ce = jnp.where(ce_ok, t_ce, big)
    return jnp.minimum(t_cyl, jnp.minimum(t_fl, t_ce))


def render_frame(rig: OmnistereoRig, T_world_rig: jnp.ndarray, scene: RoomScene = RoomScene()) -> jnp.ndarray:
    """Render the raw omni image (H, W) float32 in [0,1] at a rig pose.

    Both annular views are composited exactly as the physical sensor sees
    them: inner annulus = bottom mirror, outer annulus = top mirror.
    """
    h, w = rig.image_height, rig.image_width
    vv = jnp.arange(h, dtype=jnp.float32)[:, None].repeat(w, 1)
    uu = jnp.arange(w, dtype=jnp.float32)[None, :].repeat(h, 0)
    uvgrid = jnp.stack([uu, vv], axis=-1)  # (H, W, 2)

    R = T_world_rig[:3, :3]
    t = T_world_rig[:3, 3]

    def shade_view(view):
        ray_v, ok = lift(view, uvgrid)                      # rig-frame dirs
        mask = annulus_mask(view, h, w) & ok
        origin = t + (R @ viewpoint(view))                   # world viewpoint
        d = rotate_dirs(R, ray_v.reshape(-1, 3)).reshape(h, w, 3)
        tt = _ray_room(jnp.broadcast_to(origin, d.shape), d, scene)
        p = origin + tt[..., None] * d
        val = texture(p, scene)
        # Gentle vignette toward annulus edges avoids hard ring gradients.
        return jnp.where(mask & (tt < 1e8), val, 0.0), mask

    img_top, m_top = shade_view(rig.top)
    img_bot, m_bot = shade_view(rig.bottom)
    return jnp.where(m_top, img_top, jnp.where(m_bot, img_bot, 0.0))


def render_sequence(rig: OmnistereoRig, poses: jnp.ndarray, scene: RoomScene = RoomScene()) -> jnp.ndarray:
    """(F, H, W) rendered sequence; lax.map to bound memory on long sequences."""
    return jax.lax.map(lambda T: render_frame(rig, T, scene), poses)
