"""SE(2) rigid-body transform algebra as pure JAX array ops.

JAX re-design of the reference SE(2) core
(``rigid2d/include/rigid2d/rigid2d.hpp`` + ``rigid2d/src/rigid2d.cpp``):
instead of a ``Transform2D`` class holding scalars, a transform here is a
trailing-dim-4 array ``[cos(th), sin(th), x, y]`` (the same internal layout the
reference uses, ``rigid2d.hpp:168-175``), so every op broadcasts and vmaps over
arbitrary batch dimensions and fuses under ``jit``.

Twists are trailing-dim-3 arrays ``[dth, dx, dy]`` (ref ``Twist2D``,
``rigid2d.hpp:150-155``). Vectors are trailing-dim-2 ``[x, y]``.

All branchy reference code (the ``dth == 0`` pure-translation branch of
``integrateTwist``, ``rigid2d.cpp:294-328``) is replaced by branchless
sinc-style formulations that are exact at ``dth == 0`` and agree with the
arc construction elsewhere, so the whole module traces to straight-line XLA.

Known reference defects intentionally NOT reproduced (see PARITY.md):
``Vector2D::magnitude``/``normalize`` use ``x`` twice (``rigid2d.cpp:82,96``)
and ``Vector2D::angle`` uses ``atan`` instead of ``atan2``
(``rigid2d.cpp:86-90``); none of those functions feed the SLAM pipeline.
"""

from __future__ import annotations

import jax.numpy as jnp

PI = 3.14159265358979323846

# Component index aliases for transforms [c, s, x, y].
_C, _S, _X, _Y = 0, 1, 2, 3


def deg2rad(deg):
    """Degrees to radians (ref ``rigid2d.hpp:40-44``)."""
    return (PI / 180.0) * deg


def rad2deg(rad):
    """Radians to degrees (ref ``rigid2d.hpp:49-53``)."""
    return (180.0 / PI) * rad


def normalize_angle(rad):
    """Wrap any angle into (-pi, pi] (ref ``rigid2d.cpp:9-13``).

    Uses the same atan2(sin, cos) construction as the reference, which is
    branchless and exactly periodic — ideal under jit.
    """
    return jnp.arctan2(jnp.sin(rad), jnp.cos(rad))


# ---------------------------------------------------------------------------
# Construction / accessors
# ---------------------------------------------------------------------------

def identity(dtype=jnp.float32):
    """Identity transform (ref ``Transform2D::Transform2D()``, rigid2d.cpp:162)."""
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def from_translation(v):
    """Pure translation from vector(s) ``[..., 2]`` (ref rigid2d.cpp:170-176)."""
    v = jnp.asarray(v)
    one = jnp.ones_like(v[..., 0])
    zero = jnp.zeros_like(v[..., 0])
    return jnp.stack([one, zero, v[..., 0], v[..., 1]], axis=-1)


def from_rotation(radians):
    """Pure rotation (ref rigid2d.cpp:178-184)."""
    radians = jnp.asarray(radians)
    zero = jnp.zeros_like(radians)
    return jnp.stack(
        [jnp.cos(radians), jnp.sin(radians), zero, zero], axis=-1
    )


def from_parts(v, radians):
    """Transform from translation ``[..., 2]`` + rotation (ref rigid2d.cpp:186-192)."""
    v = jnp.asarray(v)
    radians = jnp.asarray(radians)
    return jnp.stack(
        [jnp.cos(radians), jnp.sin(radians), v[..., 0], v[..., 1]], axis=-1
    )


def from_pose(pose):
    """Transform from pose array ``[..., 3]`` laid out ``[th, x, y]``.

    The ``[th, x, y]`` ordering matches the EKF robot-state layout
    (ref ``slam_library.cpp:39-63``).
    """
    pose = jnp.asarray(pose)
    th = pose[..., 0]
    return jnp.stack(
        [jnp.cos(th), jnp.sin(th), pose[..., 1], pose[..., 2]], axis=-1
    )


def to_pose(T):
    """Inverse of :func:`from_pose`: ``[th, x, y]`` with th from atan2."""
    T = jnp.asarray(T)
    th = jnp.arctan2(T[..., _S], T[..., _C])
    return jnp.stack([th, T[..., _X], T[..., _Y]], axis=-1)


def angle(T):
    """Rotation angle of transform(s), via atan2 (exact on all quadrants)."""
    T = jnp.asarray(T)
    return jnp.arctan2(T[..., _S], T[..., _C])


# ---------------------------------------------------------------------------
# Group operations
# ---------------------------------------------------------------------------

def apply(T, v):
    """Apply transform(s) to vector(s): ``R v + t`` (ref rigid2d.cpp:194-200)."""
    T = jnp.asarray(T)
    v = jnp.asarray(v)
    c, s = T[..., _C], T[..., _S]
    x = v[..., 0] * c - v[..., 1] * s + T[..., _X]
    y = v[..., 0] * s + v[..., 1] * c + T[..., _Y]
    return jnp.stack([x, y], axis=-1)


def inv(T):
    """Inverse transform (ref ``Transform2D::inv``, rigid2d.cpp:202-211)."""
    T = jnp.asarray(T)
    c, s, x, y = T[..., _C], T[..., _S], T[..., _X], T[..., _Y]
    return jnp.stack(
        [c, -s, -x * c - y * s, x * s - y * c], axis=-1
    )


def compose(Ta, Tb):
    """Composition ``Ta @ Tb`` (ref ``operator*=``, rigid2d.cpp:213-229)."""
    Ta = jnp.asarray(Ta)
    Tb = jnp.asarray(Tb)
    ca, sa, xa, ya = Ta[..., _C], Ta[..., _S], Ta[..., _X], Ta[..., _Y]
    cb, sb, xb, yb = Tb[..., _C], Tb[..., _S], Tb[..., _X], Tb[..., _Y]
    return jnp.stack(
        [
            ca * cb - sa * sb,
            sa * cb + ca * sb,
            ca * xb - sa * yb + xa,
            sa * xb + ca * yb + ya,
        ],
        axis=-1,
    )


def adjoint_twist(T, tw):
    """Change the frame of a twist with the adjoint of ``T``
    (ref ``Transform2D::operator()(Twist2D)``, rigid2d.cpp:276-283).

    ``tw`` is ``[..., 3]`` = ``[dth, dx, dy]``.
    """
    T = jnp.asarray(T)
    tw = jnp.asarray(tw)
    c, s, x, y = T[..., _C], T[..., _S], T[..., _X], T[..., _Y]
    dth, dx, dy = tw[..., 0], tw[..., 1], tw[..., 2]
    return jnp.stack(
        [
            dth,
            y * dth + c * dx - s * dy,
            -x * dth + s * dx + c * dy,
        ],
        axis=-1,
    )


def _sinc_pair(dth, eps=1e-7):
    """Branchless ``(sin(dth)/dth, (1-cos(dth))/dth)`` exact at 0.

    Near 0 uses the series ``sin(x)/x = 1 - x^2/6``, ``(1-cos x)/x = x/2``,
    matching the reference's ``dth == 0`` branch (rigid2d.cpp:299-304) in the
    limit and the center-of-rotation construction (rigid2d.cpp:310-325)
    elsewhere.
    """
    dth = jnp.asarray(dth)
    small = jnp.abs(dth) < eps
    # Guard the denominator so the untaken branch never divides by zero
    # (a NaN in the untaken branch of where() would still poison gradients).
    safe = jnp.where(small, jnp.ones_like(dth), dth)
    s1 = jnp.where(small, 1.0 - dth * dth / 6.0, jnp.sin(safe) / safe)
    s2 = jnp.where(small, dth / 2.0, (1.0 - jnp.cos(safe)) / safe)
    return s1, s2


def integrate_twist(tw):
    """Exponential map: displacement after following a constant twist for
    unit time (ref ``integrateTwist``, rigid2d.cpp:294-328).

    The reference constructs T_bb' = T_bs * T_ss' * T_sb via the center of
    rotation at ``(dy/dth, -dx/dth)``; algebraically that equals the closed
    form used here::

        T = [cos dth, sin dth, dx*s1 - dy*s2, dx*s2 + dy*s1]
        s1 = sin(dth)/dth,  s2 = (1 - cos(dth))/dth

    which is branchless and exact at ``dth == 0`` (pure translation branch,
    rigid2d.cpp:299-304).
    """
    tw = jnp.asarray(tw)
    dth, dx, dy = tw[..., 0], tw[..., 1], tw[..., 2]
    s1, s2 = _sinc_pair(dth)
    return jnp.stack(
        [
            jnp.cos(dth),
            jnp.sin(dth),
            dx * s1 - dy * s2,
            dx * s2 + dy * s1,
        ],
        axis=-1,
    )
