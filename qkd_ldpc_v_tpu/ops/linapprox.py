"""Piecewise-linear tanh/atanh approximations for the SPA-LIN-APPROX decoder.

Same segment boundaries and coefficients as the reference
(reference: src/qkd_ldpc_algorithm.cpp:146-172). Vectorized as a chain of
``jnp.where`` selects (first-true-wins, like the reference's if/else
ladder), which XLA fuses into one elementwise kernel.
"""

from __future__ import annotations

import jax.numpy as jnp

_TANH_BOUNDS = (0.5, 0.9, 1.2, 1.75, 2.5, 3.5, 8.0)
_TANH_COEFFS = (
    (0.9242, 0.0),
    (0.6355, 0.1444),
    (0.3912, 0.3642),
    (0.1958, 0.5986),
    (0.0603, 0.8358),
    (0.0115, 0.9577),
    (0.0004, 0.9967),
)

_ATANH_BOUNDS = (0.7, 0.9, 0.999)
_ATANH_COEFFS = (
    (1.196, -0.0323),
    (2.9187, -1.214),
    (10.8717, -8.3717),
    (2510.9, -2505.9),
)


def guard_atanh_ratio(ratio, dtype):
    """Keep the true-SPA exclusion ratio ``prod / tanh_i`` inside atanh's
    open domain in the fast (float32/bfloat16) modes.

    At reduced precision, rounding routinely pushes ``|prod / t|`` to >= 1
    (``atanh`` -> inf, then ``inf - inf`` -> NaN in the bit pass) and a
    message rounding to exactly zero makes the ratio 0/0 -> NaN; the
    reference's float64 arithmetic makes both vanishingly rare (measured on
    the reference's alist 10k matrix at QBER 0.03: unguarded f32 SPA FER
    0.163 vs the reference's 0.0006 — the guard restores statistical FER
    parity, tests/test_decoders.py). Clamps to the largest representable
    value below one (so the extrinsic saturates at ``2*atanh(1 - ulp)``)
    and neutralizes NaN ratios to zero. The float64 parity path never
    applies this guard — it stays bit-exact with the reference.
    """
    limit = jnp.asarray(1.0, dtype) - jnp.asarray(jnp.finfo(dtype).epsneg, dtype)
    out = jnp.clip(ratio, -limit, limit)
    return jnp.where(jnp.isnan(ratio), jnp.asarray(0.0, dtype), out)


def _piecewise(ax, bounds, vals, default):
    """First-true-wins where-chain: fold from the last segment backward."""
    res = default
    for b, v in zip(reversed(bounds), reversed(vals)):
        res = jnp.where(ax < b, v, res)
    return res


def tanh_lin_approx(x: jnp.ndarray) -> jnp.ndarray:
    """8-segment tanh approximation (|x| >= 8 saturates to 1)."""
    ax = jnp.abs(x)
    vals = [a * ax + b for a, b in _TANH_COEFFS]
    res = _piecewise(ax, _TANH_BOUNDS, vals, jnp.ones_like(ax))
    return jnp.where(x < 0, -res, res)


def atanh_lin_approx(x: jnp.ndarray) -> jnp.ndarray:
    """4-segment atanh approximation (last segment extrapolates linearly)."""
    ax = jnp.abs(x)
    vals = [a * ax + b for a, b in _ATANH_COEFFS[:-1]]
    a_last, b_last = _ATANH_COEFFS[-1]
    res = _piecewise(ax, _ATANH_BOUNDS, vals, a_last * ax + b_last)
    return jnp.where(x < 0, -res, res)
