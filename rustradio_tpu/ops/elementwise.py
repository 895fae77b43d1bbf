"""Elementwise sample ops.

Trivial on the device: XLA fuses chains of these into neighbouring kernels, so unlike
the reference (one block + one buffer each: src/add_const.rs, src/xor.rs,
src/multiply_const.rs, src/complex_to_mag2.rs, src/binary_slicer.rs,
src/convert.rs) they cost no memory traffic when composed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def add_const(x, val):
    """x + val (reference src/add_const.rs)."""
    return x + val


def multiply_const(x, val):
    """x * val (reference src/multiply_const.rs)."""
    return x * val


def xor_const(x, val):
    """x ^ val (reference src/xor_const.rs)."""
    return jnp.bitwise_xor(x, jnp.asarray(val, x.dtype))


def add(a, b):
    """a + b, two streams (reference src/add.rs)."""
    return a + b


def multiply(a, b):
    return a * b


def xor(a, b):
    """a ^ b (reference src/xor.rs)."""
    return jnp.bitwise_xor(a, b)


def complex_to_mag2(x):
    """|x|^2 = re^2 + im^2 (reference src/complex_to_mag2.rs:18-20)."""
    return jnp.real(x) ** 2 + jnp.imag(x) ** 2


def binary_slicer(x):
    """float > 0 -> 1u8 else 0u8 (reference src/binary_slicer.rs:17-19)."""
    return (x > 0).astype(jnp.uint8)


def float_to_complex(re, im=None):
    """(re, im) float streams -> complex64 (reference src/convert.rs:261)."""
    if im is None:
        im = jnp.zeros_like(re)
    return jax.lax.complex(
        jnp.asarray(re, jnp.float32), jnp.asarray(im, jnp.float32)
    )


def complex_to_float(x):
    """complex -> (re, im) pair of float streams (reference src/convert.rs:290)."""
    return jnp.real(x), jnp.imag(x)


def complex_to_real(x):
    return jnp.real(x)
