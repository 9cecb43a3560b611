"""Emulated 64-bit unsigned integer arithmetic on uint32 pairs.

The engine runs in JAX's default 32-bit mode (no ``jax_enable_x64``), so
the FracMinHash threshold test — ``mm_hash64(kmer) < U64_MAX / c`` — is
evaluated on explicit (hi, lo) uint32 lane pairs.  Only the operations the
hash needs are provided: add, shl/shr (static shift), xor, not, compare.

The hash itself is the Thomas Wang 64-bit mix used for k-mer hashing
(see pyskani_tpu.oracle.seeding.mm_hash64 for the NumPy reference).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

U32 = jnp.uint32


class U64(NamedTuple):
    hi: jax.Array  # uint32
    lo: jax.Array  # uint32


def from_u32(lo: jax.Array) -> U64:
    lo = lo.astype(U32)
    return U64(jnp.zeros_like(lo), lo)


def from_int(value: int, shape=()) -> U64:
    hi = (value >> 32) & 0xFFFFFFFF
    lo = value & 0xFFFFFFFF
    return U64(jnp.full(shape, hi, U32), jnp.full(shape, lo, U32))


def add(a: U64, b: U64) -> U64:
    lo = a.lo + b.lo
    carry = (lo < a.lo).astype(U32)
    hi = a.hi + b.hi + carry
    return U64(hi, lo)


def not_(a: U64) -> U64:
    return U64(~a.hi, ~a.lo)


def xor(a: U64, b: U64) -> U64:
    return U64(a.hi ^ b.hi, a.lo ^ b.lo)


def or_(a: U64, b: U64) -> U64:
    return U64(a.hi | b.hi, a.lo | b.lo)


def and_(a: U64, b: U64) -> U64:
    return U64(a.hi & b.hi, a.lo & b.lo)


def shl(a: U64, n: int) -> U64:
    """Left shift by a static amount."""
    if n == 0:
        return a
    if n >= 64:
        z = jnp.zeros_like(a.lo)
        return U64(z, z)
    n32 = U32(n)
    if n < 32:
        hi = (a.hi << n32) | (a.lo >> U32(32 - n))
        lo = a.lo << n32
        return U64(hi, lo)
    return U64(a.lo << U32(n - 32), jnp.zeros_like(a.lo))


def shr(a: U64, n: int) -> U64:
    """Logical right shift by a static amount."""
    if n == 0:
        return a
    if n >= 64:
        z = jnp.zeros_like(a.lo)
        return U64(z, z)
    n32 = U32(n)
    if n < 32:
        lo = (a.lo >> n32) | (a.hi << U32(32 - n))
        hi = a.hi >> n32
        return U64(hi, lo)
    return U64(jnp.zeros_like(a.hi), a.hi >> U32(n - 32))


def lt(a: U64, b: U64) -> jax.Array:
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo < b.lo))


def eq(a: U64, b: U64) -> jax.Array:
    return (a.hi == b.hi) & (a.lo == b.lo)


def mm_hash64(key: U64) -> U64:
    """Thomas Wang 64-bit invertible hash on emulated u64 lanes."""
    key = add(not_(key), shl(key, 21))
    key = xor(key, shr(key, 24))
    key = add(add(key, shl(key, 3)), shl(key, 8))
    key = xor(key, shr(key, 14))
    key = add(add(key, shl(key, 2)), shl(key, 4))
    key = xor(key, shr(key, 28))
    key = add(key, shl(key, 31))
    return key
