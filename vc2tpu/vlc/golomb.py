"""Interleaved exp-Golomb codes, vectorised for the device.

The wire format (reference /root/reference/src/Library/src/VLC.cpp:21-94):
unsigned value v is coded as u = v+1; for each bit of u below its top bit,
MSB first, emit a 0 "follow" bit then the data bit; terminate with a 1.
Signed values append a sign bit (1 = negative) when v != 0.

Construction trick: the data bits of ``m = u - 2^(k-1)`` spread into even
bit positions (a Morton spread) give exactly the interleaved pattern
Σ d_j·4^j; the full code is ``(spread(m) << 1 | 1)`` plus an optional sign
bit. Codes are returned as (lo32, hi32, nbits) uint32 triplets so the device
computation stays 32-bit (no x64 mode needed).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def _bitlen_u32(u):
    s = u
    s = s | (s >> 1)
    s = s | (s >> 2)
    s = s | (s >> 4)
    s = s | (s >> 8)
    s = s | (s >> 16)
    return jnp.asarray(jnp.bitwise_count(s), dtype=jnp.uint32)


def _spread16(x):
    """Spread the low 16 bits of x into even positions of 32 bits."""
    x = x & jnp.uint32(0xFFFF)
    x = (x | (x << 8)) & jnp.uint32(0x00FF00FF)
    x = (x | (x << 4)) & jnp.uint32(0x0F0F0F0F)
    x = (x | (x << 2)) & jnp.uint32(0x33333333)
    x = (x | (x << 1)) & jnp.uint32(0x55555555)
    return x


def signed_codes(values):
    """Signed interleaved exp-Golomb code of each int32 value.

    Returns (lo, hi, nbits) — uint32 arrays; the code occupies the low
    ``nbits`` bits of (hi << 32 | lo), MSB of the code first when written.
    """
    v = values.astype(jnp.int32)
    u = (jnp.abs(v) + 1).astype(jnp.uint32)
    k = _bitlen_u32(u)                       # bit_length(|v|+1) >= 1
    m = u ^ (jnp.uint32(1) << (k - 1))       # clear top bit
    s_lo = _spread16(m)                      # bits 0..31 of spread
    s_hi = _spread16(m >> 16)                # bits 32..63 of spread
    nonzero = v != 0
    shift = jnp.where(nonzero, jnp.uint32(2), jnp.uint32(1))
    # tail = terminator '1' then optional sign bit
    sign = (v < 0).astype(jnp.uint32)
    tail = jnp.where(nonzero, jnp.uint32(2) | sign, jnp.uint32(1))
    lo = (s_lo << shift) | tail
    hi = (s_hi << shift) | (s_lo >> (jnp.uint32(32) - shift))
    nbits = jnp.where(nonzero, 2 * k, jnp.uint32(1))
    return lo, hi, nbits.astype(jnp.uint32)


def signed_numbits(values):
    v = values
    u = (jnp.abs(v) + 1).astype(jnp.uint32)
    k = _bitlen_u32(u).astype(jnp.int32)
    return jnp.where(v == 0, 1, 2 * k)


def component_bits_used(nbits, nonzero, axis=-1):
    """"count" semantics of the reference size functions: gross bit count up
    to and including the last non-zero coefficient (trailing 1-bit codes of
    zero values are truncated) — reference src/Library/src/Slices.cpp:97-119.
    """
    gross = jnp.cumsum(nbits.astype(jnp.int32), axis=axis)
    return jnp.max(jnp.where(nonzero, gross, 0), axis=axis)


def component_slice_bytes(count_bits, scalar: int):
    """Whole number of scalar-byte units holding ``count_bits``
    (reference Slices.cpp:114-118). Returns (bytes, overflowed_255)."""
    scaled = ((count_bits + 7) // 8 + scalar - 1) // scalar
    return scaled * scalar, scaled > 0xFF


# ---------------------------------------------------------------- host side

def encode_unsigned_scalar(value: int) -> tuple[int, int]:
    """(nbits, bits) of the unsigned code — host scalar for stream headers."""
    if value == 0:
        return 1, 1
    u = value + 1
    k = u.bit_length()
    bits = 0
    for j in range(k - 2, -1, -1):
        bits <<= 2
        if (u >> j) & 1:
            bits |= 1
    bits = (bits << 1) | 1
    return 2 * (k - 1) + 1, bits


def encode_signed_scalar(value: int) -> tuple[int, int]:
    if value == 0:
        return 1, 1
    nbits, bits = encode_unsigned_scalar(abs(value))
    bits <<= 1
    if value < 0:
        bits |= 1
    return nbits + 1, bits


def signed_codes_np(values: np.ndarray):
    """NumPy twin of signed_codes for host-side paths/tests."""
    v = values.astype(np.int64)
    u = (np.abs(v) + 1).astype(np.uint64)
    k = np.zeros(v.shape, dtype=np.uint64)
    s = u.copy()
    while True:
        nz = s > 0
        if not nz.any():
            break
        k[nz] += 1
        s >>= 1
    m = u ^ (np.uint64(1) << (k - 1))
    spread = np.zeros(v.shape, dtype=np.uint64)
    for j in range(32):
        spread |= ((m >> np.uint64(j)) & 1) << np.uint64(2 * j)
    nonzero = v != 0
    sign = (v < 0).astype(np.uint64)
    code = np.where(nonzero, (((spread << 1) | 1) << 1) | sign, 1).astype(np.uint64)
    nbits = np.where(nonzero, 2 * k, 1).astype(np.uint32)
    return code, nbits
