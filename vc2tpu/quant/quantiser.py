"""Dead-zone quantiser / inverse quantiser, fully vectorised.

Bit-exact re-implementation of the reference scalar functions
(/root/reference/src/Library/src/Quantisation.cpp:16-95):

* ``quant(v, q)  = sign(v) * ((|v| << 2) / quant_factor(q))``
* ``scale(v, q)  = sign(v) * ((|v| * quant_factor(q) [+offset] + 2) / 4)``
* ``adjust(qIndex, qMatrix) = max(qIndex - qMatrix, 0)``

with C truncating division and int32 wrap-around (the reference's
``value *= quant_factor(q)`` wraps int32 for extreme values).

The quant_factor table is the 120-entry VC-2 standard table
(Quantisation.cpp:40-66); it is *data* from SMPTE ST 2042-1 (approximately
round(2^(q/4+2)) but with standard-specified low bits at high q, so it must
be tabulated, not derived). Indices above 119 raise in the reference; on
device we clamp the lookup and flag overflow host-side.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

# VC-2 quantisation factor table, quant_factor(q) for q in [0, 119]
# (SMPTE ST 2042-1; reference Quantisation.cpp:42-59).
QUANT_FACTORS = np.array([
    0x000000004, 0x000000005, 0x000000006, 0x000000007, 0x000000008, 0x00000000A, 0x00000000B, 0x00000000D,
    0x000000010, 0x000000013, 0x000000017, 0x00000001B, 0x000000020, 0x000000026, 0x00000002D, 0x000000036,
    0x000000040, 0x00000004C, 0x00000005B, 0x00000006C, 0x000000080, 0x000000098, 0x0000000B5, 0x0000000D7,
    0x000000100, 0x000000130, 0x00000016A, 0x0000001AF, 0x000000200, 0x000000261, 0x0000002D4, 0x00000035D,
    0x000000400, 0x0000004C2, 0x0000005A8, 0x0000006BA, 0x000000800, 0x000000983, 0x000000B50, 0x000000D74,
    0x000001000, 0x000001307, 0x0000016A1, 0x000001AE9, 0x000002000, 0x00000260E, 0x000002D41, 0x0000035D1,
    0x000004000, 0x000004C1C, 0x000005A82, 0x000006BA2, 0x000008000, 0x000009838, 0x00000B505, 0x00000D745,
    0x000010000, 0x000013070, 0x000016A0A, 0x00001AE8A, 0x000020000, 0x0000260E0, 0x00002D414, 0x000035D14,
    0x000040000, 0x00004C1C0, 0x00005A828, 0x00006BA28, 0x000080000, 0x00009837F, 0x0000B504F, 0x0000D7450,
    0x000100000, 0x0001306FE, 0x00016A09E, 0x0001AE8A0, 0x000200000, 0x000260DFC, 0x0002D413D, 0x00035D13F,
    0x000400000, 0x0004C1BF8, 0x0005A827A, 0x0006BA27E, 0x000800000, 0x0009837F0, 0x000B504F3, 0x000D744FD,
    0x001000000, 0x001306FE1, 0x0016A09E6, 0x001AE89FA, 0x002000000, 0x00260DFC1, 0x002D413CD, 0x0035D13F3,
    0x004000000, 0x004C1BF83, 0x005A8279A, 0x006BA27E6, 0x008000000, 0x009837F05, 0x00B504F33, 0x00D744FCD,
    0x010000000, 0x01306FE0A, 0x016A09E66, 0x01AE89F99, 0x020000000, 0x0260DFC14, 0x02D413CCD, 0x035D13F33,
    0x040000000, 0x04C1BF829, 0x05A82799A, 0x06BA27E65, 0x080000000, 0x09837F052, 0x0B504F334, 0x0D744FCCB,
], dtype=np.int64)

MAX_QINDEX = len(QUANT_FACTORS) - 1  # 119

# int32-wrapped views — the reference casts the uint32 table entries to int,
# so factors >= 2^31 become negative int32 values (Quantisation.cpp:65).
QUANT_FACTORS_I32 = QUANT_FACTORS.astype(np.uint32).astype(np.int32)

# quant_offset(q) (reference Quantisation.cpp:78-83), evaluated on the
# int32-wrapped factor with C truncating division.
_qf64 = QUANT_FACTORS_I32.astype(np.int64)
_off = np.where(_qf64 >= 0, (_qf64 + 1) // 2, -((-(_qf64 + 1)) // 2))
QUANT_OFFSETS = np.where(
    np.arange(len(QUANT_FACTORS)) == 0, 1,
    np.where(np.arange(len(QUANT_FACTORS)) == 1, 2, _off),
).astype(np.int32)


def quant_factor(q: int) -> int:
    if q > MAX_QINDEX:
        raise ValueError("quantization index exceeds maximum implemented value.")
    return int(QUANT_FACTORS_I32[max(q, 0)])


def quant_offset(q: int) -> int:
    return int(QUANT_OFFSETS[max(q, 0)])


def adjust_quant_index(q_index, q_matrix):
    """max(qIndex - qMatrix, 0) (reference Quantisation.cpp:16-20)."""
    return jnp.maximum(q_index - q_matrix, 0)


def _trunc_div_i32(a, b):
    """C truncating division on int32 lanes (int32 only)."""
    q = jnp.abs(a) // jnp.abs(b)
    return jnp.where((a < 0) ^ (b < 0), -q, q)


# |quant_factor| and its float32 reciprocal. quant() computes a float32
# reciprocal estimate and makes it exact with a residual refinement step plus
# two +-1 fix-up rounds (below): the TPU this codec was first built for has
# no integer divide unit, and a multiply beats a divide on any accelerator.
ABS_QF_I32 = np.minimum(np.abs(QUANT_FACTORS_I32.astype(np.int64)),
                        2**31 - 1).astype(np.int32)   # INT_MIN entry clamps;
# the <<2 magnitude is a multiple of 4 and < 2^31, so no quotient changes
RECIP_QF_F32 = (np.float32(1.0) / ABS_QF_I32.astype(np.float32))


def _quant_core(v, absqf, recip, neg_qf):
    """Exact floor(mag / absqf) over the whole non-wrapping magnitude domain
    (|v| < 2^29, so the <<2 stays in int32 — far above the ~2^23 coefficient
    ceiling of any legal VC-2 transform, see lifting.coefficient_bound):

    1. float32 reciprocal estimate: |error| <= Q*3*2^-24 + 1 quotient units;
    2. residual refinement: the residual r0 = mag - out*qf is small, so a
       second reciprocal multiply of r0 recovers all but <= 2 units (the
       truncate-vs-floor slack on negative residuals plus one float ulp);
    3. two exact int32 multiply-compare +-1 corrections land the floor.

    int32 wrap-around in the residuals is harmless: the true residual
    magnitude is always < 2^31 so modular arithmetic yields its exact value.
    Verified by the exhaustive high-magnitude sweep in
    tests/test_quant_exact.py, eager and jitted.

    Compilers may contract a float multiply followed by an add into one FMA;
    here no float product feeds a float add (each product is converted to
    int32 straight away and every add and compare is integer), so there is
    nothing to contract and the result is the same on every backend.
    """
    mag = jnp.abs(v) << 2
    out = (mag.astype(jnp.float32) * recip).astype(jnp.int32)
    r = mag - out * absqf
    out = out + (r.astype(jnp.float32) * recip).astype(jnp.int32)
    for _ in range(2):
        r = mag - out * absqf
        out = out + (r >= absqf).astype(jnp.int32) - (r < 0).astype(jnp.int32)
    out = jnp.where(neg_qf, -out, out)       # int32-wrapped table entries
    return jnp.where(v < 0, -out, out).astype(jnp.int32)


def _scale_core(v, qf, qo):
    mag = jnp.abs(v)
    prod = mag * qf                          # int32 wrap
    prod = prod + jnp.where(prod > 0, qo, 0) + 2
    out = jnp.where(prod < 0, -((-prod) >> 2), prod >> 2)  # trunc /4
    return jnp.where(v < 0, -out, out).astype(jnp.int32)


def quant(values, q_indices):
    """Element-wise dead-zone quantise; values int32, q_indices same shape or
    broadcastable. q indices are clamped to the table internally (the caller
    checks the <=119 domain, as the reference throws there).

    Matches the reference's ``sign * ((|v| << 2) / quant_factor(q))``
    (Quantisation.cpp:69-76) bit-exactly for |v| < 2^29 (the whole domain
    where the reference's own <<2 does not overflow int). Prefer
    quant_banded on the hot paths — it gathers tables per subband instead of
    per element.
    """
    v = values.astype(jnp.int32)
    q = jnp.clip(q_indices, 0, MAX_QINDEX).astype(jnp.int32)
    return _quant_core(v, jnp.asarray(ABS_QF_I32)[q],
                       jnp.asarray(RECIP_QF_F32)[q],
                       jnp.asarray(QUANT_FACTORS_I32)[q] < 0)


def scale(values, q_indices):
    """Element-wise inverse quantise (reference Quantisation.cpp:86-95).

    The reference's ``value *= quant_factor(q)`` wraps int32; jnp int32
    multiplication wraps identically. The final /4 truncating division is
    two arithmetic shifts.
    """
    v = values.astype(jnp.int32)
    q = jnp.clip(q_indices, 0, MAX_QINDEX).astype(jnp.int32)
    return _scale_core(v, jnp.asarray(QUANT_FACTORS_I32)[q],
                       jnp.asarray(QUANT_OFFSETS)[q])


# --- banded fast paths ------------------------------------------------------
# Coefficient lanes (slices/layout.lane_order) are contiguous by subband, and
# the quant matrix is constant within a subband, so every per-element table
# lookup can become a (slices, bands) lookup broadcast along static band
# extents: one gathered value per (slice, band) instead of per coefficient.
#
# On the TPU this codec was first built for, even the (slices, bands) gather
# dominated the CBR search, so banded_lookup below can do the lookup as a
# matrix product instead: one-hot(q) @ byte-split table planes. This is
# exact, not approximate — one-hot entries and byte values < 256 are exactly
# representable in bfloat16, and each output row accumulates exactly one
# non-zero product, so the float32 accumulator only ever sees one exact
# value. The gather form is the CPU route and the oracle for exactness tests;
# which form is faster on a GPU is an open measurement (mxu_tables_enabled).

_OH_ROWS = 192   # one-hot q domain; lookups stay exact while every quant
                 # matrix entry is <= _OH_ROWS - 1 - MAX_QINDEX = 72 (the
                 # spec's default matrices max out at 30 for depth <= 6,
                 # wavelet/matrices.py; custom matrices are rejected upstream)


def mxu_tables_enabled() -> bool:
    """Trace-time route choice: one-hot matmul lookup on accelerators,
    gathers on CPU. VC2TPU_MXU_TABLES=0/1 forces (tests cover both routes
    explicitly)."""
    v = os.environ.get("VC2TPU_MXU_TABLES")
    if v is not None:
        return v != "0"
    return jax.default_backend() != "cpu"


def pack_tables(*tables) -> np.ndarray:
    """Byte-split plane matrix for banded_lookup: float32 (120, 4*T) whose
    row q holds the 4 little-endian bytes of each table's bit pattern."""
    planes = []
    for t in tables:
        u = np.ascontiguousarray(t).view(np.uint32)
        planes.append(np.stack([(u >> (8 * k)) & 0xFF for k in range(4)],
                               axis=-1))
    return np.concatenate(planes, axis=-1).astype(np.float32)


def banded_lookup(q, qm_bands, planes):
    """int32 bit patterns of each packed table at clamp(q - qm, 0, 119).

    q: int32 quant indices, any shape, any values (clamped as banded_aq);
    qm_bands: (B,) int32 quant matrix; planes: pack_tables output.
    Returns int32 (q.shape..., B, T). Bit-exact vs TABLE[banded_aq(q, qm)]
    (tests/test_quant_exact.py::test_banded_lookup_exact).
    """
    r = jnp.arange(_OH_ROWS, dtype=jnp.int32)
    remap = jnp.clip(r[:, None] - qm_bands, 0, MAX_QINDEX)       # (R, B)
    packed = jnp.asarray(planes, jnp.bfloat16)[remap]            # (R, B, 4T)
    packed = packed.reshape(_OH_ROWS, -1)
    qflat = jnp.clip(q, 0, _OH_ROWS - 1).reshape(-1)
    oh = (qflat[:, None] == r).astype(jnp.bfloat16)              # (M, R)
    # HIGHEST: bf16 operands with a float32 accumulator, never a reduced
    # precision path; exact because every row sums one product of two
    # bf16-exact integers (< 256), see the section comment above.
    f = jnp.dot(oh, packed, preferred_element_type=jnp.float32,
                precision=lax.Precision.HIGHEST)
    b = f.astype(jnp.int32).reshape(q.shape + (qm_bands.shape[0], -1, 4))
    return (b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
            | (b[..., 3] << 24))

def expand_bands(p, band_sizes: tuple):
    """(..., B) per-band values -> (..., L) per-lane values."""
    parts = [jnp.broadcast_to(p[..., i:i + 1], p.shape[:-1] + (s,))
             for i, s in enumerate(band_sizes)]
    return jnp.concatenate(parts, axis=-1)


def banded_aq(q, qm_bands):
    """Adjusted quant index per (..., band), clamped to the table domain."""
    return jnp.clip(q[..., None] - qm_bands, 0, MAX_QINDEX).astype(jnp.int32)


_QUANT_PACK = pack_tables(ABS_QF_I32, RECIP_QF_F32, QUANT_FACTORS_I32)
_SCALE_PACK = pack_tables(QUANT_FACTORS_I32, QUANT_OFFSETS)


def quant_tables(q, qm_bands):
    """(absqf, recip, wrapped) per (..., band) at the adjusted indices,
    routed per mxu_tables_enabled()."""
    if mxu_tables_enabled():
        t = banded_lookup(q, qm_bands, _QUANT_PACK)
        return (t[..., 0],
                lax.bitcast_convert_type(t[..., 1], jnp.float32),
                t[..., 2])
    aq = banded_aq(q, qm_bands)
    return (jnp.asarray(ABS_QF_I32)[aq], jnp.asarray(RECIP_QF_F32)[aq],
            jnp.asarray(QUANT_FACTORS_I32)[aq])


def scale_tables(q, qm_bands):
    """(wrapped, offset) per (..., band) at the adjusted indices."""
    if mxu_tables_enabled():
        t = banded_lookup(q, qm_bands, _SCALE_PACK)
        return t[..., 0], t[..., 1]
    aq = banded_aq(q, qm_bands)
    return jnp.asarray(QUANT_FACTORS_I32)[aq], jnp.asarray(QUANT_OFFSETS)[aq]


def quant_banded(values, q, qm_bands, band_sizes: tuple):
    """quant() with per-slice q (..., N) against band-contiguous lanes
    (..., N, L); qm_bands is the (B,) quant matrix."""
    absqf_b, recip_b, wrapped_b = quant_tables(q, qm_bands)
    absqf = expand_bands(absqf_b, band_sizes)
    recip = expand_bands(recip_b, band_sizes)
    neg = expand_bands(wrapped_b < 0, band_sizes)
    return _quant_core(values.astype(jnp.int32), absqf, recip, neg)


def scale_banded(values, q, qm_bands, band_sizes: tuple):
    """scale() with per-slice q against band-contiguous lanes."""
    qf_b, qo_b = scale_tables(q, qm_bands)
    qf = expand_bands(qf_b, band_sizes)
    qo = expand_bands(qo_b, band_sizes)
    return _scale_core(values.astype(jnp.int32), qf, qo)


def signed_vlc_numbits(values):
    """Bit count of the signed interleaved exp-Golomb code of each value:
    1 for zero, else 2*bit_length(|v|+1) (reference src/Library/src/VLC.cpp:21-52
    plus the sign bit at :78-85). Vectorised via smear+popcount."""
    u = (jnp.abs(values) + 1).astype(jnp.uint32)
    s = u
    s = s | (s >> 1)
    s = s | (s >> 2)
    s = s | (s >> 4)
    s = s | (s >> 8)
    s = s | (s >> 16)
    bitlen = jnp.asarray(jnp.bitwise_count(s), dtype=jnp.int32)
    return jnp.where(values == 0, 1, 2 * bitlen)


def dc_predict_scalar(restored: np.ndarray, y: int, x: int) -> int:
    """predictDC (reference Quantisation.cpp:191-208), host scalar."""
    if y > 0 and x > 0:
        r = int(restored[y - 1][x - 1]) + int(restored[y - 1][x]) + int(restored[y][x - 1])
        if r >= 0:
            return (r + 1) // 3
        return -((-r + 1) // 3)
    if y > 0:
        return int(restored[y - 1][x])
    if x > 0:
        return int(restored[y][x - 1])
    return 0
