"""HQ-CBR rate control: batched binary search + luma-SSE hill climb.

The reference runs, per slice, a 7-step binary search for the smallest
quantiser whose trial-quantised slice fits the byte budget, then walks the
quantiser upward while the luma sum-of-squares keeps improving
(/root/reference/src/EncodeStream/EncodeStream.cpp:73-125, yss_for_slice at
src/Library/src/Quantisation.cpp:627-642). That is ~10 full
quantise+size passes over every coefficient — the encode-time hot loop.

Here each search step quantises and sizes *all* slices simultaneously:
one (nSlices, L) element-wise pass per step, with the per-slice
trial-quantiser vector updated by masked arithmetic, replicating the
reference's probe sequence verbatim (so no monotonicity assumption is
needed anywhere). The trial passes never divide: a slice's size only needs
each coefficient's *code bit length*, i.e. bitlength(m+1) for the quotient
m = (|v|<<2) // qf, and that is recovered exactly from precomputed
(bitlength, normalised-mantissa) forms of the magnitudes and the
quant_factor table — floor(log2(m4/qf)) comes from a bitlength difference
plus one normalised uint32 compare, then a single multiply-free
shift-compare settles whether m+1 is exactly a power of two
(_component_bits_fast below). ~3x cheaper per trial than running the
reciprocal-division quantiser, and bit-identical: tests/test_rdo.py checks
it against the real quantise+count over adversarial lanes.

The hill climb (which genuinely needs reconstructions, hence divisions) is
a batched K-step prefix plus a ``lax.while_loop`` for the rare tail.
Identical decisions to the reference, no per-slice loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from vc2tpu.quant.quantiser import (ABS_QF_I32, QUANT_FACTORS_I32,
                                    QUANT_OFFSETS, RECIP_QF_F32, _quant_core,
                                    _scale_core, banded_aq, banded_lookup,
                                    expand_bands, mxu_tables_enabled,
                                    pack_tables, quant_banded,
                                    signed_vlc_numbits)

# Static sizing tables over the adjusted-quantiser domain [0, 119]:
# |quant_factor| (as the quantiser's clamped ABS_QF_I32), its bit length,
# and its mantissa normalised to the uint32 top bit.
_ABS_QF_U32 = ABS_QF_I32.astype(np.uint32)
_BL_QF = np.array([int(x).bit_length() for x in _ABS_QF_U32], np.int32)
_QF_NORM = (_ABS_QF_U32 << (32 - _BL_QF)).astype(np.uint32)

# One-hot-matmul plane packs (quantiser.banded_lookup): on the TPU this codec
# was first built for, the per-(slice, band) table gathers took most of the
# search's device time, and the matmul lookup removes them from the probe
# passes, the hill climb and the final quantise alike.
_SIZING_PACK = pack_tables(_ABS_QF_U32, _BL_QF, _QF_NORM)
_YSS_PACK = pack_tables(ABS_QF_I32, RECIP_QF_F32, QUANT_FACTORS_I32,
                        QUANT_OFFSETS)


def _sizing_tables(q, qm_bands):
    """(|qf| u32, bitlength, mantissa u32) per (N, band), gather-free on
    accelerators (route: quantiser.mxu_tables_enabled)."""
    if mxu_tables_enabled():
        t = banded_lookup(q, qm_bands, _SIZING_PACK)
        return (lax.bitcast_convert_type(t[..., 0], jnp.uint32), t[..., 1],
                lax.bitcast_convert_type(t[..., 2], jnp.uint32))
    aq = banded_aq(q, qm_bands)
    return (jnp.asarray(_ABS_QF_U32)[aq], jnp.asarray(_BL_QF)[aq],
            jnp.asarray(_QF_NORM)[aq])


def _yss_tables(q, qm_bands):
    """(absqf, recip, wrapped, offset) per (N, band) for the hill climb."""
    if mxu_tables_enabled():
        t = banded_lookup(q, qm_bands, _YSS_PACK)
        return (t[..., 0], lax.bitcast_convert_type(t[..., 1], jnp.float32),
                t[..., 2], t[..., 3])
    aq = banded_aq(q, qm_bands)
    return (jnp.asarray(ABS_QF_I32)[aq], jnp.asarray(RECIP_QF_F32)[aq],
            jnp.asarray(QUANT_FACTORS_I32)[aq], jnp.asarray(QUANT_OFFSETS)[aq])


def _magnitude_forms(lanes):
    """Per-coefficient precompute shared by every trial pass: the shifted
    magnitude m4 = |v|<<2 (the quantiser's numerator), its bit length, and
    its mantissa normalised to the top bit. int32-exact for |v| < 2^29 —
    the quantiser's own documented domain."""
    m4 = (jnp.abs(lanes).astype(jnp.uint32)) << 2
    s = m4
    s = s | (s >> 1)
    s = s | (s >> 2)
    s = s | (s >> 4)
    s = s | (s >> 8)
    s = s | (s >> 16)
    blm = jnp.asarray(jnp.bitwise_count(s), dtype=jnp.int32)
    m4n = m4 << (((32 - blm) & 31).astype(jnp.uint32))   # m4=0: unused
    return m4, blm, m4n


def _component_bits_fast(forms, tables, band_sizes):
    """Truncated VLC bit count of each slice's component at the per-slice
    adjusted quantisers, without dividing.

    For m = m4 // qf >= 1 the signed interleaved exp-Golomb code costs
    2*bitlength(m+1) bits (1 bit when m == 0). With e = floor(log2(m4/qf))
    (exact: bitlength difference + one normalised-mantissa compare),
    bitlength(m+1) is e+1 unless m+1 == 2^(e+1), settled by the single
    exact test m4 + qf >= qf << (e+1). Matches
    signed_vlc_numbits(quant_banded(...)) bit-for-bit (tests/test_rdo.py);
    mirrors component_slice_bytes (reference Slices.cpp:97-119) including
    the trailing-zero truncation rule. ``tables`` are the (N, B) per-band
    gathers — shared by all three components of a trial (one lookup per
    (slice, band); the broadcasts here are cheap).
    """
    m4, blm, m4n = forms
    qf_b, blq_b, qfn_b = tables
    qf = expand_bands(qf_b, band_sizes)
    blq = expand_bands(blq_b, band_sizes)
    qfn = expand_bands(qfn_b, band_sizes)
    e1 = blm - blq + (m4n >= qfn).astype(jnp.int32)      # e + 1
    sh = jnp.clip(e1, 0, 31).astype(jnp.uint32)
    pow2 = ((blq + e1) <= 32) & ((m4 + qf) >= (qf << sh))
    nb = jnp.where(e1 <= 0, 1, 2 * (e1 + pow2.astype(jnp.int32)))
    L = nb.shape[-1]
    idx = jnp.arange(L, dtype=jnp.int32)
    last_nz = jnp.max(jnp.where(e1 > 0, idx, -1), axis=-1)
    gross = jnp.sum(nb, axis=-1, dtype=jnp.int32)
    return gross - (L - 1 - last_nz)


def _slice_bytes_fast(q, forms_y, forms_u, forms_v, qm_bands, bs_y, bs_c,
                      scalar: int):
    """Scaled byte size of every slice at per-slice quantiser q (n,)."""
    tables = _sizing_tables(q, qm_bands)

    def comp(forms, bs):
        count = _component_bits_fast(forms, tables, bs)
        return ((count + 7) // 8 + scalar - 1) // scalar * scalar

    return (comp(forms_y, bs_y) + comp(forms_u, bs_c) + comp(forms_v, bs_c))


def _component_bytes(lanes, q, qm_bands, band_sizes, scalar: int):
    """Reference-shaped sizing through the real quantiser (division path);
    kept as the equivalence oracle for _component_bits_fast and for
    callers outside the search hot loop.

    Mirrors component_slice_bytes (reference Slices.cpp:97-119) including
    the trailing-zero truncation rule.
    """
    qlanes = quant_banded(lanes, q, qm_bands, band_sizes)
    nbits = signed_vlc_numbits(qlanes)
    L = qlanes.shape[-1]
    idx = jnp.arange(L, dtype=jnp.int32)
    last_nz = jnp.max(jnp.where(qlanes != 0, idx, -1), axis=-1)
    count = jnp.sum(nbits, axis=-1, dtype=jnp.int32) - (L - 1 - last_nz)
    scaled = ((count + 7) // 8 + scalar - 1) // scalar
    return scaled * scalar


def _slice_bytes_at(q, lanes_y, lanes_u, lanes_v, qm_bands, bs_y, bs_c,
                    scalar: int):
    return (_component_bytes(lanes_y, q, qm_bands, bs_y, scalar)
            + _component_bytes(lanes_u, q, qm_bands, bs_c, scalar)
            + _component_bytes(lanes_v, q, qm_bands, bs_c, scalar))


def _yss(lanes_y, q, qm_bands, bs_y):
    """Luma sum-of-squared reconstruction error at quantiser q (int64).
    Quantise + rescale with ONE shared table fetch (quant needs the wrapped
    factor's sign, scale its value)."""
    absqf_b, recip_b, wrapped_b, qo_b = _yss_tables(q, qm_bands)
    absqf = expand_bands(absqf_b, bs_y)
    recip = expand_bands(recip_b, bs_y)
    wrapped = expand_bands(wrapped_b, bs_y)
    qo = expand_bands(qo_b, bs_y)
    qv = _quant_core(lanes_y.astype(jnp.int32), absqf, recip, wrapped < 0)
    rec = _scale_core(qv, wrapped, qo)
    d = (lanes_y - rec).astype(jnp.int64)
    return jnp.sum(d * d, axis=1)


def cbr_quant_indices(lanes_y, lanes_u, lanes_v, qm_bands, bs_y, bs_c,
                      budgets, scalar: int):
    """Per-slice quantiser indices for HQ-CBR.

    lanes_*: int32 (N, L_comp) unquantised transform lanes (band-contiguous);
    qm_bands: int32 (B,) quant-matrix offsets; bs_y/bs_c: static band sizes;
    budgets: int32 (N,) nominal slice bytes (slice_bytes map).
    Returns int32 (N,).
    """
    available = budgets.astype(jnp.int32) - 4
    n = lanes_y.shape[0]
    forms = (_magnitude_forms(lanes_y), _magnitude_forms(lanes_u),
             _magnitude_forms(lanes_v))
    trial = jnp.full((n,), 63, dtype=jnp.int32)
    best = jnp.full((n,), 127, dtype=jnp.int32)
    delta = 64
    while delta > 1:
        delta >>= 1
        required = _slice_bytes_fast(trial, *forms, qm_bands, bs_y, bs_c,
                                     scalar)
        fits = required <= available
        best = jnp.where(fits & (trial < best), trial, best)
        trial = jnp.where(fits, trial - delta, trial + delta)
    # final binary-search iteration (delta reaches 0 after this probe)
    required = _slice_bytes_fast(trial, *forms, qm_bands, bs_y, bs_c, scalar)
    fits = required <= available
    best = jnp.where(fits & (trial < best), trial, best)

    # hill climb: raise q while the luma SSE strictly improves
    # (reference EncodeStream.cpp:107-120). The final q is
    # best + (number of consecutive strict improvements), so the first K
    # steps evaluate as ONE batched pass over (slice, candidate) — the
    # while_loop only continues for the rare slices still improving past K.
    K = 3        # typical climbs are 0-2 steps; the loop handles the tail
    cand = best[:, None] + jnp.arange(K + 1, dtype=jnp.int32)[None, :]
    yss_k = jax.vmap(lambda q: _yss(lanes_y, q, qm_bands, bs_y),
                     in_axes=1, out_axes=1)(cand)          # (N, K+1)
    improve = yss_k[:, 1:] < yss_k[:, :-1]                  # (N, K)
    run = jnp.cumprod(improve.astype(jnp.int32), axis=1)    # consecutive
    c = jnp.sum(run, axis=1)
    trial_q = best + c
    prev = jnp.take_along_axis(yss_k, c[:, None], axis=1)[:, 0]

    def cond(state):
        _, _, active = state
        return jnp.any(active)

    def body(state):
        trial_q, prev, active = state
        nxt = jnp.where(active, trial_q + 1, trial_q)
        cur = _yss(lanes_y, nxt, qm_bands, bs_y)
        dss = cur - prev
        prev = jnp.where(active, cur, prev)
        still = active & (dss < 0)
        return nxt, prev, still

    # only slices whose whole first-K run improved may keep climbing; the
    # mask derives from data so its shard_map "varying" type matches the body
    active = c == K
    trial_q, prev, active = jax.lax.while_loop(
        cond, body, (trial_q, prev, active))
    # while_loop applied the failed step to its active slices; the batched
    # prefix did not — align to the reference's trial_q semantics
    return jnp.where(c == K, trial_q - 1, trial_q)
