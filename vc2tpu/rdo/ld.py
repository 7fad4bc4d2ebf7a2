"""LD-profile rate control on the accelerator: wavefront probe ladder.

The reference's LD mode couples every slice through LL-subband DC
prediction: the 7-probe bit-budget binary search re-quantises each slice
against a running reconstructed-LL plane, in strict raster order
(/root/reference/src/EncodeStream/EncodeStream.cpp:195-245 over
src/Library/src/Quantisation.cpp:191-234). That recurrence made LD the one
reference hot loop without an on-chip form — the host-scalar scan
(vc2host.cpp ld_encode) walks the slices one by one.

Decomposition:

* A slice's ladder depends only on the FINAL reconstructions of its left /
  above / above-left neighbours (raster order finalises them first), so
  slices on an anti-diagonal of the slice grid are independent — the
  classic wavefront. One ``lax.scan`` walks the R+C-1 diagonals; each step
  runs the complete 7-probe ladder + final requantise for every slice of
  the diagonal in lockstep (unrolled: probe count and the LL block size
  are static).
* Diagonal-major staging is pure pad+reshape+transpose (``_skew``): the
  row-skew identity ``B[v, v+h] = A[v, h]`` falls out of reinterpreting a
  (R, C+R+1)-padded row-major buffer as (R, C+R) — no gathers, which were
  costly on the TPU this codec was first built for.
* Cross-slice state rides the scan carry as per-lane border rows: a slice
  at (v, h) sits on diagonal d = v+h, its above/left neighbours on d-1 at
  lanes v-1 / v, its above-left on d-2 — so neighbour fetches are static
  lane SHIFTS of the carry, never gathers.
* Probe sizing splits: the non-LL "body" lanes are stateless, sized with
  the division-free forms of rdo/cbr.py (_component_bits_fast's algebra);
  only the tiny LL block (1/4^depth of the slice) runs the real
  quantise/scale recurrence, unrolled over its static extent. Per-probe
  quantiser tables come from ONE banded table lookup
  (quantiser.banded_lookup).

Bit-exact against the native scan (tests/test_ld_device_rdo.py) and, via
it, the reference: identical probe sequence, identical LL arithmetic
(truncating div-by-3 prediction mean, int32-wrapped scale), identical
truncated-bit-count fit decisions including the interleaved-chroma rule
(Slices.cpp:71-95).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
from jax import lax

from vc2tpu.quant.quantiser import (ABS_QF_I32, QUANT_FACTORS_I32,
                                    QUANT_OFFSETS, RECIP_QF_F32, _quant_core,
                                    _scale_core, banded_aq, banded_lookup,
                                    expand_bands, mxu_tables_enabled,
                                    pack_tables)
from vc2tpu.rdo.cbr import _BL_QF, _QF_NORM, _magnitude_forms

_ABS_QF_U32 = ABS_QF_I32.astype(np.uint32)

# One lookup per probe serves both the LL recurrence (|qf|, reciprocal,
# wrapped factor, offset) and the body sizing (|qf|, bit length, mantissa).
_LD_PACK = pack_tables(ABS_QF_I32, _BL_QF, _QF_NORM, RECIP_QF_F32,
                       QUANT_FACTORS_I32, QUANT_OFFSETS)

# Probe deltas AFTER the reference's in-loop shift (EncodeStream.cpp:203-223):
# delta starts at 64, each iteration halves it first, probes, then steps
# trialQ by the shifted delta — the 7th probe leaves trialQ in place.
_DELTAS = (32, 16, 8, 4, 2, 1, 0)


def _tables_at(trial, qm_bands):
    """All six per-band tables at clamp(trial - qm, 0, 119): (absqf u32,
    blq i32, qfn u32, recip f32, wrapped i32, qoffset i32), each (..., B)."""
    if mxu_tables_enabled():
        t = banded_lookup(trial, qm_bands, _LD_PACK)
        return (lax.bitcast_convert_type(t[..., 0], jnp.uint32),
                t[..., 1],
                lax.bitcast_convert_type(t[..., 2], jnp.uint32),
                lax.bitcast_convert_type(t[..., 3], jnp.float32),
                t[..., 4], t[..., 5])
    aq = banded_aq(trial, qm_bands)
    return (jnp.asarray(_ABS_QF_U32)[aq], jnp.asarray(_BL_QF)[aq],
            jnp.asarray(_QF_NORM)[aq], jnp.asarray(RECIP_QF_F32)[aq],
            jnp.asarray(QUANT_FACTORS_I32)[aq], jnp.asarray(QUANT_OFFSETS)[aq])


def _mean3(r):
    """The reference's DC-prediction mean: (r+1)/3 for r>=0 else (r-1)/3,
    C truncating division (Quantisation.cpp:197-200)."""
    d = (jnp.abs(r) + 1) // 3
    return jnp.where(r >= 0, d, -d)


def _svlc_nbits(qv):
    """Signed interleaved exp-Golomb bit count of one lane column (R,)."""
    u = (jnp.abs(qv) + 1).astype(jnp.uint32)
    s = u
    s = s | (s >> 1)
    s = s | (s >> 2)
    s = s | (s >> 4)
    s = s | (s >> 8)
    s = s | (s >> 16)
    bl = jnp.asarray(jnp.bitwise_count(s), dtype=jnp.int32)
    return jnp.where(qv == 0, 1, 2 * bl)


def _ll_pass(ll_vals, borders, edges, tabs, ll_h: int, ll_w: int):
    """One trial quantisation of every diagonal slice's LL block.

    ll_vals: (R, ll_h*ll_w) raw LL coefficients in raster order (lane_order
    band 0). borders = (top (R, ll_w), left (R, ll_h), corner (R,)) — the
    FINAL reconstructions of the above / left / above-left neighbour
    slices. edges = (top_edge, left_edge) (R,) bool — picture-edge flags
    selecting predictDC's reduced branches (global y==0 / x==0).
    tabs = (absqf i32, recip f32, neg bool, wrapped i32, qo i32) at the
    LL band's adjusted quantiser, each (R,).

    Returns (qvs: list of ll_h*ll_w (R,) quantised lanes, grid: recon
    values as a list-of-lists of (R,) columns).
    """
    top, left, corner = borders
    top_edge, left_edge = edges
    absqf, recip, neg, wrapped, qo = tabs
    grid = [[None] * ll_w for _ in range(ll_h)]
    qvs = []
    for i in range(ll_h):
        for j in range(ll_w):
            if i == 0 and j == 0:
                m = _mean3(corner + top[:, 0] + left[:, 0])
                pred = jnp.where(
                    ~top_edge & ~left_edge, m,
                    jnp.where(~top_edge, top[:, 0],
                              jnp.where(~left_edge, left[:, 0], 0)))
            elif i == 0:
                m = _mean3(top[:, j - 1] + top[:, j] + grid[0][j - 1])
                pred = jnp.where(~top_edge, m, grid[0][j - 1])
            elif j == 0:
                m = _mean3(left[:, i - 1] + grid[i - 1][0] + left[:, i])
                pred = jnp.where(~left_edge, m, grid[i - 1][0])
            else:
                pred = _mean3(grid[i - 1][j - 1] + grid[i - 1][j]
                              + grid[i][j - 1])
            qv = _quant_core(ll_vals[:, i * ll_w + j] - pred,
                             absqf, recip, neg)
            grid[i][j] = _scale_core(qv, wrapped, qo) + pred
            qvs.append(qv)
    return qvs, grid


def _ll_count_1(qvs):
    """Truncated bit count over one component's LL lanes in lane order
    (gross bits at the last non-zero code; Slices.cpp:51-69 head)."""
    gross = None
    count = None
    for qv in qvs:
        nb = _svlc_nbits(qv)
        gross = nb if gross is None else gross + nb
        nz = qv != 0
        count = jnp.where(nz, gross, 0 if count is None else count)
    return gross, count


def _ll_count_2(qvs_u, qvs_v):
    """Interleaved-chroma truncated bit count over the LL lanes
    (u0 v0 u1 v1 ...; Slices.cpp:71-95 head)."""
    gross = None
    count = None
    for qu, qv in zip(qvs_u, qvs_v):
        for x in (qu, qv):
            nb = _svlc_nbits(x)
            gross = nb if gross is None else gross + nb
            count = jnp.where(x != 0, gross, 0 if count is None else count)
    return gross, count


def _body_nb(forms, qf, blq, qfn):
    """Code bit length + non-zero mask of each stateless body lane at the
    expanded per-lane tables — rdo/cbr._component_bits_fast's algebra."""
    m4, blm, m4n = forms
    e1 = blm - blq + (m4n >= qfn).astype(jnp.int32)
    sh = jnp.clip(e1, 0, 31).astype(jnp.uint32)
    pow2 = ((blq + e1) <= 32) & ((m4 + qf) >= (qf << sh))
    nb = jnp.where(e1 <= 0, 1, 2 * (e1 + pow2.astype(jnp.int32)))
    return nb, e1 > 0


def _trunc_count_1(nb, nz):
    """(gross, truncated count, any-nonzero) over one component's body."""
    L = nb.shape[-1]
    idx = jnp.arange(L, dtype=jnp.int32)
    last = jnp.max(jnp.where(nz, idx, -1), axis=-1)
    gross = jnp.sum(nb, axis=-1, dtype=jnp.int32)
    count = jnp.where(last >= 0, gross - (L - 1 - last), 0)
    return count, last >= 0


def _trunc_count_2(nb_u, nz_u, nb_v, nz_v):
    """Interleaved-chroma body count: u lane i at position 2i, v at 2i+1."""
    L = nb_u.shape[-1]
    idx = jnp.arange(L, dtype=jnp.int32)
    last = jnp.maximum(
        jnp.max(jnp.where(nz_u, 2 * idx, -1), axis=-1),
        jnp.max(jnp.where(nz_v, 2 * idx + 1, -1), axis=-1))
    gross = jnp.sum(nb_u + nb_v, axis=-1, dtype=jnp.int32)
    count = jnp.where(last >= 0, gross - (2 * L - 1 - last), 0)
    return count, last >= 0


def _skew(x, R: int, C: int):
    """(R, C, *rest) -> (R+C-1, R, *rest) with out[d, v] = x[v, d-v]:
    pad + flat reinterpretation + transpose, no gathers."""
    rest = x.shape[2:]
    pad = ((0, 0), (0, R + 1)) + ((0, 0),) * len(rest)
    flat = jnp.pad(x, pad).reshape((R * (C + R + 1),) + rest)
    s = flat[:R * (C + R)].reshape((R, C + R) + rest)
    return jnp.swapaxes(s, 0, 1)[:R + C - 1]


def _unskew(y, R: int, C: int):
    """(R+C-1, R, *rest) -> (R, C, *rest) with out[v, h] = y[v+h, v]."""
    rest = y.shape[2:]
    yp = jnp.pad(y, ((0, 1), (0, 0)) + ((0, 0),) * len(rest))
    flat = jnp.swapaxes(yp, 0, 1).reshape((R * (C + R),) + rest)
    flat = jnp.pad(flat, ((0, R),) + ((0, 0),) * len(rest))
    return flat.reshape((R, C + R + 1) + rest)[:, :C]


def _shift_down(x):
    """out[v] = x[v-1] along the lane axis (row 0 is never read: it is
    masked by the top-edge prediction branch)."""
    return jnp.concatenate([x[-1:], x[:-1]], axis=0)


def ld_rate_control(lanes_y, lanes_u, lanes_v, qm_bands, bs_y, bs_c,
                    avail_bits, grid_shape, ll_y_shape, ll_c_shape):
    """Per-slice LD quantiser indices + predictively-quantised LL lanes.

    lanes_*: int32 (N, L) unquantised transform lanes (lane_order: LL lanes
    first, raster within the LL block). qm_bands: (B,) quant matrix.
    bs_y/bs_c: static per-band lane counts. avail_bits: int32 (N,) the
    per-slice bit budgets 8*bytes - 7 - intlog2(8*bytes - 7).
    grid_shape: static (y_slices, x_slices); ll_*_shape: static LL block
    dims (slice_h/2^depth, slice_w/2^depth) per plane.

    Returns (q (N,), ll_qy (N, nLLy), ll_qu (N, nLLc), ll_qv (N, nLLc)) —
    the chosen indices and the final requantise's LL lanes (body lanes are
    stateless: quantise them with quant_banded at q).
    """
    R, C = grid_shape
    lyh, lyw = ll_y_shape
    lch, lcw = ll_c_shape
    nly, nlc = lyh * lyw, lch * lcw
    qm = jnp.asarray(qm_bands)
    bs_yb, bs_cb = tuple(bs_y[1:]), tuple(bs_c[1:])

    def stage(a, tail):
        return _skew(a.reshape((R, C) + tail), R, C)

    f_y = _magnitude_forms(lanes_y[:, nly:].astype(jnp.int32))
    f_u = _magnitude_forms(lanes_u[:, nlc:].astype(jnp.int32))
    f_v = _magnitude_forms(lanes_v[:, nlc:].astype(jnp.int32))
    Lyb, Lcb = lanes_y.shape[1] - nly, lanes_u.shape[1] - nlc
    xs = dict(
        d=jnp.arange(R + C - 1, dtype=jnp.int32),
        ll_y=stage(lanes_y[:, :nly].astype(jnp.int32), (nly,)),
        ll_u=stage(lanes_u[:, :nlc].astype(jnp.int32), (nlc,)),
        ll_v=stage(lanes_v[:, :nlc].astype(jnp.int32), (nlc,)),
        fy=tuple(stage(a, (Lyb,)) for a in f_y),
        fu=tuple(stage(a, (Lcb,)) for a in f_u),
        fv=tuple(stage(a, (Lcb,)) for a in f_v),
        avail=stage(avail_bits.astype(jnp.int32), ()),
    )

    vi = jnp.arange(R, dtype=jnp.int32)

    def probe_tabs(trial):
        absqf, blq, qfn, recip, wrapped, qo = _tables_at(trial, qm)
        ll_tabs = (absqf[:, 0].astype(jnp.int32), recip[:, 0],
                   wrapped[:, 0] < 0, wrapped[:, 0], qo[:, 0])
        body_y = (expand_bands(absqf[:, 1:], bs_yb),
                  expand_bands(blq[:, 1:], bs_yb),
                  expand_bands(qfn[:, 1:], bs_yb))
        body_c = (expand_bands(absqf[:, 1:], bs_cb),
                  expand_bands(blq[:, 1:], bs_cb),
                  expand_bands(qfn[:, 1:], bs_cb))
        return ll_tabs, body_y, body_c

    def step(carry, x):
        (bot_y, rgt_y, c2_y, bot_u, rgt_u, c2_u, bot_v, rgt_v, c2_v) = carry
        h = x["d"] - vi
        edges = (vi == 0, h == 0)
        bord_y = (_shift_down(bot_y), rgt_y, _shift_down(c2_y))
        bord_u = (_shift_down(bot_u), rgt_u, _shift_down(c2_u))
        bord_v = (_shift_down(bot_v), rgt_v, _shift_down(c2_v))

        def trial_ll(q, want_lanes=False):
            ll_tabs, body_y, body_c = probe_tabs(q)
            qy, gy = _ll_pass(x["ll_y"], bord_y, edges, ll_tabs, lyh, lyw)
            qu, gu = _ll_pass(x["ll_u"], bord_u, edges, ll_tabs, lch, lcw)
            qv, gv = _ll_pass(x["ll_v"], bord_v, edges, ll_tabs, lch, lcw)
            if want_lanes:
                return (qy, qu, qv), (gy, gu, gv)
            gross_y, cnt_y = _ll_count_1(qy)
            gross_c, cnt_c = _ll_count_2(qu, qv)
            nb_by, nz_by = _body_nb(x["fy"], *body_y)
            cb_y, any_y = _trunc_count_1(nb_by, nz_by)
            nb_bu, nz_bu = _body_nb(x["fu"], *body_c)
            nb_bv, nz_bv = _body_nb(x["fv"], *body_c)
            cb_c, any_c = _trunc_count_2(nb_bu, nz_bu, nb_bv, nz_bv)
            bits_y = jnp.where(any_y, gross_y + cb_y, cnt_y)
            bits_c = jnp.where(any_c, gross_c + cb_c, cnt_c)
            return bits_y + bits_c

        trial = jnp.full((R,), 63, jnp.int32)
        qbest = jnp.full((R,), 127, jnp.int32)
        for delta in _DELTAS:
            bits = trial_ll(trial)
            fits = bits <= x["avail"]
            qbest = jnp.where(fits & (trial < qbest), trial, qbest)
            trial = jnp.where(fits, trial - delta, trial + delta)

        (qy, qu, qv), (gy, gu, gv) = trial_ll(qbest, want_lanes=True)

        def edges_of(grid, lh, lw):
            bot = jnp.stack([grid[lh - 1][j] for j in range(lw)], axis=1)
            rgt = jnp.stack([grid[i][lw - 1] for i in range(lh)], axis=1)
            return bot, rgt

        nbot_y, nrgt_y = edges_of(gy, lyh, lyw)
        nbot_u, nrgt_u = edges_of(gu, lch, lcw)
        nbot_v, nrgt_v = edges_of(gv, lch, lcw)
        new_carry = (nbot_y, nrgt_y, bot_y[:, -1],
                     nbot_u, nrgt_u, bot_u[:, -1],
                     nbot_v, nrgt_v, bot_v[:, -1])
        ys = (qbest, jnp.stack(qy, 1), jnp.stack(qu, 1), jnp.stack(qv, 1))
        return new_carry, ys

    z = jnp.zeros
    # carry derives from the lane data so its mesh-varying type matches
    # under shard_map (same rationale as device_unpack._decode_scan_raw)
    seed = (lanes_y[0, 0] * 0).astype(jnp.int32)
    init = (z((R, lyw), jnp.int32) + seed, z((R, lyh), jnp.int32) + seed,
            z((R,), jnp.int32) + seed,
            z((R, lcw), jnp.int32) + seed, z((R, lch), jnp.int32) + seed,
            z((R,), jnp.int32) + seed,
            z((R, lcw), jnp.int32) + seed, z((R, lch), jnp.int32) + seed,
            z((R,), jnp.int32) + seed)
    _, (q_d, qy_d, qu_d, qv_d) = lax.scan(step, init, xs)
    q = _unskew(q_d, R, C).reshape(R * C)
    ll_qy = _unskew(qy_d, R, C).reshape(R * C, nly)
    ll_qu = _unskew(qu_d, R, C).reshape(R * C, nlc)
    ll_qv = _unskew(qv_d, R, C).reshape(R * C, nlc)
    return q, ll_qy, ll_qu, ll_qv


@functools.lru_cache(maxsize=None)
def avail_bits_np(budget_key: tuple) -> np.ndarray:
    """Per-slice available bits: 8*bytes - 7 - intlog2(8*bytes - 7)
    (EncodeStream.cpp:210-212)."""
    from vc2tpu.core.intmath import intlog2

    return np.array([8 * b - 7 - intlog2(8 * b - 7) for b in budget_key],
                    dtype=np.int32)
