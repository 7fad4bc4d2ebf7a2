"""On-chip LD rate control (rdo/ld.py) + LD device pack exactness.

The oracle is the native host scan (vc2host.cpp ld_encode), itself pinned
to the reference's quantIndicesLD (EncodeStream.cpp:195-245) by the LD
golden streams and an independent search model (test_ld_fused.py). Every
case checks the chosen q indices, the predictively-quantised LL lanes, the
final body lanes, and the device-packed payload bytes against the host
packer (slices/ld.encode_ld_slices over native ld_pack).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from vc2tpu.core.config import WaveletKernel
from vc2tpu.core.intmath import intlog2
from vc2tpu.pipeline.ld import _qm_block
from vc2tpu.quant.quantiser import quant_banded
from vc2tpu.rdo.ld import avail_bits_np, ld_rate_control
from vc2tpu.slices import layout
from vc2tpu.slices.ld import encode_ld_slices
from vc2tpu.vlc import device_pack
from vc2tpu.wavelet import matrices
from vc2tpu._native.bridge import native

pytestmark = pytest.mark.skipif(native is None,
                                reason="native host codec unavailable")

_JIT_RC = jax.jit(ld_rate_control,
                  static_argnames=("bs_y", "bs_c", "grid_shape",
                                   "ll_y_shape", "ll_c_shape"))


def _to_lanes(plane, perm, s_h, s_w):
    n_y, n_x = plane.shape[0] // s_h, plane.shape[1] // s_w
    blocks = plane.reshape(n_y, s_h, n_x, s_w).transpose(0, 2, 1, 3)
    return blocks.reshape(n_y * n_x, s_h * s_w)[:, perm]


K = WaveletKernel
CASES = [
    # (seed, depth, kernel, H, W, CH, CW, ys, xs, budget_lo, budget_hi, mag)
    (1, 2, K.LeGall, 32, 48, 32, 24, 4, 6, 8, 60, 900),
    (2, 1, K.Haar0, 16, 32, 16, 16, 4, 4, 5, 40, 500),
    (3, 3, K.DD137, 32, 64, 32, 32, 2, 4, 20, 200, 2000),
    (4, 2, K.LeGall, 24, 24, 24, 24, 3, 3, 4, 10, 3000),    # q=127 paths
    (6, 2, K.Fidelity, 32, 32, 16, 16, 2, 2, 10, 90, 1200),  # 4:2:0
    (15, 2, K.LeGall, 32, 48, 32, 24, 4, 6, 200, 400, 30),  # generous: low q
]
# each wavefront case compiles its own scan (tens of seconds on one CPU
# core); the degenerate-geometry and remaining-kernel cases ride the slow
# tier with the other permutation matrices
if os.environ.get("VC2TPU_SLOW") == "1":
    CASES += [
        (5, 2, K.Daub97, 16, 48, 16, 48, 2, 6, 30, 300, 100),  # 4:4:4
        (7, 1, K.Haar1, 8, 8, 8, 4, 1, 1, 6, 50, 700),         # single slice
        (9, 2, K.LeGall, 8, 80, 8, 40, 1, 10, 8, 64, 800),     # single row
        (12, 2, K.LeGall, 80, 8, 80, 4, 10, 1, 8, 64, 800),    # single col
        (8, 2, K.DD97, 40, 40, 40, 20, 5, 5, 7, 70, 22_000),   # large coeffs
    ]


@pytest.mark.parametrize(
    "seed,depth,kernel,H,W,CH,CW,ys,xs,lo,hi,mag", CASES,
    ids=[f"{c[2].name}-d{c[1]}-{c[3]}x{c[4]}-b{c[9]}-m{c[11]}"
         for c in CASES])
def test_ld_rate_control_matches_native(seed, depth, kernel, H, W, CH, CW,
                                        ys, xs, lo, hi, mag):
    rng = np.random.default_rng(seed)
    sh, sw = H // ys, W // xs
    csh, csw = CH // ys, CW // xs
    ts = 1 << depth
    qmatrix = matrices.quant_matrix(kernel, depth)
    n = ys * xs
    ty = rng.integers(-mag, mag, (H, W)).astype(np.int32)
    tu = rng.integers(-mag // 2 - 1, mag // 2 + 1, (CH, CW)).astype(np.int32)
    tv = rng.integers(-mag // 2 - 1, mag // 2 + 1, (CH, CW)).astype(np.int32)
    if seed % 3 == 0:
        ty[:H // 2] = 0        # truncation / all-zero-body paths
        tu[:] = 0
    budgets = rng.integers(lo, hi, n).astype(np.int32)

    qm_block_y = _qm_block(sh, sw, depth, qmatrix)
    qm_block_c = _qm_block(csh, csw, depth, qmatrix)
    perm_y, band_y = layout.lane_order(sh, sw, depth)
    perm_c, band_c = layout.lane_order(csh, csw, depth)
    Ly, Lc = sh * sw, csh * csw
    q_ref = np.zeros(n, np.int32)
    ly_ref = np.empty((n, Ly), np.int32)
    lu_ref = np.empty((n, Lc), np.int32)
    lv_ref = np.empty((n, Lc), np.int32)
    native.ld_encode(ty, tu, tv, (H, W, CH, CW), (ys, xs), ts,
                     qm_block_y, qm_block_c, perm_y, perm_c,
                     budgets, q_ref, ly_ref.ravel(), lu_ref.ravel(),
                     lv_ref.ravel())

    ly = _to_lanes(ty, perm_y, sh, sw)
    lu = _to_lanes(tu, perm_c, csh, csw)
    lv = _to_lanes(tv, perm_c, csh, csw)
    bs_y = tuple(int(c) for c in np.bincount(band_y, minlength=3 * depth + 1))
    bs_c = tuple(int(c) for c in np.bincount(band_c, minlength=3 * depth + 1))
    avail = avail_bits_np(tuple(int(b) for b in budgets))
    nly = (sh // ts) * (sw // ts)
    nlc = (csh // ts) * (csw // ts)
    qm = qmatrix.astype(np.int32)
    q_dev, llqy, llqu, llqv = _JIT_RC(
        jnp.asarray(ly), jnp.asarray(lu), jnp.asarray(lv), qm, bs_y, bs_c,
        jnp.asarray(avail), grid_shape=(ys, xs),
        ll_y_shape=(sh // ts, sw // ts), ll_c_shape=(csh // ts, csw // ts))
    q_dev = np.asarray(q_dev)
    np.testing.assert_array_equal(q_dev, q_ref)
    np.testing.assert_array_equal(np.asarray(llqy), ly_ref[:, :nly])
    np.testing.assert_array_equal(np.asarray(llqu), lu_ref[:, :nlc])
    np.testing.assert_array_equal(np.asarray(llqv), lv_ref[:, :nlc])

    # final lanes: LL from the scan + stateless body quantise at q
    def full(lanes, ll, n_ll, bs):
        body = quant_banded(jnp.asarray(lanes[:, n_ll:]), jnp.asarray(q_dev),
                            qm[1:], bs[1:])
        return np.concatenate([np.asarray(ll), np.asarray(body)], axis=1)

    qy = full(ly, llqy, nly, bs_y)
    qu = full(lu, llqu, nlc, bs_c)
    qv = full(lv, llqv, nlc, bs_c)
    np.testing.assert_array_equal(qy, ly_ref)
    np.testing.assert_array_equal(qu, lu_ref)
    np.testing.assert_array_equal(qv, lv_ref)

    # device pack vs host pack, byte-identical (or both reject the fit)
    len_bits = np.array([intlog2(int(8 * s - 7)) for s in budgets], np.int32)
    w32 = int(budgets.max()) // 4 + 2
    cap = int(budgets.sum())
    buf = np.asarray(device_pack.pack_ld_payload(
        jnp.asarray(qy), jnp.asarray(qu), jnp.asarray(qv),
        jnp.asarray(q_dev), jnp.asarray(budgets), jnp.asarray(len_bits),
        w32=w32, cap_bytes=cap))
    flags, q_h, payload = device_pack.unpack_ld_result(buf, n)
    np.testing.assert_array_equal(q_h, q_ref)
    try:
        host_payload, _ = encode_ld_slices(q_ref, ly_ref, lu_ref, lv_ref,
                                           budgets)
    except ValueError:
        assert flags & device_pack.FLAG_LD_FIT
        return
    assert flags == 0
    assert payload.tobytes() == host_payload


def test_ld_device_route_encoder_matches_host(monkeypatch):
    """LDEncoder's full on-chip route (DWT + wavefront RDO + quantise +
    device pack) produces the same EncodedPicture as the host route."""
    from vc2tpu.core.config import ColourFormat, EncoderConfig, Mode
    from vc2tpu.core.picture import Picture
    from vc2tpu.pipeline.ld import LDEncoder

    rng = np.random.default_rng(3)
    h, w = 32, 48
    cfg = EncoderConfig(height=h, width=w, chroma_format=ColourFormat.CF422,
                        kernel=WaveletKernel.LeGall, wavelet_depth=2,
                        y_size=2, x_size=2, mode=Mode.LD,
                        luma_depth=10, chroma_depth=10,
                        compressed_bytes=2000)
    pic = Picture(rng.integers(-512, 512, (h, w)).astype(np.int32),
                  rng.integers(-512, 512, (h, w // 2)).astype(np.int32),
                  rng.integers(-512, 512, (h, w // 2)).astype(np.int32),
                  ColourFormat.CF422)
    monkeypatch.setenv("VC2TPU_ENCODE_ROUTE", "host")
    host = LDEncoder(cfg).encode_picture(pic, keep_planes=True)
    monkeypatch.setenv("VC2TPU_ENCODE_ROUTE", "device")
    dev = LDEncoder(cfg).encode_picture(pic, keep_planes=True)
    np.testing.assert_array_equal(dev.q_indices, host.q_indices)
    assert dev.payload == host.payload
    np.testing.assert_array_equal(np.asarray(dev.slice_totals),
                                  np.asarray(host.slice_totals))
    for k in ("y", "c1", "c2"):
        np.testing.assert_array_equal(
            np.asarray(getattr(dev.transform, k)),
            np.asarray(getattr(host.transform, k)))
        np.testing.assert_array_equal(
            np.asarray(getattr(dev.quantised, k)),
            np.asarray(getattr(host.quantised, k)))
