"""Native host synthesis tail == the JAX device tail, exactly.

host_synth (vc2host.cpp idwt_plane / hq_dequant_scatter / clip_format_out)
is the decoder's host route; it must reproduce the device synthesis
bit-for-bit over every kernel and depth. Golden coverage comes from
tests/test_golden.py (route="host"); this file pins the engine directly
against wavelet.lifting + quant.quantiser on random lanes.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from vc2tpu.core.config import ColourFormat, PictureGeometry, WaveletKernel
from vc2tpu.pipeline import host_synth
from vc2tpu.pipeline.encoder import SliceGeometry
from vc2tpu.quant.quantiser import adjust_quant_index, scale
from vc2tpu.slices import layout
from vc2tpu.wavelet import lifting, matrices

pytestmark = pytest.mark.skipif(not host_synth.available(),
                                reason="native host codec unavailable")


def _reference_component(lanes, q_idx, qm, kernel, depth, ys, xs, sh, sw):
    _, band = layout.lane_order(sh, sw, depth)
    aq = adjust_quant_index(np.asarray(q_idx)[:, None], qm[band][None, :])
    t = layout.lanes_to_plane(
        np.asarray(scale(jnp.asarray(lanes, jnp.int32), jnp.asarray(aq))),
        ys, xs, sh, sw, depth)
    return np.asarray(lifting.inverse_plane(jnp.asarray(t), kernel, depth))


@pytest.mark.parametrize("kernel", list(WaveletKernel))
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_component_exact(kernel, depth):
    rng = np.random.default_rng(hash((kernel.name, depth)) % 2**32)
    ys, xs, sh, sw = 2, 3, 16, 16
    n, L = ys * xs, sh * sw
    lanes = rng.integers(-600, 600, (n, L)).astype(np.int16)
    q_idx = rng.integers(0, 70, n).astype(np.int32)
    qm = matrices.quant_matrix(kernel, depth).astype(np.int32)
    want = _reference_component(lanes, q_idx, qm, kernel, depth, ys, xs, sh, sw)
    got = host_synth.synthesise_component(lanes, q_idx, qm, kernel, depth,
                                          ys, xs, sh, sw)
    np.testing.assert_array_equal(got, want)


def test_component_exact_depth4():
    kernel, depth = WaveletKernel.LeGall, 4
    rng = np.random.default_rng(11)
    ys, xs, sh, sw = 2, 2, 16, 32
    n, L = ys * xs, sh * sw
    lanes = rng.integers(-600, 600, (n, L)).astype(np.int16)
    q_idx = rng.integers(0, 70, n).astype(np.int32)
    qm = matrices.quant_matrix(kernel, depth).astype(np.int32)
    want = _reference_component(lanes, q_idx, qm, kernel, depth, ys, xs, sh, sw)
    got = host_synth.synthesise_component(lanes, q_idx, qm, kernel, depth,
                                          ys, xs, sh, sw)
    np.testing.assert_array_equal(got, want)


def test_high_magnitude_lanes_exact():
    """int16-range coefficients at the extremes (wraps in scale) match."""
    kernel, depth = WaveletKernel.Fidelity, 2
    rng = np.random.default_rng(5)
    ys, xs, sh, sw = 2, 2, 8, 8
    n, L = ys * xs, sh * sw
    lanes = rng.choice(np.array([-32768, -32767, -1, 0, 1, 32767],
                                np.int16), (n, L))
    q_idx = np.asarray([0, 60, 100, 119], np.int32)
    qm = matrices.quant_matrix(kernel, depth).astype(np.int32)
    want = _reference_component(lanes, q_idx, qm, kernel, depth, ys, xs, sh, sw)
    got = host_synth.synthesise_component(lanes, q_idx, qm, kernel, depth,
                                          ys, xs, sh, sw)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kernel", list(WaveletKernel))
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_forward_dwt_exact(kernel, depth):
    """Native forward engine == lifting.forward_plane, every kernel/depth."""
    rng = np.random.default_rng(hash((kernel.name, depth, "f")) % 2**32)
    plane = rng.integers(-512, 512, (32, 48)).astype(np.int32)
    want = np.asarray(lifting.forward_plane(jnp.asarray(plane), kernel, depth))
    got = host_synth.dwt_plane_host(plane, kernel, depth)
    np.testing.assert_array_equal(got, want)


def test_forward_inverse_roundtrip_native():
    rng = np.random.default_rng(2)
    plane = rng.integers(-512, 512, (64, 64)).astype(np.int32)
    for kernel in (WaveletKernel.LeGall, WaveletKernel.Fidelity):
        t = host_synth.dwt_plane_host(plane, kernel, 2)
        meta, taps, shift = host_synth._inverted_ladder(kernel)
        p = t.copy()
        from vc2tpu._native.bridge import native

        native.idwt_plane(p, 2, meta, taps, shift)
        np.testing.assert_array_equal(p, plane)


@pytest.mark.parametrize("bitdepth", [8, 10, 12])
def test_formatted_output_matches_device_words(bitdepth):
    """Full synthesise_to_words_host vs the planar formatting rules: clip,
    offset binary, MSB-justified big-endian words (Arrays.cpp:381-426)."""
    kernel, depth = WaveletKernel.LeGall, 2
    rng = np.random.default_rng(bitdepth)
    ys, xs = 4, 6
    geo = SliceGeometry(ys, xs, (16, 48), (16, 24), (4, 8), (4, 4))
    n = geo.n_slices
    Ly, Lc = 32, 16
    combined = rng.integers(-2000, 2000, n * (Ly + 2 * Lc)).astype(np.int16)
    q_idx = rng.integers(0, 50, n).astype(np.int32)
    qm = matrices.quant_matrix(kernel, depth)
    og = PictureGeometry.of(14, 45, ColourFormat.CF422)   # crop inside pad
    out, post = host_synth.synthesise_to_words_host(
        combined, q_idx, qm, kernel, depth, geo, og, bitdepth)
    got = post(np.asarray(out))

    # reference: per-component JAX synthesis + scalar formatting
    zero = 1 << (bitdepth - 1)
    chunks = []
    for lanes, (sh, sw), (oh, ow) in (
            (combined[:n * Ly].reshape(n, Ly), geo.luma_slice,
             (og.luma_height, og.luma_width)),
            (combined[n * Ly:n * (Ly + Lc)].reshape(n, Lc), geo.chroma_slice,
             (og.chroma_height, og.chroma_width)),
            (combined[n * (Ly + Lc):].reshape(n, Lc), geo.chroma_slice,
             (og.chroma_height, og.chroma_width))):
        plane = _reference_component(lanes, q_idx, qm.astype(np.int32),
                                     kernel, depth, ys, xs, sh, sw)
        v = np.clip(plane[:oh, :ow], -zero, zero - 1) + zero
        if bitdepth <= 8:
            chunks.append(v.astype(np.uint8).tobytes())
        else:
            chunks.append((v.astype(np.uint16) << (16 - bitdepth))
                          .astype(">u2").tobytes())
    assert got == b"".join(chunks)
