"""Mallat (band) form == in-place interleaved form, exactly, for every
kernel/depth; lane extraction equals the permutation-gather path."""

import numpy as np
import jax.numpy as jnp
import pytest

from vc2tpu.core.config import WaveletKernel
from vc2tpu.slices import layout
from vc2tpu.wavelet import lifting


@pytest.mark.parametrize("kernel", list(WaveletKernel))
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_band_form_matches_inplace(kernel, depth):
    rng = np.random.default_rng(0)
    H = W = 64
    ys = xs = 2
    x = jnp.asarray(rng.integers(-500, 500, (H, W)), jnp.int32)
    ref = lifting.forward_plane(x, kernel, depth)
    bands = lifting.forward_bands(x, kernel, depth)
    assert np.array_equal(np.asarray(ref),
                          np.asarray(lifting.bands_to_inplace(bands, depth)))
    assert np.array_equal(np.asarray(lifting.inverse_bands(bands, kernel,
                                                           depth)),
                          np.asarray(x))
    for a, b in zip(bands, lifting.inplace_to_bands(ref, depth)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    lanes_ref = layout.plane_to_lanes(ref, ys, xs, depth)
    lanes_new = lifting.bands_to_lanes(bands, ys, xs)
    assert np.array_equal(np.asarray(lanes_ref), np.asarray(lanes_new))
    dims = lifting.band_dims(H, W, depth)
    for a, b in zip(bands, lifting.lanes_to_bands(lanes_new, ys, xs, dims)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_coefficient_bound_is_safe():
    rng = np.random.default_rng(1)
    for kernel in (WaveletKernel.LeGall, WaveletKernel.Fidelity,
                   WaveletKernel.Daub97):
        for depth in (1, 2, 3):
            bound = lifting.coefficient_bound(kernel, depth, 512)
            x = jnp.asarray(rng.integers(-512, 512, (64, 64)), jnp.int32)
            t = np.asarray(lifting.forward_plane(x, kernel, depth))
            assert int(np.abs(t).max()) <= bound


@pytest.mark.parametrize("kernel", [k for k in WaveletKernel
                                    if k != WaveletKernel.NullKernel])
@pytest.mark.parametrize("shape", [(128, 256), (192, 384)])
def test_one_level_inplace_matches_band_form(kernel, shape):
    """One level of the interleaved in-place transform (the reference's
    layout) equals the band form reassembled, forward and inverse, at
    strip-sized planes."""
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.integers(-600, 600, shape), jnp.int32)
    fwd = lifting.forward_plane(x, kernel, 1)
    bands = lifting.forward_bands(x, kernel, 1)
    assert np.array_equal(np.asarray(fwd),
                          np.asarray(lifting.bands_to_inplace(bands, 1)))
    inv = lifting.inverse_plane(fwd, kernel, 1)
    inv_bands = lifting.inverse_bands(lifting.inplace_to_bands(fwd, 1),
                                      kernel, 1)
    assert np.array_equal(np.asarray(inv), np.asarray(inv_bands))
    assert np.array_equal(np.asarray(inv), np.asarray(x))
