"""Halo-exchange lifting DWT for row-band-sharded pictures.

The reference's in-place lifting reads neighbour rows through shared memory
(/root/reference/src/Library/src/WaveletTransform.cpp:514-531). When a
picture's rows are sharded over the ``space`` mesh axis, every *vertical*
lifting pass instead exchanges up to ``HALO`` boundary rows of the opposite
parity with each neighbour via ``jax.lax.ppermute`` — one tiny ring hop per
pass over the device interconnect. Horizontal passes are shard-local.

Exactness: a lifting pass reads only the *other* parity's current values at
sub-lattice offsets within ±4 (Fidelity is the widest, ±4; DD137 ±3), so a
4-row halo per side reproduces the unsharded arithmetic exactly — ints, so
tests compare with ``==``. At the true picture edges the reference clamps
tap indices (values replicate); edge shards therefore fill their missing
halo with replicated boundary rows, which evaluates identically to the
clamped-index arithmetic because all out-of-range taps clamp to the
outermost row.

Shard alignment: each shard's row count must be a multiple of 2**depth
(slice-aligned row bands), so every level's sub-lattice splits evenly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from vc2tpu.core.config import WaveletKernel
from vc2tpu.wavelet import lifting
from vc2tpu.wavelet.lifting import _STEPS, _apply_steps, _interleave, _split
from vc2tpu.wavelet.matrices import TRANSFORM_SHIFT

def halo_width(kernel: WaveletKernel) -> int:
    """Max |tap offset| of the kernel's lifting steps, in sub-lattice rows:
    LeGall/Daub97 1, DD97/DD137 2, Fidelity 4, Haar 0."""
    return max((abs(off) for (_, _, taps, _, _) in _STEPS[kernel]
                for (off, _) in taps), default=0)


def _exchange(src, axis_name: str, halo: int):
    """Return (top_halo, bottom_halo): ``halo`` rows from each neighbour
    along the ring, with edge shards receiving replicated boundary rows (the
    clamped-tap equivalent). src rows axis is -2."""
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    if n == 1:
        top = jnp.repeat(src[..., :1, :], halo, axis=-2)
        bot = jnp.repeat(src[..., -1:, :], halo, axis=-2)
        return top, bot
    last = src[..., -halo:, :]
    first = src[..., :halo, :]
    # shift down: shard i receives shard i-1's last rows
    top = jax.lax.ppermute(last, axis_name, [(i, i + 1) for i in range(n - 1)])
    # shift up: shard i receives shard i+1's first rows
    bot = jax.lax.ppermute(first, axis_name, [(i + 1, i) for i in range(n - 1)])
    edge_top = jnp.repeat(src[..., :1, :], halo, axis=-2)
    edge_bot = jnp.repeat(src[..., -1:, :], halo, axis=-2)
    top = jnp.where(idx == 0, edge_top, top)
    bot = jnp.where(idx == n - 1, edge_bot, bot)
    return top, bot


def _apply_vertical_steps_halo(e, o, steps, axis_name: str, invert: bool,
                               halo: int):
    """Vertical lifting with per-pass halo exchange; rows axis is -2."""
    if invert:
        steps = [(t, -s, taps, add, sh) for (t, s, taps, add, sh) in reversed(steps)]
    for target, sign, taps, add, sh in steps:
        src = e if target == "o" else o
        if src.shape[-2] < halo:
            raise ValueError("row shard too small for this kernel's halo")
        if halo:
            top, bot = _exchange(src, axis_name, halo)
            ext = jnp.concatenate([top, src, bot], axis=-2)
        else:
            ext = src
        acc = None
        for off, coeff in taps:
            # offset within ext: local row i maps to ext row i + halo
            sl = [slice(None)] * ext.ndim
            start = halo + off
            sl[-2] = slice(start, start + src.shape[-2])
            term = coeff * ext[tuple(sl)]
            acc = term if acc is None else acc + term
        delta = (acc + add) >> sh if sh else acc
        if target == "o":
            o = o + sign * delta
        else:
            e = e + sign * delta
    return e, o


def _level_sharded(v, kernel: WaveletKernel, axis_name: str, invert: bool):
    """One lifting level on a row-sharded sub-lattice block ``v`` (local
    rows, full width). Horizontal passes are local; vertical passes use the
    halo exchange."""
    steps = _STEPS[kernel]
    shift = TRANSFORM_SHIFT[kernel]
    h_axis = v.ndim - 1
    v_axis = v.ndim - 2
    if not invert:
        if shift:
            v = v << shift
        e, o = _split(v, h_axis)
        e, o = _apply_steps(e, o, steps, h_axis, invert=False)
        v = _interleave(e, o, h_axis)
        e, o = _split(v, v_axis)
        e, o = _apply_vertical_steps_halo(e, o, steps, axis_name, invert=False,
                                          halo=halo_width(kernel))
        v = _interleave(e, o, v_axis)
        return v
    e, o = _split(v, v_axis)
    e, o = _apply_vertical_steps_halo(e, o, steps, axis_name, invert=True,
                                      halo=halo_width(kernel))
    v = _interleave(e, o, v_axis)
    e, o = _split(v, h_axis)
    e, o = _apply_steps(e, o, steps, h_axis, invert=True)
    v = _interleave(e, o, h_axis)
    if shift:
        v = (v + (1 << (shift - 1))) >> shift
    return v


def _forward_local(x, kernel: WaveletKernel, depth: int, axis_name: str):
    # _get_sub/_set_sub, not x.at[::s, ::s].set: on the TPU this codec was
    # first built for, the strided sub-lattice scatter cost far more than
    # the lifting arithmetic, while the recursive stride-2 split +
    # stack-interleave form fuses
    for level in range(depth):
        s = 1 << level
        if s == 1:
            x = _level_sharded(x, kernel, axis_name, invert=False)
        else:
            v = _level_sharded(lifting._get_sub(x, s), kernel, axis_name,
                               invert=False)
            x = lifting._set_sub(x, v, s)
    return x


def _inverse_local(x, kernel: WaveletKernel, depth: int, axis_name: str):
    for level in range(depth - 1, -1, -1):
        s = 1 << level
        if s == 1:
            x = _level_sharded(x, kernel, axis_name, invert=True)
        else:
            v = _level_sharded(lifting._get_sub(x, s), kernel, axis_name,
                               invert=True)
            x = lifting._set_sub(x, v, s)
    return x


# --- Mallat (band) form, used by the sharded pipeline ------------------------
# Same halo arithmetic, but subbands stay contiguous per shard: no strided
# sub-lattice access, and slice-lane extraction downstream is pure
# reshape/transpose (see vc2tpu/wavelet/lifting.py).

def forward_bands_local(x, kernel: WaveletKernel, depth: int, axis_name: str):
    """Per-shard forward DWT of a row-band of the (padded) plane, returning
    the local row-band of every subband. Call inside shard_map."""
    steps = _STEPS[kernel]
    shift = TRANSFORM_SHIFT[kernel]
    halo = halo_width(kernel)
    h_axis = x.ndim - 1
    v_axis = x.ndim - 2
    x = jnp.asarray(x, jnp.int32)
    fine_to_coarse = []
    for _ in range(depth):
        if shift:
            x = x << shift
        he, ho = _split(x, h_axis)
        he, ho = _apply_steps(he, ho, steps, h_axis, invert=False)
        ll, lh = _apply_vertical_steps_halo(*_split(he, v_axis), steps,
                                            axis_name, False, halo)
        hl, hh = _apply_vertical_steps_halo(*_split(ho, v_axis), steps,
                                            axis_name, False, halo)
        fine_to_coarse.append((hl, lh, hh))
        x = ll
    bands = [x]
    for lvl in reversed(fine_to_coarse):
        bands.extend(lvl)
    return bands


def inverse_bands_local(bands, kernel: WaveletKernel, depth: int,
                        axis_name: str):
    """Per-shard inverse DWT from local subband row-bands."""
    steps = _STEPS[kernel]
    shift = TRANSFORM_SHIFT[kernel]
    halo = halo_width(kernel)
    x = bands[0]
    h_axis = x.ndim - 1
    v_axis = x.ndim - 2
    for level in range(depth):
        hl, lh, hh = bands[1 + 3 * level:4 + 3 * level]
        ve, vo = _apply_vertical_steps_halo(x, lh, steps, axis_name, True,
                                            halo)
        he = _interleave(ve, vo, v_axis)
        ve, vo = _apply_vertical_steps_halo(hl, hh, steps, axis_name, True,
                                            halo)
        ho = _interleave(ve, vo, v_axis)
        he, ho = _apply_steps(he, ho, steps, h_axis, invert=True)
        x = _interleave(he, ho, h_axis)
        if shift:
            x = (x + (1 << (shift - 1))) >> shift
    return x


def sharded_forward_plane(plane, mesh: Mesh, kernel: WaveletKernel, depth: int,
                          axis_name: str = "space"):
    """Forward DWT of an (already padded) plane sharded in row bands over
    ``axis_name``. Result layout and values identical to the unsharded
    lifting.forward_plane."""
    rows = plane.shape[-2]
    n = mesh.shape[axis_name]
    if (rows // n) % (1 << depth) or rows % n:
        raise ValueError("row shards must be multiples of 2**depth")
    spec = P(*([None] * (plane.ndim - 2)), axis_name, None)
    fn = jax.shard_map(
        functools.partial(_forward_local, kernel=kernel, depth=depth,
                          axis_name=axis_name),
        mesh=mesh, in_specs=spec, out_specs=spec)
    return fn(jnp.asarray(plane, jnp.int32))


def sharded_inverse_plane(transform, mesh: Mesh, kernel: WaveletKernel,
                          depth: int, axis_name: str = "space"):
    rows = transform.shape[-2]
    n = mesh.shape[axis_name]
    if (rows // n) % (1 << depth) or rows % n:
        raise ValueError("row shards must be multiples of 2**depth")
    spec = P(*([None] * (transform.ndim - 2)), axis_name, None)
    fn = jax.shard_map(
        functools.partial(_inverse_local, kernel=kernel, depth=depth,
                          axis_name=axis_name),
        mesh=mesh, in_specs=spec, out_specs=spec)
    return fn(jnp.asarray(transform, jnp.int32))
