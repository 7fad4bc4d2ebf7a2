"""Native host synthesis tail — the decoder's host route.

For decode, the host already holds every bit of information (the compressed
stream); fetching 5.5 MB/frame of decoded samples from the device costs a
transfer. When that fetch takes longer than one CPU core needs to
synthesise the frame, the decoder's auto route sends the tail (dequant + inverse DWT + clip + planar format)
to the native engine in vc2host.cpp instead. Bit-exact twin of the device
tail (pipeline/decoder.py) and of the reference decode tail
(/root/reference/src/DecodeStream/DecodeStream.cpp:551-609).

The native inverse DWT is a generic lifting-ladder engine driven by the SAME
step tables as the device transform (wavelet.lifting._STEPS) — one source of
truth for the seven kernels; this module passes the already-inverted ladder
(reversed steps, flipped signs, as lifting._apply_steps does).
"""

from __future__ import annotations

import functools

import numpy as np

from vc2tpu._native.bridge import native
from vc2tpu.core.config import PictureGeometry, WaveletKernel
from vc2tpu.slices import layout
from vc2tpu.wavelet.lifting import _STEPS
from vc2tpu.wavelet.matrices import TRANSFORM_SHIFT


def available() -> bool:
    return native is not None


@functools.lru_cache(maxsize=None)
def _inverted_ladder(kernel: WaveletKernel):
    """(meta int32[n_steps*5], taps int32[sum 2*ntaps], shift) — the inverse
    ladder: reversed step order, flipped signs."""
    meta = []
    taps = []
    for target, sign, tps, add, sh in reversed(_STEPS[kernel]):
        meta.extend([1 if target == "o" else 0, -sign, add, sh, len(tps)])
        for off, coeff in tps:
            taps.extend([off, coeff])
    return (np.asarray(meta, np.int32), np.asarray(taps, np.int32),
            TRANSFORM_SHIFT[kernel])


@functools.lru_cache(maxsize=None)
def _forward_ladder(kernel: WaveletKernel):
    """(meta, taps, shift) — the forward steps verbatim from _STEPS."""
    meta = []
    taps = []
    for target, sign, tps, add, sh in _STEPS[kernel]:
        meta.extend([1 if target == "o" else 0, sign, add, sh, len(tps)])
        for off, coeff in tps:
            taps.extend([off, coeff])
    return (np.asarray(meta, np.int32), np.asarray(taps, np.int32),
            TRANSFORM_SHIFT[kernel])


def dwt_plane_host(plane: np.ndarray, kernel: WaveletKernel,
                   depth: int) -> np.ndarray:
    """Forward DWT of an already-padded plane on the native engine, in-place
    transform layout — host twin of wavelet.lifting.forward_plane."""
    meta, taps, shift = _forward_ladder(kernel)
    p = np.array(plane, np.int32, copy=True, order="C")
    native.dwt_plane(p, depth, meta, taps, shift)
    return p


@functools.lru_cache(maxsize=None)
def _scatter_tables(slice_h: int, slice_w: int, depth: int, plane_w: int,
                    qm_key: tuple):
    """Per-lane plane offsets (relative to the slice origin) + per-lane
    quant-matrix values."""
    perm, band = layout.lane_order(slice_h, slice_w, depth)
    off_plane = ((perm // slice_w) * plane_w + perm % slice_w).astype(np.int32)
    qm_lane = np.asarray(qm_key, np.int32)[band]
    return off_plane, np.ascontiguousarray(qm_lane)


def synthesise_component(lanes_i16: np.ndarray, q_idx: np.ndarray,
                         qm: np.ndarray, kernel: WaveletKernel, depth: int,
                         ys: int, xs: int, sh: int, sw: int) -> np.ndarray:
    """lanes (S, L) int16 -> dequantised + inverse-transformed plane."""
    ph, pw = ys * sh, xs * sw
    plane = np.empty((ph, pw), np.int32)
    off_plane, qm_lane = _scatter_tables(sh, sw, depth, pw,
                                         tuple(int(v) for v in qm))
    native.hq_dequant_scatter(lanes_i16, q_idx, qm_lane, off_plane,
                              xs, sh, sw, plane)
    meta, taps, shift = _inverted_ladder(kernel)
    native.idwt_plane(plane, depth, meta, taps, shift)
    return plane


def synthesise_to_words_host(combined: np.ndarray, q_idx: np.ndarray,
                             qmatrix: np.ndarray, kernel: WaveletKernel,
                             depth: int, geo, out_geometry: PictureGeometry,
                             bitdepth: int):
    """Host twin of pipeline.decoder.synthesise_to_words: returns
    (formatted sample array, post) with the same interface — the array is
    the final wire samples (uint8 / big-endian uint16), post -> bytes."""
    n = geo.n_slices
    Ly = geo.luma_slice[0] * geo.luma_slice[1]
    Lc = geo.chroma_slice[0] * geo.chroma_slice[1]
    qm = np.ascontiguousarray(qmatrix, np.int32)
    q_idx = np.ascontiguousarray(q_idx, np.int32)
    lanes_y = combined[:n * Ly].reshape(n, Ly)
    lanes_u = combined[n * Ly:n * (Ly + Lc)].reshape(n, Lc)
    lanes_v = combined[n * (Ly + Lc):].reshape(n, Lc)

    word = 1 if bitdepth <= 8 else 2
    og = out_geometry
    sizes = (og.luma_height * og.luma_width,
             og.chroma_height * og.chroma_width,
             og.chroma_height * og.chroma_width)
    out = np.empty(sum(sizes) * word, np.uint8)
    pos = 0
    for lanes, (sh, sw), (oh, ow) in (
            (lanes_y, geo.luma_slice, (og.luma_height, og.luma_width)),
            (lanes_u, geo.chroma_slice, (og.chroma_height, og.chroma_width)),
            (lanes_v, geo.chroma_slice, (og.chroma_height, og.chroma_width))):
        plane = synthesise_component(lanes, q_idx, qm, kernel, depth,
                                     geo.y_slices, geo.x_slices, sh, sw)
        native.clip_format_out(plane, oh, ow, bitdepth,
                               out[pos:pos + oh * ow * word])
        pos += oh * ow * word
    if word == 2:
        out = out.view(np.uint16)
    return out, (lambda a: a.tobytes())


def synthesise_payload_to_words_host(payload: np.ndarray, q_idx: np.ndarray,
                                     dstart: np.ndarray, cbytes: np.ndarray,
                                     qmatrix: np.ndarray,
                                     kernel: WaveletKernel, depth: int, geo,
                                     out_geometry: PictureGeometry,
                                     bitdepth: int):
    """Fully-fused host decode tail: bounded exp-Golomb decode + dequant
    straight into the transform plane (no intermediate lane buffer), then
    IDWT + clip + format. ``dstart``/``cbytes`` are the per-component slice
    regions from scan_hq_slice_offsets (byte offsets/sizes, shape (3, N))."""
    qm_key = tuple(int(v) for v in qmatrix)
    q_idx = np.ascontiguousarray(q_idx, np.int32)
    word = 1 if bitdepth <= 8 else 2
    og = out_geometry
    sizes = (og.luma_height * og.luma_width,
             og.chroma_height * og.chroma_width,
             og.chroma_height * og.chroma_width)
    out = np.empty(sum(sizes) * word, np.uint8)
    pos = 0
    meta, taps, shift = _inverted_ladder(kernel)
    for c, ((sh, sw), (oh, ow)) in enumerate((
            (geo.luma_slice, (og.luma_height, og.luma_width)),
            (geo.chroma_slice, (og.chroma_height, og.chroma_width)),
            (geo.chroma_slice, (og.chroma_height, og.chroma_width)))):
        ph, pw = geo.y_slices * sh, geo.x_slices * sw
        plane = np.empty((ph, pw), np.int32)
        off_plane, qm_lane = _scatter_tables(sh, sw, depth, pw, qm_key)
        native.unpack_dequant_plane(payload, dstart[c] * 8, cbytes[c] * 8,
                                    sh * sw, q_idx, qm_lane, off_plane,
                                    geo.x_slices, sh, sw, plane)
        native.idwt_plane(plane, depth, meta, taps, shift)
        native.clip_format_out(plane, oh, ow, bitdepth,
                               out[pos:pos + oh * ow * word])
        pos += oh * ow * word
    if word == 2:
        out = out.view(np.uint16)
    return out, (lambda a: a.tobytes())


def synthesise_transform_to_words_host(transform, kernel: WaveletKernel,
                                       depth: int,
                                       out_geometry: PictureGeometry,
                                       bitdepth: int):
    """Host twin of synthesise_transform_to_words (the LD decode tail):
    already-dequantised in-place transform planes -> IDWT + format.
    CONSUMES contiguous int32 planes (the in-place IDWT mutates them);
    other layouts are copied first. Both decoder sources (the fused
    native LD decode and ld_dequantise_picture) own their planes."""
    meta, taps, shift = _inverted_ladder(kernel)
    word = 1 if bitdepth <= 8 else 2
    og = out_geometry
    sizes = (og.luma_height * og.luma_width,
             og.chroma_height * og.chroma_width,
             og.chroma_height * og.chroma_width)
    out = np.empty(sum(sizes) * word, np.uint8)
    pos = 0
    for p, (oh, ow) in ((transform.y, (og.luma_height, og.luma_width)),
                        (transform.c1, (og.chroma_height, og.chroma_width)),
                        (transform.c2, (og.chroma_height, og.chroma_width))):
        plane = np.asarray(p)
        if plane.dtype != np.int32 or not plane.flags.c_contiguous:
            plane = np.ascontiguousarray(plane, np.int32)
        native.idwt_plane(plane, depth, meta, taps, shift)
        native.clip_format_out(plane, oh, ow, bitdepth,
                               out[pos:pos + oh * ow * word])
        pos += oh * ow * word
    if word == 2:
        out = out.view(np.uint16)
    return out, (lambda a: a.tobytes())
