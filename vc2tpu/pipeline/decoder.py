"""Decoder pipeline: host entropy unpack + device synthesis (dequant + IDWT).

Counterpart of the DecodeStream HQ/LD picture paths
(/root/reference/src/DecodeStream/DecodeStream.cpp:289-613).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from vc2tpu._native.bridge import native
from vc2tpu.core.config import ColourFormat, PictureGeometry, WaveletKernel
from vc2tpu.core.picture import Picture
from vc2tpu.quant.quantiser import adjust_quant_index, scale, scale_banded
from vc2tpu.slices import layout
from vc2tpu.vlc import device_unpack
from vc2tpu.wavelet import lifting, matrices


def _make_fmt(bitdepth: int, pack10: bool):
    """Output-sample formatter shared by every device decode tail: clip to
    signal range, offset binary, then the wire form (uint8 / MSB-justified
    big-endian uint16 / pack10 staging as a still-2D uint32 plane — the
    pack10 path must NOT ravel; see _pack_planes10)."""
    zero = 1 << (bitdepth - 1)

    def fmt(p):
        v = jnp.clip(p, -zero, zero - 1) + zero
        if pack10:
            return v.astype(jnp.uint32)
        if bitdepth == 8:
            return v.astype(jnp.uint8).ravel()
        v = (v << (16 - bitdepth)).astype(jnp.uint16)
        return ((v << 8) | (v >> 8)).ravel()      # to big-endian

    return fmt


def _pack10_words(out):
    """Pack 3x10-bit samples per uint32 word (flat-buffer form).

    Word i packs samples (i, i+m3, i+2*m3) — contiguous THIRDS of the flat
    sample buffer, not (3i, 3i+1, 3i+2): the interleaved form needs a
    lane-strided (-1, 3) reshape, which XLA lowered to slow relayout loops
    on the TPU this codec was first built for, while thirds are three
    whole-array slices + shifts. The host side (_unpack10 /
    vc2host.cpp unpack10_to_be16) mirrors the layout. The decode tails use
    the 2D _pack_planes10 below instead — flattening the IDWT planes
    inside the program costs another ~3 ms of relayout loops."""
    pad = (-out.shape[0]) % 3
    if pad:
        out = jnp.concatenate([out, jnp.zeros((pad,), jnp.uint32)])
    m3 = out.shape[0] // 3
    return (out[:m3] << 20) | (out[m3:2 * m3] << 10) | out[2 * m3:]


def _pack_planes10(planes):
    """2D thirds pack of whole planes: plane rows (r, r+h3, r+2h3) pack
    into word row r — row slices and shifts only, every array stays 2D in
    its natural device layout. On the TPU this codec was first built for,
    an in-program ``.ravel()`` of the three IDWT output planes became
    relayout loops while the transfer's own linearisation of a 2D result
    was free, so the flatten stays out of the program. Returns ONE 2D uint32 array: luma word rows stacked over the
    chroma pair (side by side when 2*cw == lw — 4:2:2/4:2:0 — stacked
    otherwise). Host twin: _unpack10_2d. Row-major raveled, each plane's
    word block is exactly the flat thirds layout of its (row-padded)
    plane, so the flat expanders apply per plane unchanged."""
    words = []
    for p in planes:
        hh = p.shape[0]
        h3 = -(-hh // 3)
        if 3 * h3 != hh:
            p = jnp.pad(p, ((0, 3 * h3 - hh), (0, 0)))
        words.append((p[:h3] << 20) | (p[h3:2 * h3] << 10) | p[2 * h3:])
    wy, wu, wv = words
    if 2 * wu.shape[1] == wy.shape[1]:
        uv = jnp.concatenate([wu, wv], axis=1)
        return jnp.concatenate([wy, uv], axis=0)
    return jnp.concatenate([wy, wu, wv], axis=0)


def _finish(out, out_geometry: PictureGeometry, pack10: bool):
    """(device words, post): start the async D2H copy and pick the host
    expansion matching the device wire form."""
    try:
        out.copy_to_host_async()
    except Exception:
        pass
    if pack10:
        dims = (out_geometry.luma_height, out_geometry.luma_width,
                out_geometry.chroma_height, out_geometry.chroma_width)
        return out, functools.partial(_unpack10_2d, dims=dims)
    return out, (lambda a: a.tobytes())


def _lanes_words_tail(kernel: WaveletKernel, depth: int, geo_key, out_key,
                      bitdepth: int, pack10: bool):
    """Shared fused decode tail builder: (qy, qu, qv lanes, q_idx, qm_bands)
    -> ONE flat formatted output word buffer. Covers DecodeStream's
    dequant -> IDWT -> clip -> planar-write tail
    (/root/reference/src/DecodeStream/DecodeStream.cpp:551-609 and
    src/Library/src/Arrays.cpp:381-426)."""
    (ys, xs, lsh, lsw, csh, csw) = geo_key
    (out_lh, out_lw, out_ch, out_cw) = out_key
    fmt = _make_fmt(bitdepth, pack10)

    bands_y = tuple(int(c) for c in
                    np.bincount(layout.lane_order(lsh, lsw, depth)[1]))
    bands_c = tuple(int(c) for c in
                    np.bincount(layout.lane_order(csh, csw, depth)[1]))
    dims_y = lifting.band_dims(ys * lsh, xs * lsw, depth)
    dims_c = lifting.band_dims(ys * csh, xs * csw, depth)

    def tail(qy, qu, qv, q_idx, qm_bands):
        by = lifting.lanes_to_bands(scale_banded(qy, q_idx, qm_bands, bands_y),
                                    ys, xs, dims_y)
        bu = lifting.lanes_to_bands(scale_banded(qu, q_idx, qm_bands, bands_c),
                                    ys, xs, dims_c)
        bv = lifting.lanes_to_bands(scale_banded(qv, q_idx, qm_bands, bands_c),
                                    ys, xs, dims_c)
        y = lifting.inverse_bands(by, kernel, depth)[:out_lh, :out_lw]
        c1 = lifting.inverse_bands(bu, kernel, depth)[:out_ch, :out_cw]
        c2 = lifting.inverse_bands(bv, kernel, depth)[:out_ch, :out_cw]
        if pack10:
            return _pack_planes10([fmt(y), fmt(c1), fmt(c2)])
        return jnp.concatenate([fmt(y), fmt(c1), fmt(c2)])

    return tail


@functools.lru_cache(maxsize=32)
def _synthesis_bytes_fn(kernel: WaveletKernel, depth: int, geo_key, out_key,
                        bitdepth: int, pack10: bool = False):
    """Fused decode tail from host-unpacked coefficients: one combined (or
    fixed-width repacked) buffer in, one formatted word buffer out. With
    ``pack10`` (10-bit video) three samples pack per uint32 word, cutting
    the device->host transfer by ~38%; the host expands with _unpack10.
    """
    (ys, xs, lsh, lsw, csh, csw) = geo_key

    n = ys * xs
    Ly = lsh * lsw
    Lc = csh * csw

    def unpack_fixed(packed, widths):
        """Device-side unpack of the host fixedpack repack (vc2host.cpp
        fixedpack): per-stream two's-complement values at width w[s],
        MSB-first bit-contiguous. Two word gathers + arithmetic shift."""
        w = widths.astype(jnp.int32)
        lens = jnp.concatenate([w[:n] * Ly, w[n:2 * n] * Lc, w[2 * n:] * Lc])
        starts = jnp.cumsum(lens) - lens

        def comp(ws, st, L):
            off = st[:, None] + jnp.arange(L, dtype=jnp.int32)[None, :] * ws[:, None]
            word = off >> 5
            hi = packed[word]
            sh = (off & 31).astype(jnp.uint32)
            lo = packed[word + 1]
            window = (hi << sh) | jnp.where(sh > 0, lo >> (32 - sh), 0)
            shift = jnp.clip(32 - ws[:, None], 0, 31)
            val = window.astype(jnp.int32) >> shift     # arithmetic: sign-extend
            return jnp.where(ws[:, None] > 0, val, 0)

        return (comp(w[:n], starts[:n], Ly),
                comp(w[n:2 * n], starts[n:2 * n], Lc),
                comp(w[2 * n:], starts[2 * n:], Lc))

    tail = _lanes_words_tail(kernel, depth, geo_key, out_key, bitdepth, pack10)

    def fn(combined, q_idx, qm_bands, widths=None):
        if widths is not None:
            qy, qu, qv = unpack_fixed(combined, widths)
        else:
            qy = combined[:n * Ly].reshape(n, Ly).astype(jnp.int32)
            qu = combined[n * Ly:n * (Ly + Lc)].reshape(n, Lc).astype(jnp.int32)
            qv = combined[n * (Ly + Lc):].reshape(n, Lc).astype(jnp.int32)
        return tail(qy, qu, qv, q_idx, qm_bands)

    return jax.jit(fn)


@functools.lru_cache(maxsize=32)
def _payload_synthesis_fn(kernel: WaveletKernel, depth: int, geo_key, out_key,
                          bitdepth: int, pack10: bool, prefix: int,
                          word_counts: tuple[int, int, int]):
    """Full on-chip HQ decode: slice payload bytes in, formatted output
    words out. The entropy unpack (vlc/device_unpack.py) runs on device, so
    the host ships the *compressed* payload plus the chain scan's component
    lengths — no host VLC work, no coefficient-sized transfers. Covers the
    whole HQ picture tail of
    /root/reference/src/DecodeStream/DecodeStream.cpp:451-609 on chip."""
    (ys, xs, lsh, lsw, csh, csw) = geo_key
    Ly = lsh * lsw
    Lc = csh * csw
    tail = _lanes_words_tail(kernel, depth, geo_key, out_key, bitdepth, pack10)

    def fn(payload_u8, clens, start, q_idx, qm_bands):
        qy, qu, qv = device_unpack.unpack_hq_lanes(
            payload_u8, clens, start, prefix, (Ly, Lc, Lc), word_counts)
        return tail(qy, qu, qv, q_idx, qm_bands)

    return jax.jit(fn)


def synthesise_payload_to_words(payload: np.ndarray, q_indices, cbytes,
                                qmatrix, kernel: WaveletKernel, depth: int,
                                geo, out_geometry: PictureGeometry,
                                bitdepth: int, prefix: int, start: int = 0,
                                allow_pack: bool = True):
    """Async full-device decode route: one compressed-payload host->device
    copy, entropy unpack + synthesis + output formatting all on chip.
    Returns (device_words, postprocess) without blocking."""
    qm_bands = jnp.asarray(qmatrix.astype(np.int32))
    geo_key = (geo.y_slices, geo.x_slices, *geo.luma_slice, *geo.chroma_slice)
    out_key = (out_geometry.luma_height, out_geometry.luma_width,
               out_geometry.chroma_height, out_geometry.chroma_width)
    pack10 = bool(allow_pack and bitdepth == 10)
    Ly = geo.luma_slice[0] * geo.luma_slice[1]
    Lc = geo.chroma_slice[0] * geo.chroma_slice[1]
    cbytes = np.asarray(cbytes)
    word_counts = tuple(
        device_unpack.window_words(_bucket_bytes(int(cbytes[c].max(initial=0))),
                                   (Ly, Lc, Lc)[c])
        for c in range(3))
    fn = _payload_synthesis_fn(kernel, depth, geo_key, out_key, bitdepth,
                               pack10, prefix, word_counts)
    p4 = _bucket((len(payload) + 3) // 4 * 4 + 8)
    padded = np.zeros(p4, np.uint8)
    padded[:len(payload)] = payload
    out = fn(jnp.asarray(padded), jnp.asarray(cbytes, jnp.int32),
             jnp.int32(start), jnp.asarray(q_indices, jnp.int32), qm_bands)
    return _finish(out, out_geometry, pack10)


@functools.lru_cache(maxsize=16)
def _ld_payload_synthesis_fn(kernel: WaveletKernel, depth: int, geo_key,
                             out_key, bitdepth: int, pack10: bool,
                             word_counts: tuple[int, int]):
    """Full on-chip LD decode tail: slice payload bytes + the host's
    dequantised LL grids -> formatted output words. The entropy unpack of
    the luma and interleaved-chroma regions runs on device
    (vlc/device_unpack.unpack_ld_lanes); only the LL DC-prediction
    recurrence — strictly sequential, reference Quantisation.cpp:287-306 —
    stays host, shipping grids 1/4^depth the picture size. Covers the LD
    picture tail of /root/reference/src/DecodeStream/DecodeStream.cpp:
    289-450 on chip."""
    (ys, xs, lsh, lsw, csh, csw) = geo_key
    (out_lh, out_lw, out_ch, out_cw) = out_key
    Ly, Lc = lsh * lsw, csh * csw
    fmt = _make_fmt(bitdepth, pack10)
    bands_y = tuple(int(c) for c in
                    np.bincount(layout.lane_order(lsh, lsw, depth)[1]))
    bands_c = tuple(int(c) for c in
                    np.bincount(layout.lane_order(csh, csw, depth)[1]))
    dims_y = lifting.band_dims(ys * lsh, xs * lsw, depth)
    dims_c = lifting.band_dims(ys * csh, xs * csw, depth)

    def fn(payload_u8, s_bits, len_bits, y_bits, uv_bits, q_idx, qm_bands,
           ll_y, ll_u, ll_v):
        qy, quv = device_unpack.unpack_ld_lanes(
            payload_u8, s_bits, len_bits, y_bits, uv_bits, (Ly, Lc),
            word_counts)
        qu, qv = quv[:, 0::2], quv[:, 1::2]

        def synth(lanes, bands_n, dims, ll, oh, ow):
            scaled = scale_banded(lanes, q_idx, qm_bands, bands_n)
            bands = list(lifting.lanes_to_bands(scaled, ys, xs, dims))
            # the device-decoded LL lanes carry no DC prediction — the
            # host recurrence's dequantised grid replaces that band
            bands[0] = ll
            return lifting.inverse_bands(bands, kernel, depth)[:oh, :ow]

        fy = fmt(synth(qy, bands_y, dims_y, ll_y, out_lh, out_lw))
        fu = fmt(synth(qu, bands_c, dims_c, ll_u, out_ch, out_cw))
        fv = fmt(synth(qv, bands_c, dims_c, ll_v, out_ch, out_cw))
        if pack10:
            return _pack_planes10([fy, fu, fv])
        return jnp.concatenate([fy, fu, fv])

    return jax.jit(fn)


def ld_ll_grids(payload: np.ndarray, q, s_bits, len_bits, y_bits, uv_bits,
                geo, depth: int, qm_block_y, qm_block_c):
    """Host side of the device LD decode routes (single-chip and mesh):
    unpack each slice region's leading LL codes and run the strictly
    sequential DC-prediction dequant (reference Quantisation.cpp:287-306)
    over the per-plane LL grids — grids are 1/4^depth the picture size.
    Returns (gy, gu, gv) dequantised LL planes (np.int32)."""
    from vc2tpu._native.bridge import native
    from vc2tpu.vlc.bitpack import unpack_signed_streams

    ts = 1 << depth
    (lsh, lsw), (csh, csw) = geo.luma_slice, geo.chroma_slice
    n = geo.n_slices

    def ll_grid(lanes, sh, sw, llw, qm_block):
        nll = (sh // ts) * (sw // ts)
        # the first nll lanes of the serialisation order are the LL band;
        # map them through the real lane order (no raster assumption)
        perm, _ = layout.lane_order(sh, sw, depth)
        by, bx = perm[:nll] // sw, perm[:nll] % sw
        olly = (by // ts) * llw + (bx // ts)
        sy, sx = np.divmod(np.arange(n), geo.x_slices)
        origins = sy * (sh // ts) * llw + sx * (sw // ts)
        llq = np.zeros(((geo.y_slices * sh) // ts, llw), np.int32)
        llq.ravel()[origins[:, None] + olly[None, :]] = lanes
        return native.ld_ll_dequantise_grid(llq, geo.y_slices, geo.x_slices,
                                            ts, sh, sw, qm_block, q)

    lly = unpack_signed_streams(payload, s_bits + 7 + len_bits, y_bits,
                                (lsh // ts) * (lsw // ts))
    lluv = unpack_signed_streams(payload, s_bits + 7 + len_bits + y_bits,
                                 uv_bits, 2 * (csh // ts) * (csw // ts))
    gy = ll_grid(lly, lsh, lsw, (geo.x_slices * lsw) // ts, qm_block_y)
    gu = ll_grid(lluv[:, 0::2].copy(), csh, csw,
                 (geo.x_slices * csw) // ts, qm_block_c)
    gv = ll_grid(lluv[:, 1::2].copy(), csh, csw,
                 (geo.x_slices * csw) // ts, qm_block_c)
    return gy, gu, gv


def synthesise_ld_payload_to_words(payload: np.ndarray, sizes, qmatrix,
                                   kernel: WaveletKernel, depth: int, geo,
                                   out_geometry: PictureGeometry,
                                   bitdepth: int, qm_block_y, qm_block_c,
                                   start: int = 0, allow_pack: bool = True):
    """Async full-device LD decode route: the compressed payload plus the
    small host-dequantised LL grids go to the device; entropy unpack of the
    body coefficients, dequant, IDWT and output formatting run on chip.
    Returns (q_indices, (device_words, postprocess)), or (q, None) when the
    window blocks would be pathologically large (host/plane route instead).
    Requires the native codec (the LL recurrence is host-sequential)."""
    from vc2tpu.slices.ld import ld_header_fields

    q, s_bits, len_bits, y_bits, uv_bits, _end = ld_header_fields(
        payload, sizes, start)
    (lsh, lsw), (csh, csw) = geo.luma_slice, geo.chroma_slice
    Ly, Lc = lsh * lsw, csh * csw
    n = geo.n_slices
    wy = device_unpack.window_words_bits(
        _bucket_bytes(int(y_bits.max(initial=0)) // 8 + 1) * 8, Ly)
    wc = device_unpack.window_words_bits(
        _bucket_bytes(int(uv_bits.max(initial=0)) // 8 + 1) * 8, 2 * Lc)
    if 4 * n * (wy + wc) > (1 << 28):
        return q, None                      # skewed sizes: fall back

    gy, gu, gv = ld_ll_grids(payload, q, s_bits, len_bits, y_bits, uv_bits,
                             geo, depth, qm_block_y, qm_block_c)

    geo_key = (geo.y_slices, geo.x_slices, lsh, lsw, csh, csw)
    out_key = (out_geometry.luma_height, out_geometry.luma_width,
               out_geometry.chroma_height, out_geometry.chroma_width)
    pack10 = bool(allow_pack and bitdepth == 10)
    fn = _ld_payload_synthesis_fn(kernel, depth, geo_key, out_key, bitdepth,
                                  pack10, (wy, wc))
    p4 = _bucket((len(payload) + 3) // 4 * 4 + 8)
    padded = np.full(p4, 0xFF, np.uint8)    # at-EOF reads are 1-bits
    padded[:len(payload)] = payload
    i32 = lambda a: jnp.asarray(np.asarray(a), jnp.int32)
    out = fn(jnp.asarray(padded), i32(s_bits), i32(len_bits), i32(y_bits),
             i32(uv_bits), i32(q), jnp.asarray(qmatrix.astype(np.int32)),
             i32(gy), i32(gu), i32(gv))
    return q, _finish(out, out_geometry, pack10)


def _bucket_bytes(n: int) -> int:
    """Power-of-two bucket (>= 8) for the per-component window size so VBR
    streams with drifting max component lengths do not retrace every frame."""
    b = 8
    while b < n:
        b *= 2
    return b


@functools.lru_cache(maxsize=16)
def _idwt_bytes_fn(kernel: WaveletKernel, depth: int, out_key, bitdepth: int,
                   pack10: bool):
    """Fused IDWT + clip + planar-format from already-dequantised transform
    planes (the LD decode tail — dequantisation with DC prediction runs on
    the host, reference DecodeStream.cpp:404-450)."""
    (out_lh, out_lw, out_ch, out_cw) = out_key
    fmt = _make_fmt(bitdepth, pack10)

    def inv(t, lh, lw):
        bands = lifting.inplace_to_bands(t.astype(jnp.int32), depth)
        return lifting.inverse_bands(bands, kernel, depth)[:lh, :lw]

    def fn(ty, tu, tv):
        fy = fmt(inv(ty, out_lh, out_lw))
        fu = fmt(inv(tu, out_ch, out_cw))
        fv = fmt(inv(tv, out_ch, out_cw))
        if pack10:
            return _pack_planes10([fy, fu, fv])
        return jnp.concatenate([fy, fu, fv])

    return jax.jit(fn)


def synthesise_transform_to_words(transform, kernel: WaveletKernel,
                                  depth: int, out_geometry: PictureGeometry,
                                  bitdepth: int, allow_pack: bool = True):
    """Async LD fast tail: host-dequantised transform planes -> device IDWT +
    output formatting; one narrow host->device copy per plane (int16 when the
    values fit) and one packed fetch. Returns (device_words, post)."""
    out_key = (out_geometry.luma_height, out_geometry.luma_width,
               out_geometry.chroma_height, out_geometry.chroma_width)
    pack10 = bool(allow_pack and bitdepth == 10)
    fn = _idwt_bytes_fn(kernel, depth, out_key, bitdepth, pack10)

    def put(p):
        p = np.asarray(p)
        # range check, not abs().max(): np.abs(INT32_MIN) wraps negative
        # (reachable via int32-wrapping dequant of corrupt streams) and
        # would pass an abs test, silently truncating to int16
        if (p.size == 0
                or (int(p.min()) >= -32767 and int(p.max()) <= 32767)):
            return jnp.asarray(p.astype(np.int16))
        return jnp.asarray(p, jnp.int32)

    out = fn(put(transform.y), put(transform.c1), put(transform.c2))
    return _finish(out, out_geometry, pack10)


def _bucket(n: int) -> int:
    """Round up to the next {1, 1.5}x power-of-two size (limits jit
    retraces from data-dependent packed-buffer lengths)."""
    p = 1 << max(10, int(np.ceil(np.log2(max(n, 1)))))
    return (3 * p // 4) if n <= 3 * p // 4 else p


def _unpack10(w: np.ndarray, n_samples: int) -> bytes:
    """Expand 3x10-bit packed uint32 words (flat thirds layout) to the
    big-endian MSB-justified 16-bit planar wire format."""
    if native is not None:
        return native.unpack10_to_be16(w, n_samples).tobytes()
    flat = np.concatenate([(w >> 20) & 1023, (w >> 10) & 1023,
                           w & 1023]).astype(np.uint16)[:n_samples]
    return (flat << 6).astype(">u2").tobytes()


def _unpack10_2d(w2d: np.ndarray, dims) -> bytes:
    """Host twin of _pack_planes10: split the fetched 2D word array back
    into per-plane word blocks and expand each — a plane's block raveled
    row-major IS the flat thirds layout of the (row-padded) plane, with
    the pad rows landing at the tail where the sample-count crop drops
    them, so the flat expander applies per plane unchanged."""
    lh, lw, ch, cw = dims
    lh3 = -(-lh // 3)
    wy = np.ascontiguousarray(w2d[:lh3])
    rest = w2d[lh3:]
    if 2 * cw == lw:
        wu = np.ascontiguousarray(rest[:, :cw])
        wv = np.ascontiguousarray(rest[:, cw:])
    else:
        ch3 = -(-ch // 3)
        wu = np.ascontiguousarray(rest[:ch3])
        wv = np.ascontiguousarray(rest[ch3:])
    return b"".join(_unpack10(p.ravel(), ns) for p, ns in
                    ((wy, lh * lw), (wu, ch * cw), (wv, ch * cw)))


def synthesise_to_words(combined, q_indices, qmatrix, kernel: WaveletKernel,
                        depth: int, geo, out_geometry: PictureGeometry,
                        bitdepth: int, allow_pack: bool = True,
                        widths: np.ndarray | None = None):
    """Async fast path: one host->device copy of the combined coefficient
    buffer (int16 normally), full synthesis + output formatting on device.
    Returns (device_words, postprocess) WITHOUT blocking; postprocess turns
    the fetched np array into wire bytes. Callers overlap the fetch with
    later host work."""
    qm_bands = jnp.asarray(qmatrix.astype(np.int32))
    geo_key = (geo.y_slices, geo.x_slices, *geo.luma_slice, *geo.chroma_slice)
    out_key = (out_geometry.luma_height, out_geometry.luma_width,
               out_geometry.chroma_height, out_geometry.chroma_width)
    pack10 = bool(allow_pack and bitdepth == 10)
    fn = _synthesis_bytes_fn(kernel, depth, geo_key, out_key, bitdepth, pack10)
    combined = np.asarray(combined) if not hasattr(combined, "dtype") else combined
    if (native is not None and isinstance(combined, np.ndarray)
            and combined.dtype == np.int16):
        # fixed-width repack: ~2-4x smaller host->device copy
        n = geo.n_slices
        Ly = geo.luma_slice[0] * geo.luma_slice[1]
        Lc = geo.chroma_slice[0] * geo.chroma_slice[1]
        win = widths is not None
        if not win:
            widths = np.empty(3 * n, np.uint8)
        scratch = np.zeros(_bucket((combined.size * 16 + 63) // 32 + 2),
                           np.uint32)
        b = native.fixedpack(combined[:n * Ly], n, Ly, widths[:n], scratch,
                             0, win)
        b = native.fixedpack(combined[n * Ly:n * (Ly + Lc)], n, Lc,
                             widths[n:2 * n], scratch, b, win)
        b = native.fixedpack(combined[n * (Ly + Lc):], n, Lc,
                             widths[2 * n:], scratch, b, win)
        words = int(b + 31) // 32 + 1
        out = fn(jnp.asarray(scratch[:_bucket(words)]),
                 jnp.asarray(q_indices, jnp.int32), qm_bands,
                 widths=jnp.asarray(widths))
    else:
        out = fn(jnp.asarray(combined), jnp.asarray(q_indices, jnp.int32),
                 qm_bands)
    return _finish(out, out_geometry, pack10)


@functools.lru_cache(maxsize=32)
def _synthesis_fn(kernel: WaveletKernel, depth: int, geo_key, out_key,
                  chroma_format: ColourFormat):
    (ys, xs, lsh, lsw, csh, csw) = geo_key
    (out_lh, out_lw, out_ch, out_cw) = out_key

    def fn(qy, qu, qv, q_idx, qm_y_lanes, qm_c_lanes):
        aq_y = adjust_quant_index(q_idx[:, None], qm_y_lanes[None, :])
        aq_c = adjust_quant_index(q_idx[:, None], qm_c_lanes[None, :])
        ty = layout.lanes_to_plane(scale(qy, aq_y), ys, xs, lsh, lsw, depth)
        tu = layout.lanes_to_plane(scale(qu, aq_c), ys, xs, csh, csw, depth)
        tv = layout.lanes_to_plane(scale(qv, aq_c), ys, xs, csh, csw, depth)
        y = lifting.inverse_plane(ty, kernel, depth)[:out_lh, :out_lw]
        c1 = lifting.inverse_plane(tu, kernel, depth)[:out_ch, :out_cw]
        c2 = lifting.inverse_plane(tv, kernel, depth)[:out_ch, :out_cw]
        return y, c1, c2

    return jax.jit(fn)


def synthesise_lanes(qy, qu, qv, q_indices, qmatrix, kernel: WaveletKernel,
                     depth: int, geo, out_geometry: PictureGeometry,
                     chroma_format: ColourFormat,
                     dequant_only: bool = False) -> Picture:
    """lanes (already entropy-decoded) -> inverse quantise -> IDWT -> crop."""
    d = depth
    _, band_y = layout.lane_order(geo.luma_slice[0], geo.luma_slice[1], d)
    _, band_c = layout.lane_order(geo.chroma_slice[0], geo.chroma_slice[1], d)
    qm_y = jnp.asarray(qmatrix[band_y].astype(np.int32))
    qm_c = jnp.asarray(qmatrix[band_c].astype(np.int32))
    if dequant_only:
        aq_y = adjust_quant_index(np.asarray(q_indices)[:, None], qmatrix[band_y][None, :])
        aq_c = adjust_quant_index(np.asarray(q_indices)[:, None], qmatrix[band_c][None, :])
        ty = layout.lanes_to_plane(np.asarray(scale(jnp.asarray(qy), jnp.asarray(aq_y))),
                                   geo.y_slices, geo.x_slices, *geo.luma_slice, d)
        tu = layout.lanes_to_plane(np.asarray(scale(jnp.asarray(qu), jnp.asarray(aq_c))),
                                   geo.y_slices, geo.x_slices, *geo.chroma_slice, d)
        tv = layout.lanes_to_plane(np.asarray(scale(jnp.asarray(qv), jnp.asarray(aq_c))),
                                   geo.y_slices, geo.x_slices, *geo.chroma_slice, d)
        return Picture(ty, tu, tv, chroma_format)
    geo_key = (geo.y_slices, geo.x_slices, *geo.luma_slice, *geo.chroma_slice)
    out_key = (out_geometry.luma_height, out_geometry.luma_width,
               out_geometry.chroma_height, out_geometry.chroma_width)
    fn = _synthesis_fn(kernel, depth, geo_key, out_key, chroma_format)
    y, c1, c2 = fn(jnp.asarray(qy, jnp.int32), jnp.asarray(qu, jnp.int32),
                   jnp.asarray(qv, jnp.int32), jnp.asarray(q_indices, jnp.int32),
                   qm_y, qm_c)
    return Picture(np.asarray(y), np.asarray(c1), np.asarray(c2), chroma_format)
