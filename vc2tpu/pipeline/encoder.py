"""Encoder pipeline: device analysis (DWT + RDO + quantise) + host packing.

Mirrors the EncodeStream frame loop (/root/reference/src/EncodeStream/
EncodeStream.cpp:452-770): interlaced input encodes fields separately with a
halved byte budget; tap outputs expose each pipeline stage.

Device/host split: everything coefficient-shaped (transform, rate control,
quantisation) runs in one jitted function; everything stream-shaped (exp-
Golomb packing, data units) runs on host via the native codec.
"""

from __future__ import annotations

import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from vc2tpu.core.config import EncoderConfig, Mode, PictureGeometry
from vc2tpu.core.picture import Picture
from vc2tpu.quant.quantiser import MAX_QINDEX, quant_banded
from vc2tpu.rdo.cbr import cbr_quant_indices
from vc2tpu.slices import layout
from vc2tpu.slices.hq import encode_hq_slices
from vc2tpu.vlc import device_pack
from vc2tpu.wavelet import lifting, matrices


@dataclasses.dataclass(frozen=True)
class SliceGeometry:
    """Static per-picture slice/lane geometry."""

    y_slices: int
    x_slices: int
    padded_luma: tuple[int, int]
    padded_chroma: tuple[int, int]
    luma_slice: tuple[int, int]      # slice block dims in the luma plane
    chroma_slice: tuple[int, int]

    @property
    def n_slices(self) -> int:
        return self.y_slices * self.x_slices


def _print_slice_suggestions(cfg: EncoderConfig, luma_h: int,
                             chroma_h: int) -> None:
    """Actionable parameter hints on slice-geometry failure, matching the
    reference's clog output (EncodeStream.cpp:383-399): suggest nearby
    --hSlice/--vSlice values at the requested depth when a transform at that
    depth is possible, else suggest the nearest workable --waveletDepth plus
    matching slice sizes."""
    import sys

    g = cfg.geometry
    d = cfg.wavelet_depth
    try:
        if (matrices.wavelet_transform_is_possible(d, g.luma_width,
                                                   g.chroma_width)
                and matrices.wavelet_transform_is_possible(d, luma_h,
                                                           chroma_h)):
            print("Consider setting --hSlice (-a) to "
                  f"{matrices.suggest_slice_size(d, g.luma_width, g.chroma_width, cfg.x_size)}"
                  " and --vSlice (-u) to "
                  f"{matrices.suggest_slice_size(d, luma_h, chroma_h, cfg.y_size)}.",
                  file=sys.stderr)
        else:
            sd = matrices.suggest_wavelet_depth(g.luma_width, luma_h,
                                                g.chroma_width, chroma_h, d)
            print(f"It is not possible to encode this input with a wavelet "
                  f"depth of {d}.", file=sys.stderr)
            print(f"Consider setting --waveletDepth (-d) to {sd}"
                  " and --hSlice (-a) to "
                  f"{matrices.suggest_slice_size(sd, g.luma_width, g.chroma_width, cfg.x_size)}"
                  " and --vSlice (-u) to "
                  f"{matrices.suggest_slice_size(sd, luma_h, chroma_h, cfg.y_size)}.",
                  file=sys.stderr)
    except ValueError:
        pass                      # no workable parameters exist to suggest


def slice_geometry(cfg: EncoderConfig) -> SliceGeometry:
    g = cfg.geometry
    luma_h = g.luma_height // 2 if cfg.interlaced else g.luma_height
    chroma_h = g.chroma_height // 2 if cfg.interlaced else g.chroma_height
    y_slices = matrices.slice_size_is_valid(cfg.wavelet_depth, luma_h,
                                            chroma_h, cfg.y_size)
    x_slices = matrices.slice_size_is_valid(cfg.wavelet_depth, g.luma_width,
                                            g.chroma_width, cfg.x_size)
    if not y_slices or not x_slices:
        _print_slice_suggestions(cfg, luma_h, chroma_h)
        raise ValueError(
            "The given waveletDepth, hSlice, and vSlice parameters cannot "
            "encode this input. See above for suggested parameters.")
    pl = (matrices.padded_size(luma_h, cfg.wavelet_depth),
          matrices.padded_size(g.luma_width, cfg.wavelet_depth))
    pc = (matrices.padded_size(chroma_h, cfg.wavelet_depth),
          matrices.padded_size(g.chroma_width, cfg.wavelet_depth))
    return SliceGeometry(
        y_slices, x_slices, pl, pc,
        (pl[0] // y_slices, pl[1] // x_slices),
        (pc[0] // y_slices, pc[1] // x_slices),
    )


def put_planes(picture: Picture, depth: int):
    """Host->device input transfer at the narrowest exact width — 3x10-bit
    words for 10-bit video, int8 for <=8-bit, int16 otherwise — fused
    into ONE buffer so the frame costs a single transfer latency instead of
    three plane uploads. Returns (buffer, packed10)."""
    planes = (picture.y, picture.c1, picture.c2)
    if depth == 10:
        # 2D row-thirds pack, the H2D twin of the decode tails'
        # _pack_planes10: ONE 2D buffer (luma word rows over the
        # side-by-side chroma pair) so the device unpack needs no
        # relayout; the transfer linearisation is free either way
        def pack(a):
            p = (np.asarray(a, np.int32) + 512).astype(np.uint32)
            hh, ww = p.shape
            h3 = -(-hh // 3)
            if 3 * h3 != hh:
                p = np.vstack([p, np.zeros((3 * h3 - hh, ww),
                                           np.uint32)])
            return (p[:h3] << 20) | (p[h3:2 * h3] << 10) | p[2 * h3:]

        wy, wu, wv = (pack(p) for p in planes)
        if 2 * wu.shape[1] == wy.shape[1]:
            fused = np.vstack([wy, np.hstack([wu, wv])])
        else:
            fused = np.vstack([wy, wu, wv])
        return jnp.asarray(fused), True
    dt = np.int8 if depth <= 8 else (np.int16 if depth <= 16
                                     else np.int32)
    return jnp.asarray(np.concatenate(
        [np.asarray(p, dt).ravel() for p in planes])), False


def unpack_ingest(planes, packed10: bool, luma_h: int, luma_w: int,
                  chroma_h: int, chroma_w: int):
    """Device-side unpack of put_planes' fused wire buffer into the three
    int32 planes. For packed10, word row r of a plane packs its rows
    (r, r+h3, r+2h3): unpacking is three shifts + a row concat — all 2D, no
    lane-strided interleave and no flat->2D reshape (the old
    stack().ravel().reshape() form was the same relayout-loop trap the
    decode tails had)."""
    if packed10:
        def unpack2d(w2d, h):
            v = jnp.concatenate([(w2d >> 20) & 1023,
                                 (w2d >> 10) & 1023,
                                 w2d & 1023], axis=0)[:h]
            return v.astype(jnp.int32) - 512

        lh3 = -(-luma_h // 3)
        ch3 = -(-chroma_h // 3)
        if isinstance(planes, tuple):
            wy, wu, wv = planes
        elif 2 * chroma_w == luma_w:
            wy = planes[:lh3]
            wu = planes[lh3:, :chroma_w]
            wv = planes[lh3:, chroma_w:]
        else:
            wy = planes[:lh3]
            wu = planes[lh3:lh3 + ch3]
            wv = planes[lh3 + ch3:]
        return (unpack2d(wy, luma_h), unpack2d(wu, chroma_h),
                unpack2d(wv, chroma_h))
    if isinstance(planes, tuple):
        return planes
    ny, nc = luma_h * luma_w, chroma_h * chroma_w
    return (planes[:ny].reshape(luma_h, luma_w),
            planes[ny:ny + nc].reshape(chroma_h, chroma_w),
            planes[ny + nc:ny + 2 * nc].reshape(chroma_h, chroma_w))


@dataclasses.dataclass
class EncodedPicture:
    q_indices: np.ndarray            # int32 [ySlices, xSlices]
    payload: bytes                   # concatenated slice payloads
    slice_totals: np.ndarray         # per-slice byte sizes, raster order
    transform: Picture | None = None
    quantised: Picture | None = None


class Encoder:
    """HQ (ConstQ / CBR) picture encoder. One instance per EncoderConfig;
    the device function compiles once per geometry."""

    def __init__(self, cfg: EncoderConfig):
        cfg.validate()
        self.cfg = cfg
        self._route = None            # ConstQ analysis route (see
        self._probe_state = 0         # encode_picture_async)
        self._t_device = None
        self._budgets_dev = None
        self.geo = slice_geometry(cfg)
        self.qmatrix = matrices.quant_matrix(cfg.kernel, cfg.wavelet_depth)
        d = cfg.wavelet_depth
        _, band_y = layout.lane_order(*self.geo.luma_slice, d)
        _, band_c = layout.lane_order(*self.geo.chroma_slice, d)
        self.qm_lanes_y = self.qmatrix[band_y].astype(np.int32)
        self.qm_lanes_c = self.qmatrix[band_c].astype(np.int32)
        self.band_sizes_y = tuple(int(c) for c in np.bincount(band_y))
        self.band_sizes_c = tuple(int(c) for c in np.bincount(band_c))
        self.qm_bands = self.qmatrix.astype(np.int32)
        if cfg.mode == Mode.HQ_CBR:
            self.picture_bytes = (cfg.compressed_bytes // 2 if cfg.interlaced
                                  else cfg.compressed_bytes)
            self.slice_budgets = layout.slice_bytes_map(
                self.geo.y_slices, self.geo.x_slices, self.picture_bytes,
                cfg.slice_scalar)
        else:
            self.slice_budgets = None
        self._analyse = jax.jit(self._analyse_impl,
                                static_argnames=("keep_planes", "packed10"))
        # device packer static geometry: words per slice row + payload cap.
        # Both are adaptive power-of-two buckets (a miss sets a device-side
        # flag / totals check and the host retries one bucket up — recompiles
        # are rare and cached, while the local-assembly cost scales with w32
        # and the fetch cost with cap).
        self._w32_max = (cfg.slice_prefix + 4 + 3 * 255 * cfg.slice_scalar
                         + 3) // 4
        if cfg.mode == Mode.HQ_CBR:
            self._w32 = min((cfg.slice_prefix + int(self.slice_budgets.max())
                             + 3) // 4, self._w32_max)
            self._cap = (self.geo.n_slices * cfg.slice_prefix
                         + int(self.slice_budgets.sum()))
        else:
            coeffs = self.geo.n_slices * (
                self.geo.luma_slice[0] * self.geo.luma_slice[1]
                + 2 * self.geo.chroma_slice[0] * self.geo.chroma_slice[1])
            guess = self.geo.n_slices * (cfg.slice_prefix + 4) + coeffs // 4
            self._cap = 1 << max(14, int(np.ceil(np.log2(guess))))
            per_slice = 2 * self._cap // max(self.geo.n_slices, 1) + 16
            self._w32 = min(1 << int(np.ceil(np.log2(per_slice / 4))),
                            self._w32_max)

    # ---- device side ----

    def _analyse_impl(self, planes, budgets, keep_planes: bool = False,
                      packed10: bool = False):
        cfg = self.cfg
        d = cfg.wavelet_depth
        g = cfg.geometry
        luma_h = (g.luma_height // 2 if cfg.interlaced else g.luma_height)
        chroma_h = (g.chroma_height // 2 if cfg.interlaced
                    else g.chroma_height)
        y, c1, c2 = unpack_ingest(planes, packed10, luma_h, g.luma_width,
                                  chroma_h, g.chroma_width)
        ys, xs = self.geo.y_slices, self.geo.x_slices
        by = lifting.forward_bands(lifting.wavelet_pad(y, d), cfg.kernel, d)
        bu = lifting.forward_bands(lifting.wavelet_pad(c1, d), cfg.kernel, d)
        bv = lifting.forward_bands(lifting.wavelet_pad(c2, d), cfg.kernel, d)
        ly = lifting.bands_to_lanes(by, ys, xs)
        lu = lifting.bands_to_lanes(bu, ys, xs)
        lv = lifting.bands_to_lanes(bv, ys, xs)
        qm = jnp.asarray(self.qm_bands)
        bs_y, bs_c = self.band_sizes_y, self.band_sizes_c
        if cfg.mode == Mode.HQ_CBR:
            q_idx = cbr_quant_indices(ly, lu, lv, qm, bs_y, bs_c, budgets,
                                      cfg.slice_scalar)
        else:
            q_idx = jnp.full((self.geo.n_slices,), cfg.q_index, dtype=jnp.int32)
        out = dict(q_indices=q_idx,
                   qy=quant_banded(ly, q_idx, qm, bs_y),
                   qu=quant_banded(lu, q_idx, qm, bs_c),
                   qv=quant_banded(lv, q_idx, qm, bs_c))
        if keep_planes:
            out.update(ty=lifting.bands_to_inplace(by, d),
                       tu=lifting.bands_to_inplace(bu, d),
                       tv=lifting.bands_to_inplace(bv, d))
        return out

    # ---- host side ----

    def _put_planes(self, picture: Picture):
        return put_planes(picture,
                          max(self.cfg.luma_depth, self.cfg.chroma_depth))

    def _budgets(self):
        """Per-slice byte budgets, uploaded to the device once per Encoder
        (they are static per stream; re-uploading per frame cost a transfer
        latency plus up to 0.5 MB/frame at 4K)."""
        if self._budgets_dev is None:
            self._budgets_dev = (
                jnp.asarray(self.slice_budgets.ravel())
                if self.slice_budgets is not None
                else jnp.zeros((self.geo.n_slices,), jnp.int32))
        return self._budgets_dev

    def encode_picture(self, picture: Picture, keep_planes: bool = False,
                       ) -> EncodedPicture:
        budgets = self._budgets()
        planes, packed10 = self._put_planes(picture)
        res = self._analyse(planes, budgets, keep_planes=keep_planes,
                            packed10=packed10)
        if not keep_planes:
            out = self._pack_on_device(res, budgets)
            if out is not None:
                return out
        q_idx = np.asarray(res["q_indices"])
        qy = np.asarray(res["qy"])
        qu = np.asarray(res["qu"])
        qv = np.asarray(res["qv"])
        if (q_idx > MAX_QINDEX).any():
            raise ValueError(
                "quantization index exceeds maximum implemented value.")
        sizes = (self.slice_budgets.ravel()
                 if self.slice_budgets is not None else None)
        payload, totals = encode_hq_slices(
            q_idx, qy, qu, qv, self.cfg.slice_prefix, self.cfg.slice_scalar,
            slice_sizes=sizes)
        out = EncodedPicture(
            q_indices=q_idx.reshape(self.geo.y_slices, self.geo.x_slices),
            payload=payload, slice_totals=np.asarray(totals))
        if keep_planes:
            out.transform = Picture(np.asarray(res["ty"]), np.asarray(res["tu"]),
                                    np.asarray(res["tv"]), picture.chroma_format)
            out.quantised = Picture(
                self._lanes_to_plane(qy, False), self._lanes_to_plane(qu, True),
                self._lanes_to_plane(qv, True), picture.chroma_format)
        return out

    def _pack_dispatch(self, res, budgets):
        cfg = self.cfg
        out = device_pack.pack_hq_payload(
            res["qy"], res["qu"], res["qv"], res["q_indices"], budgets,
            prefix=cfg.slice_prefix, scalar=cfg.slice_scalar,
            w32=self._w32, cap_bytes=self._cap,
            cbr=cfg.mode == Mode.HQ_CBR)
        try:
            out.copy_to_host_async()
        except Exception:
            pass
        return out

    def _pack_on_device(self, res, budgets) -> EncodedPicture | None:
        """Assemble the slice payload on the device (device_pack) so the only
        device->host copy is the compressed bytes. Returns None to fall back
        to the host packer (oversized codes / capacity miss)."""
        return self._pack_finalize(self._pack_dispatch(res, budgets), res,
                                   budgets)

    def _pack_finalize(self, buf_dev, res, budgets) -> EncodedPicture | None:
        while True:
            buf = np.asarray(buf_dev)
            flags, q_idx, totals, payload = device_pack.unpack_result(
                buf, self.geo.n_slices)
            if flags & device_pack.FLAG_CODE_OVERFLOW:
                return None
            if flags & device_pack.FLAG_W32:  # slice row miss: grow + retry
                if self._w32 >= self._w32_max:
                    return None
                self._w32 = min(self._w32 * 2, self._w32_max)
                buf_dev = self._pack_dispatch(res, budgets)
                continue
            total = int(totals.sum(dtype=np.int64))
            if total > self._cap:           # VBR capacity miss: grow + retry
                self._cap = 1 << int(np.ceil(np.log2(total)))
                buf_dev = self._pack_dispatch(res, budgets)
                continue
            # shrink the fetch capacity / slice-row width when >2x oversized
            # (hysteresis avoids recompile thrash); takes effect next picture
            want = 1 << max(14, int(np.ceil(np.log2(max(total, 1) * 13 // 10))))
            if want <= self._cap // 2:
                self._cap = want
            want_w = 1 << int(np.ceil(np.log2(
                max(int(totals.max()) * 13 // 10, 16) / 4)))
            if self.cfg.mode != Mode.HQ_CBR and want_w <= self._w32 // 2:
                self._w32 = want_w
            break
        if (q_idx > MAX_QINDEX).any():
            raise ValueError(
                "quantization index exceeds maximum implemented value.")
        if flags & device_pack.FLAG_CBR_FIT:
            raise ValueError("SliceIO, HQ CBR mode: Too many bytes for the slice")
        if flags & device_pack.FLAG_VLEN:
            raise ValueError(
                "Slice component length exceeds 1 byte when divided by "
                "slice size scalar. See above for suggestions to prevent "
                "this.")
        if flags & device_pack.FLAG_SCALAR:
            raise ValueError(
                "Slice scalar is too small, consider using a larger slice "
                "scalar.")
        return EncodedPicture(
            q_indices=q_idx.reshape(self.geo.y_slices, self.geo.x_slices),
            payload=payload[:total].tobytes(),
            slice_totals=totals.astype(np.int64))

    # --- ConstQ host route (same rationale as the decoder's host synthesis
    # tail: with no rate-control search there is little device compute to
    # amortise, so when shipping the frame to the device costs more than one
    # core's forward DWT + quantise + pack, run the whole analysis where the
    # input already lives). CBR always uses the device — the batched search
    # is genuine accelerator work. ---

    def _can_host(self) -> bool:
        from vc2tpu.pipeline import host_synth

        return self.cfg.mode == Mode.HQ_ConstQ and host_synth.available()

    def _encode_host(self, picture: Picture) -> EncodedPicture:
        from vc2tpu._native.bridge import native
        from vc2tpu.pipeline import host_synth

        cfg, geo = self.cfg, self.geo
        q_idx = np.full(geo.n_slices, cfg.q_index, np.int32)
        qm_key = tuple(int(v) for v in self.qm_bands)
        lanes = []
        for p, (sh, sw), (ph, pw) in (
                (picture.y, geo.luma_slice, geo.padded_luma),
                (picture.c1, geo.chroma_slice, geo.padded_chroma),
                (picture.c2, geo.chroma_slice, geo.padded_chroma)):
            arr = np.asarray(p, np.int32)
            if arr.shape != (ph, pw):
                arr = np.pad(arr, ((0, ph - arr.shape[0]),
                                   (0, pw - arr.shape[1])), mode="edge")
            plane = host_synth.dwt_plane_host(arr, cfg.kernel,
                                              cfg.wavelet_depth)
            off_plane, qm_lane = host_synth._scatter_tables(
                sh, sw, cfg.wavelet_depth, pw, qm_key)
            out = np.empty((geo.n_slices, sh * sw), np.int32)
            native.hq_quant_gather(plane, q_idx, qm_lane, off_plane,
                                   geo.x_slices, sh, sw, out)
            lanes.append(out)
        payload, totals = encode_hq_slices(
            q_idx, *lanes, cfg.slice_prefix, cfg.slice_scalar)
        return EncodedPicture(
            q_indices=q_idx.reshape(geo.y_slices, geo.x_slices),
            payload=payload, slice_totals=np.asarray(totals))

    def encode_picture_async(self, picture: Picture):
        """Routed async encode: device pipeline (default; the only route for
        CBR) or the native host path for ConstQ when it is faster. The
        'auto' probe times one warm device frame against one host frame and
        commits; VC2TPU_ENCODE_ROUTE=device|host overrides."""
        if self._can_host() and self._route is None:
            mode = os.environ.get("VC2TPU_ENCODE_ROUTE", "auto")
            if mode in ("device", "host"):
                self._route = mode
            else:
                self._probe_state += 1
                if self._probe_state == 2:      # device, warm, timed
                    t0 = time.perf_counter()
                    enc = self._device_async(picture)()
                    self._t_device = time.perf_counter() - t0
                    return lambda: enc
                if self._probe_state == 3:      # host, timed -> commit
                    t0 = time.perf_counter()
                    enc = self._encode_host(picture)
                    t_host = time.perf_counter() - t0
                    self._route = ("host" if t_host < self._t_device
                                   else "device")
                    return lambda: enc
                # probe_state 1: device compile warm-up frame
        if self._route == "host" and self._can_host():
            enc = self._encode_host(picture)
            return lambda: enc
        return self._device_async(picture)

    def _device_async(self, picture: Picture):
        """Dispatch analysis + device packing and return a zero-arg callable
        producing the EncodedPicture; the device->host copy overlaps whatever
        the caller does before invoking it (one-frame software pipeline)."""
        budgets = self._budgets()
        planes, packed10 = self._put_planes(picture)
        res = self._analyse(planes, budgets, keep_planes=False,
                            packed10=packed10)
        buf_dev = self._pack_dispatch(res, budgets)

        def result() -> EncodedPicture:
            out = self._pack_finalize(buf_dev, res, budgets)
            if out is not None:
                return out
            return self._host_pack(res)

        return result

    def _host_pack(self, res) -> EncodedPicture:
        """Host packer fallback (also the tap-output path)."""
        q_idx = np.asarray(res["q_indices"])
        if (q_idx > MAX_QINDEX).any():
            raise ValueError(
                "quantization index exceeds maximum implemented value.")
        sizes = (self.slice_budgets.ravel()
                 if self.slice_budgets is not None else None)
        payload, totals = encode_hq_slices(
            q_idx, np.asarray(res["qy"]), np.asarray(res["qu"]),
            np.asarray(res["qv"]), self.cfg.slice_prefix,
            self.cfg.slice_scalar, slice_sizes=sizes)
        return EncodedPicture(
            q_indices=q_idx.reshape(self.geo.y_slices, self.geo.x_slices),
            payload=payload, slice_totals=np.asarray(totals))

    def _lanes_to_plane(self, lanes: np.ndarray, chroma: bool) -> np.ndarray:
        sh, sw = self.geo.chroma_slice if chroma else self.geo.luma_slice
        return layout.lanes_to_plane(lanes, self.geo.y_slices, self.geo.x_slices,
                                     sh, sw, self.cfg.wavelet_depth)

    def decode_inprocess(self, enc: EncodedPicture, geometry: PictureGeometry,
                         ) -> Picture:
        """Inverse-quantise + inverse transform the quantised lanes, as the
        encoder's DECODED/PSNR taps do (EncodeStream.cpp:649-664)."""
        from vc2tpu.pipeline.decoder import synthesise_lanes

        res = enc
        qy = layout.plane_to_lanes(np.asarray(res.quantised.y), self.geo.y_slices,
                                   self.geo.x_slices, self.cfg.wavelet_depth)
        qu = layout.plane_to_lanes(np.asarray(res.quantised.c1), self.geo.y_slices,
                                   self.geo.x_slices, self.cfg.wavelet_depth)
        qv = layout.plane_to_lanes(np.asarray(res.quantised.c2), self.geo.y_slices,
                                   self.geo.x_slices, self.cfg.wavelet_depth)
        return synthesise_lanes(
            qy, qu, qv, res.q_indices.ravel(), self.qmatrix, self.cfg.kernel,
            self.cfg.wavelet_depth, self.geo, geometry,
            chroma_format=self.cfg.chroma_format)
