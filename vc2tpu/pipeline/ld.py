"""LD-profile encoder/decoder glue.

The LD (Low Delay, obsolete) profile couples every slice through LL-subband
DC prediction, a strict raster recurrence (reference Quantisation.cpp:
191-306). The host route runs the recurrence (rate control + predictive
quantisation) in the native host module in one pass; the device route runs
it as a wavefront on the device (rdo/ld.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from vc2tpu.core.config import EncoderConfig, PictureGeometry
from vc2tpu.core.picture import Picture
from vc2tpu.pipeline.encoder import EncodedPicture, slice_geometry
from vc2tpu.slices import layout
from vc2tpu.slices.ld import encode_ld_slices
from vc2tpu.wavelet import lifting, matrices
from vc2tpu._native.bridge import native


def _qm_block(slice_h: int, slice_w: int, depth: int, qmatrix) -> np.ndarray:
    """Per-position quant-matrix values of a slice block, row-major
    (the analogue of SliceQuantiserRef's expanded qMatrix,
    reference EncodeStream.cpp:159-171)."""
    perm, band = layout.lane_order(slice_h, slice_w, depth)
    out = np.zeros(slice_h * slice_w, dtype=np.int32)
    out[perm] = qmatrix[band]
    return out


class LDEncoder:
    def __init__(self, cfg: EncoderConfig, mesh=None):
        if native is None:
            raise RuntimeError("LD mode requires the native host codec "
                               "(build vc2tpu/_native)")
        cfg.validate()
        self.cfg = cfg
        # --mesh: row-band shard the analysis DWT over the ``space`` axis
        # (halo-exchange forward, bit-identical to the single-chip
        # transform); the rate-control recurrence stays on the host, as
        # every LD route's does. "DxS" string or a ready Mesh.
        if isinstance(mesh, str):
            from vc2tpu.shard.mesh import make_mesh

            d, s = (int(v) for v in mesh.lower().split("x"))
            mesh = make_mesh(data=d, space=s)
        self._mesh = mesh
        self._mesh_inert_logged = False
        self.geo = slice_geometry(cfg)
        self.qmatrix = matrices.quant_matrix(cfg.kernel, cfg.wavelet_depth)
        d = cfg.wavelet_depth
        self.qm_block_y = _qm_block(*self.geo.luma_slice, d, self.qmatrix)
        self.qm_block_c = _qm_block(*self.geo.chroma_slice, d, self.qmatrix)
        self.perm_y, band_y = layout.lane_order(*self.geo.luma_slice, d)
        self.perm_c, band_c = layout.lane_order(*self.geo.chroma_slice, d)
        self.picture_bytes = (cfg.compressed_bytes // 2 if cfg.interlaced
                              else cfg.compressed_bytes)
        self.slice_budgets = layout.slice_bytes_map(
            self.geo.y_slices, self.geo.x_slices, self.picture_bytes, 1)
        self._route = None            # analysis-transform route (see _transform)
        # full on-chip analysis route (DWT + wavefront rate control +
        # quantise + entropy pack on device, rdo/ld.py + device_pack): the
        # LD twin of the HQ encoder's device path. VC2TPU_ENCODE_ROUTE
        # forces it; auto compares the first frame's host time against a
        # measured estimate of the device route's transfers.
        self.band_sizes_y = tuple(int(c) for c in np.bincount(band_y))
        self.band_sizes_c = tuple(int(c) for c in np.bincount(band_c))
        self.qm_bands = self.qmatrix.astype(np.int32)
        budgets = self.slice_budgets.ravel()
        from vc2tpu.core.intmath import intlog2
        from vc2tpu.rdo.ld import avail_bits_np

        self._avail_np = avail_bits_np(tuple(int(b) for b in budgets))
        self._len_bits_np = np.array(
            [intlog2(int(8 * b - 7)) for b in budgets], np.int32)
        self._w32_ld = int(budgets.max()) // 4 + 2
        self._cap_ld = int(budgets.sum())
        self._rdo_route = None
        self._host_probe_ts = []      # auto-route host samples (see encode_picture)
        self._dev_consts = None
        self._analyse_dev = jax.jit(
            self._analyse_dev_impl, static_argnames=("packed10",
                                                     "keep_planes"))

        def dwt_planes(y, c1, c2):
            return tuple(
                lifting.bands_to_inplace(
                    lifting.forward_bands(lifting.wavelet_pad(p, d),
                                          cfg.kernel, d), d)
                for p in (y, c1, c2))

        def dwt16(y, c1, c2):
            """One int16 fetch: [y|u|v|overflow-flag]; the host falls back to
            the int32 variant in the (rare) case a coefficient exceeds
            int16."""
            ty, tu, tv = dwt_planes(y, c1, c2)
            parts = [t.ravel() for t in (ty, tu, tv)]
            flat = jnp.concatenate(parts)
            flag = jnp.any(jnp.abs(flat) > 32767).astype(jnp.int16)
            return jnp.concatenate([flat.astype(jnp.int16), flag[None]])

        self._dwt16 = jax.jit(dwt16)
        self._dwt32 = jax.jit(dwt_planes)

    # --- full on-chip analysis (device route) ---

    def _analyse_dev_impl(self, planes, avail, sizes, len_bits,
                          packed10: bool = False, keep_planes: bool = False):
        from vc2tpu.pipeline.encoder import unpack_ingest
        from vc2tpu.rdo.ld import ld_rate_control
        from vc2tpu.quant.quantiser import quant_banded
        from vc2tpu.vlc import device_pack

        cfg = self.cfg
        d = cfg.wavelet_depth
        g = cfg.geometry
        geo = self.geo
        luma_h = g.luma_height // 2 if cfg.interlaced else g.luma_height
        chroma_h = g.chroma_height // 2 if cfg.interlaced else g.chroma_height
        y, c1, c2 = unpack_ingest(planes, packed10, luma_h, g.luma_width,
                                  chroma_h, g.chroma_width)
        ys, xs = geo.y_slices, geo.x_slices
        by = lifting.forward_bands(lifting.wavelet_pad(y, d), cfg.kernel, d)
        bu = lifting.forward_bands(lifting.wavelet_pad(c1, d), cfg.kernel, d)
        bv = lifting.forward_bands(lifting.wavelet_pad(c2, d), cfg.kernel, d)
        ly = lifting.bands_to_lanes(by, ys, xs)
        lu = lifting.bands_to_lanes(bu, ys, xs)
        lv = lifting.bands_to_lanes(bv, ys, xs)
        ts = 1 << d
        ll_y = (geo.luma_slice[0] // ts, geo.luma_slice[1] // ts)
        ll_c = (geo.chroma_slice[0] // ts, geo.chroma_slice[1] // ts)
        qm = jnp.asarray(self.qm_bands)
        bs_y, bs_c = self.band_sizes_y, self.band_sizes_c
        q, llqy, llqu, llqv = ld_rate_control(
            ly, lu, lv, qm, bs_y, bs_c, avail, (ys, xs), ll_y, ll_c)
        nly, nlc = ll_y[0] * ll_y[1], ll_c[0] * ll_c[1]
        qy = jnp.concatenate(
            [llqy, quant_banded(ly[:, nly:], q, qm[1:], bs_y[1:])], axis=1)
        qu = jnp.concatenate(
            [llqu, quant_banded(lu[:, nlc:], q, qm[1:], bs_c[1:])], axis=1)
        qv = jnp.concatenate(
            [llqv, quant_banded(lv[:, nlc:], q, qm[1:], bs_c[1:])], axis=1)
        buf = device_pack.pack_ld_core(qy, qu, qv, q, sizes, len_bits,
                                       w32=self._w32_ld,
                                       cap_bytes=self._cap_ld)
        if keep_planes:
            return buf, dict(ty=lifting.bands_to_inplace(by, d),
                             tu=lifting.bands_to_inplace(bu, d),
                             tv=lifting.bands_to_inplace(bv, d),
                             qy=qy, qu=qu, qv=qv)
        return buf

    def _encode_device(self, picture: Picture, keep_planes: bool,
                       ) -> EncodedPicture | None:
        """Full on-chip LD encode; None when a device-side flag asks for
        the host fallback (a coefficient needing a >32-bit code)."""
        from vc2tpu.pipeline.encoder import put_planes
        from vc2tpu.vlc import device_pack

        cfg = self.cfg
        geo = self.geo
        buf_dev, packed10 = put_planes(
            picture, max(cfg.luma_depth, cfg.chroma_depth))
        if self._dev_consts is None:
            self._dev_consts = (jnp.asarray(self._avail_np),
                                jnp.asarray(self.slice_budgets.ravel()),
                                jnp.asarray(self._len_bits_np))
        avail, sizes, len_bits = self._dev_consts
        res = self._analyse_dev(buf_dev, avail, sizes, len_bits,
                                packed10=packed10, keep_planes=keep_planes)
        buf, planes = res if keep_planes else (res, None)
        buf = np.asarray(buf)
        n = geo.n_slices
        flags, q_idx, payload = device_pack.unpack_ld_result(buf, n)
        if flags & device_pack.FLAG_LD_FIT:
            raise ValueError(
                "SliceIO, LD mode: Too many bytes for the U and V slices")
        if flags:
            return None
        out = EncodedPicture(
            q_indices=np.asarray(q_idx).reshape(geo.y_slices, geo.x_slices),
            payload=payload.tobytes(),
            slice_totals=self.slice_budgets.ravel().astype(np.int64))
        if planes is not None:
            out.transform = Picture(*(np.asarray(planes[k])
                                      for k in ("ty", "tu", "tv")),
                                    picture.chroma_format)
            d = cfg.wavelet_depth
            out.quantised = Picture(
                layout.lanes_to_plane(np.asarray(planes["qy"]),
                                      geo.y_slices, geo.x_slices,
                                      *geo.luma_slice, d),
                layout.lanes_to_plane(np.asarray(planes["qu"]),
                                      geo.y_slices, geo.x_slices,
                                      *geo.chroma_slice, d),
                layout.lanes_to_plane(np.asarray(planes["qv"]),
                                      geo.y_slices, geo.x_slices,
                                      *geo.chroma_slice, d),
                picture.chroma_format)
        return out

    def encode_picture(self, picture: Picture, keep_planes: bool = False,
                       ) -> EncodedPicture:
        import os
        import time

        if self._rdo_route is None:
            mode = os.environ.get("VC2TPU_ENCODE_ROUTE", "auto")
            if mode in ("device", "host"):
                self._rdo_route = mode
            elif self._mesh is not None:
                self._rdo_route = "host"   # mesh analysis shards the DWT
            else:
                # auto: time this frame's host path against a measured
                # estimate of the device route's transfers (packed input up,
                # payload down). Same cold-frame rule as the
                # decoder's _auto_route: a single host sample can only
                # OVERSTATE the host (first-call page-ins, a transient CPU
                # spike), so commit on the first frame only when the host
                # wins decisively; an apparent device win needs a second,
                # warm host sample before it locks the whole stream onto
                # the device route.
                t0 = time.perf_counter()
                out = self._encode_host(picture, keep_planes)
                self._host_probe_ts.append(time.perf_counter() - t0)
                try:
                    from vc2tpu.cli.decode_stream import Decoder

                    (H, W) = self.geo.padded_luma
                    (CH, CW) = self.geo.padded_chroma
                    in_bytes = 4 * (H * W + 2 * CH * CW + 2) // 3
                    dev_est = Decoder(sink=None)._probe_link_seconds(
                        in_bytes + self._cap_ld)
                except Exception:
                    dev_est = float("inf")
                best = min(self._host_probe_ts)
                if len(self._host_probe_ts) >= 2 or best < dev_est / 3:
                    self._rdo_route = "host" if best < dev_est else "device"
                return out
        if self._rdo_route == "device":
            out = self._encode_device(picture, keep_planes)
            if out is not None:
                return out
        return self._encode_host(picture, keep_planes)

    def _encode_host(self, picture: Picture, keep_planes: bool = False,
                     ) -> EncodedPicture:
        cfg = self.cfg
        geo = self.geo
        ty, tu, tv = self._transform(picture)
        H, W = geo.padded_luma
        CH, CW = geo.padded_chroma
        n = geo.n_slices
        Ly = geo.luma_slice[0] * geo.luma_slice[1]
        Lc = geo.chroma_slice[0] * geo.chroma_slice[1]
        q_out = np.zeros(n, dtype=np.int32)
        lanes_y = np.empty((n, Ly), dtype=np.int32)
        lanes_u = np.empty((n, Lc), dtype=np.int32)
        lanes_v = np.empty((n, Lc), dtype=np.int32)
        native.ld_encode(ty, tu, tv, (H, W, CH, CW),
                         (geo.y_slices, geo.x_slices), 1 << cfg.wavelet_depth,
                         self.qm_block_y, self.qm_block_c,
                         self.perm_y, self.perm_c,
                         self.slice_budgets.ravel(), q_out,
                         lanes_y.ravel(), lanes_u.ravel(), lanes_v.ravel())
        payload, totals = encode_ld_slices(q_out, lanes_y, lanes_u, lanes_v,
                                           self.slice_budgets.ravel())
        out = EncodedPicture(
            q_indices=q_out.reshape(geo.y_slices, geo.x_slices),
            payload=payload, slice_totals=np.asarray(totals))
        if keep_planes:
            out.transform = Picture(ty, tu, tv, picture.chroma_format)
            out.quantised = Picture(
                layout.lanes_to_plane(lanes_y, geo.y_slices, geo.x_slices,
                                      *geo.luma_slice, cfg.wavelet_depth),
                layout.lanes_to_plane(lanes_u, geo.y_slices, geo.x_slices,
                                      *geo.chroma_slice, cfg.wavelet_depth),
                layout.lanes_to_plane(lanes_v, geo.y_slices, geo.x_slices,
                                      *geo.chroma_slice, cfg.wavelet_depth),
                picture.chroma_format)
        return out

    # --- analysis transform, adaptively routed (same rationale as the
    # decoder's host synthesis tail: the transform's consumer — the native
    # LD rate-control scan — lives on the host, so when the fetch of
    # 8 MB of int16 coefficients costs more than one core's forward DWT,
    # run the DWT where the coefficients are consumed) ---

    def _transform_device(self, picture: Picture):
        cfg = self.cfg
        dt = (jnp.int16 if max(cfg.luma_depth, cfg.chroma_depth) <= 16
              else jnp.int32)
        y = jnp.asarray(picture.y, dt)
        c1 = jnp.asarray(picture.c1, dt)
        c2 = jnp.asarray(picture.c2, dt)
        buf = np.asarray(self._dwt16(y, c1, c2))
        if buf[-1]:
            ty, tu, tv = self._dwt32(y, c1, c2)
            return tuple(np.ascontiguousarray(np.asarray(a), np.int32)
                         for a in (ty, tu, tv))
        (H, W), (CH, CW) = self.geo.padded_luma, self.geo.padded_chroma
        ny, nc = H * W, CH * CW
        return (buf[:ny].astype(np.int32).reshape(H, W),
                buf[ny:ny + nc].astype(np.int32).reshape(CH, CW),
                buf[ny + nc:ny + 2 * nc].astype(np.int32).reshape(CH, CW))

    def _transform_host(self, picture: Picture):
        from vc2tpu.pipeline import host_synth

        cfg = self.cfg

        def pad(p, target):
            ph, pw = target
            h, w = p.shape
            if (h, w) == (ph, pw):
                return np.asarray(p, np.int32)
            return np.pad(np.asarray(p, np.int32),
                          ((0, ph - h), (0, pw - w)), mode="edge")

        return tuple(host_synth.dwt_plane_host(pad(p, t), cfg.kernel,
                                               cfg.wavelet_depth)
                     for p, t in ((picture.y, self.geo.padded_luma),
                                  (picture.c1, self.geo.padded_chroma),
                                  (picture.c2, self.geo.padded_chroma)))

    def _transform_mesh(self, picture: Picture):
        """Row-band sharded analysis DWT (halo-exchange forward), or None
        when the padded plane rows do not divide over the mesh."""
        import sys

        from vc2tpu.shard.halo import sharded_forward_plane

        n = self._mesh.shape["space"]
        ts = 1 << self.cfg.wavelet_depth
        pads = (self.geo.padded_luma, self.geo.padded_chroma,
                self.geo.padded_chroma)
        for (rows, _) in pads:
            if rows % n or (rows // n) % ts:
                if not self._mesh_inert_logged:
                    self._mesh_inert_logged = True
                    print(f"--mesh: LD plane of {rows} rows does not divide "
                          f"over {n} shards in units of {ts}; analysing "
                          "single-chip", file=sys.stderr)
                return None

        def pad(p, target):
            ph, pw = target
            h, w = p.shape
            if (h, w) == (ph, pw):
                return np.asarray(p, np.int32)
            return np.pad(np.asarray(p, np.int32),
                          ((0, ph - h), (0, pw - w)), mode="edge")

        return tuple(
            np.ascontiguousarray(np.asarray(sharded_forward_plane(
                pad(p, t), self._mesh, self.cfg.kernel,
                self.cfg.wavelet_depth)))
            for p, t in ((picture.y, pads[0]), (picture.c1, pads[1]),
                         (picture.c2, pads[2])))

    def _transform(self, picture: Picture):
        import os
        import time

        if self._mesh is not None:
            res = self._transform_mesh(picture)
            if res is not None:
                return res
        if self._route is None:
            mode = os.environ.get("VC2TPU_ENCODE_ROUTE", "auto")
            if mode in ("device", "host"):
                self._route = mode
            else:
                t0 = time.perf_counter()
                res = self._transform_host(picture)
                host_t = time.perf_counter() - t0
                try:
                    from vc2tpu.cli.decode_stream import Decoder

                    (H, W), (CH, CW) = (self.geo.padded_luma,
                                        self.geo.padded_chroma)
                    # the probe caches measured values itself (keyed by
                    # size)
                    dev_est = Decoder(sink=None)._probe_link_seconds(
                        2 * (H * W + 2 * CH * CW))
                except Exception:
                    dev_est = float("inf")
                self._route = "host" if host_t < dev_est else "device"
                return res
        if self._route == "host":
            return self._transform_host(picture)
        return self._transform_device(picture)

    def decode_inprocess(self, enc: EncodedPicture, geometry: PictureGeometry,
                         ) -> Picture:
        cfg = self.cfg
        t = ld_dequantise_picture(enc.quantised, enc.q_indices.ravel(),
                                  self.qm_block_y, self.qm_block_c,
                                  self.geo, cfg.wavelet_depth)
        return lifting.inverse_picture(t, cfg.kernel, cfg.wavelet_depth, geometry)


@functools.lru_cache(maxsize=None)
def _ld_lane_tables(slice_h: int, slice_w: int, depth: int, plane_w: int,
                    qm_key: tuple):
    """(qm_lane, off_plane, off_ll) in serialisation (perm) order:
    off_plane is the lane's plane offset relative to the slice origin,
    off_ll the LL lane's offset in the compact LL grid relative to the
    slice's LL origin (the first nLL lanes of the order are LL)."""
    perm, band = layout.lane_order(slice_h, slice_w, depth)
    qm_lane = np.ascontiguousarray(
        np.asarray(qm_key, np.int32)[band])
    by, bx = perm // slice_w, perm % slice_w
    off_plane = np.ascontiguousarray((by * plane_w + bx).astype(np.int32))
    ts = 1 << depth
    llw = plane_w // ts
    nll = (slice_h // ts) * (slice_w // ts)
    off_ll = np.ascontiguousarray(
        ((by[:nll] // ts) * llw + bx[:nll] // ts).astype(np.int32))
    return qm_lane, off_plane, off_ll


def ld_decode_to_transform_host(payload: np.ndarray, slice_sizes, geo,
                                depth: int, qmatrix, qm_block_y, qm_block_c,
                                chroma_format, start: int = 0):
    """Fused native LD decode: payload bytes -> (q_indices, in-place
    transform Picture) with no intermediate lane buffers — bounded gang
    VLC decode + dequantise straight into the planes, then the LL
    prediction recurrence from the compact quantised-LL grids (the LD
    twin of host_synth.synthesise_payload_to_words_host's head;
    reference decode tail: DecodeStream.cpp:289-450)."""
    ts = 1 << depth
    H, W = geo.padded_luma
    CH, CW = geo.padded_chroma
    sh, sw = geo.luma_slice
    csh, csw = geo.chroma_slice
    qm_key = tuple(int(v) for v in qmatrix)
    qly, oply, olly = _ld_lane_tables(sh, sw, depth, W, qm_key)
    qlc, oplc, ollc = _ld_lane_tables(csh, csw, depth, CW, qm_key)
    n = geo.n_slices
    ty = np.empty((H, W), np.int32)
    tu = np.empty((CH, CW), np.int32)
    tv = np.empty((CH, CW), np.int32)
    llqy = np.empty((H // ts, W // ts), np.int32)
    llqu = np.empty((CH // ts, CW // ts), np.int32)
    llqv = np.empty((CH // ts, CW // ts), np.int32)
    q = np.empty(n, np.int32)
    native.ld_unpack_dequant(
        payload, start, np.ascontiguousarray(slice_sizes, np.int32),
        geo.y_slices, geo.x_slices, ts,
        W, qly, oply, olly, sh * sw, sh, sw,
        CW, qlc, oplc, ollc, csh * csw, csh, csw,
        q, ty, tu, tv, llqy, llqu, llqv)
    native.ld_ll_dequantise(llqy, geo.y_slices, geo.x_slices, ts, sh, sw,
                            qm_block_y, q, ty)
    native.ld_ll_dequantise(llqu, geo.y_slices, geo.x_slices, ts, csh, csw,
                            qm_block_c, q, tu)
    native.ld_ll_dequantise(llqv, geo.y_slices, geo.x_slices, ts, csh, csw,
                            qm_block_c, q, tv)
    return q, Picture(ty, tu, tv, chroma_format)


def ld_dequantise_picture(quantised: Picture, q_indices: np.ndarray,
                          qm_block_y: np.ndarray, qm_block_c: np.ndarray,
                          geo, depth: int) -> Picture:
    ts = 1 << depth
    H, W = quantised.y.shape
    CH, CW = quantised.c1.shape
    ty = np.zeros((H, W), dtype=np.int32)
    tu = np.zeros((CH, CW), dtype=np.int32)
    tv = np.zeros((CH, CW), dtype=np.int32)
    native.ld_dequantise_plane(np.asarray(quantised.y), H, W, geo.y_slices,
                               geo.x_slices, ts, qm_block_y, q_indices, ty)
    native.ld_dequantise_plane(np.asarray(quantised.c1), CH, CW, geo.y_slices,
                               geo.x_slices, ts, qm_block_c, q_indices, tu)
    native.ld_dequantise_plane(np.asarray(quantised.c2), CH, CW, geo.y_slices,
                               geo.x_slices, ts, qm_block_c, q_indices, tv)
    return Picture(ty, tu, tv, quantised.chroma_format)
