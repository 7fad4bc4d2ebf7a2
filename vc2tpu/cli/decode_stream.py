"""DecodeStream-compatible CLI: VC-2 stream -> planar file.

Data-unit dispatch loop mirroring /root/reference/src/DecodeStream/
DecodeStream.cpp:205-981: resync, sequence-header state, LD/HQ pictures,
fragment reassembly, aux/padding skip, interlaced field pairing, signal
clip, and the TRANSFORM / QUANTISED / INDICES / DECODED tap outputs.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

from vc2tpu.core.config import DecOutput, PictureGeometry
from vc2tpu.core.picture import Picture
from vc2tpu.core.planario import SampleFormat, write_picture
from vc2tpu.pipeline import host_synth
from vc2tpu.pipeline.decoder import (synthesise_lanes,
                                     synthesise_payload_to_words,
                                     synthesise_to_words,
                                     synthesise_transform_to_words)
from vc2tpu.pipeline.encoder import SliceGeometry
from vc2tpu.pipeline import ld as ld_pipeline
from vc2tpu.slices import layout
from vc2tpu.slices.hq import decode_hq_slices
from vc2tpu.slices.ld import decode_ld_slices
from vc2tpu.stream.dataunit import DataUnitType, StreamReader
from vc2tpu.wavelet import matrices


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vc2tpu-decode",
        description="Decodes a VC-2 stream to an uncompressed planar file")
    p.add_argument("inFile")
    p.add_argument("outFile")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-o", "--output", default="Decoded",
                   choices=[o.value for o in DecOutput])
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a jax.profiler trace of the run to DIR "
                        "(view with TensorBoard / xprof)")
    p.add_argument("--mesh", metavar="DxS", default=None,
                   help="decode on a DxS device mesh (row-band spatial "
                        "parallelism over the S axis): each shard entropy-"
                        "unpacks its own slice run on device, then dequant + "
                        "halo-exchange synthesis under the same shard_map; "
                        "bit-exact vs single-chip")
    return p


def _geometry(hdr, depth: int) -> tuple[PictureGeometry, SliceGeometry, int]:
    pic_h = hdr.height // 2 if hdr.interlace else hdr.height
    padded_h = matrices.padded_size(pic_h, depth)
    padded_w = matrices.padded_size(hdr.width, depth)
    return pic_h, padded_h, padded_w


@dataclasses.dataclass
class _FragState:
    """Per-picture fragment reassembly (reference FragmentedPictureData,
    DecodeStream.cpp:62-101)."""

    preamble: object
    payload_parts: dict            # first-slice-index -> bytes
    slices_decoded: int = 0


class _FragmentDecodeError(Exception):
    """The fragment unit itself was complete but the assembled picture
    failed to decode — a deterministic failure that growing the read
    window cannot fix, so the dispatch loop must skip, not retry."""


def _fetch_bytes_estimate(out_geom: PictureGeometry, hdr) -> int:
    """Bytes the device route would fetch per frame (10-bit video packs
    3 samples/uint32 on device; otherwise one word per sample)."""
    samples = (out_geom.luma_height * out_geom.luma_width
               + 2 * out_geom.chroma_height * out_geom.chroma_width)
    if hdr.bitdepth == 10:
        return 4 * ((samples + 2) // 3)
    return samples * (1 if hdr.bitdepth <= 8 else 2)


def _format_words_host(y, c1, c2, bitdepth: int):
    """Clip + offset-binary + MSB-justify + big-endian format of decoded
    planes into ONE flat sample-word buffer, exactly as the device tail's
    fmt() (pipeline/decoder._synthesis_bytes_fn) produces — so the mesh
    route's bytes are identical to every other route's."""
    zero = 1 << (bitdepth - 1)

    def fmt(p):
        v = np.clip(p, -zero, zero - 1) + zero
        if bitdepth <= 8:
            return v.astype(np.uint8).ravel()
        v = (v << (16 - bitdepth)).astype(np.uint16)
        return ((v << 8) | (v >> 8)).ravel()          # to big-endian

    words = np.concatenate([fmt(y), fmt(c1), fmt(c2)])
    return words, lambda a: a.tobytes()


class Decoder:
    """Stateful stream decoder usable as a library (the CLI drives it)."""

    def __init__(self, output: DecOutput = DecOutput.DECODED, verbose=False,
                 sink=None, route: str | None = None, mesh=None):
        self.output = output
        self.verbose = verbose
        self.sink = sink
        self.hdr = None
        self._major_version = 0
        self.pic = 0
        self.frame = 0
        self.frags: dict[int, _FragState] = {}
        self.frames_out = 0
        self._pending = []            # FIFO of (device words, post) in flight
        self._depth = 3               # dispatches in flight before blocking
        self._first_words = None      # formatted first field (interlace)
        self._first_picnum = None     # picture number of the buffered field
        self._field_parity = None     # picnum parity of FIRST fields
        self._cur_picnum = 0          # picture number being decoded
        self._combined = None         # combined coefficient buffer (HQ)
        self._widths = None           # fixed-pack widths from the unpack
        self._fused = None            # (payload, dstart, cbytes) lazy route
        self._scan_end = None         # slice-chain end from the lazy scan
        self._dev_payload = None      # (payload, cbytes, start) device route
        # device route: entropy-unpack on chip (ship the compressed payload,
        # not host-decoded coefficients) unless explicitly disabled
        self._device_unpack = os.environ.get("VC2TPU_DEVICE_UNPACK",
                                             "1") != "0"
        # Synthesis route: the decoded-output tail runs on the device (one
        # narrow H2D + fused dequant/IDWT/format + one D2H fetch) or on the
        # native host engine (host_synth) — for decode the host already holds
        # all information, so when the device->host fetch of the output costs
        # more than one CPU core's synthesis the device route only adds time.
        # 'auto' times the first frame's host synthesis against a measured
        # fetch probe and commits; VC2TPU_DECODE_ROUTE=device|host overrides.
        self._route_mode = (route or
                            os.environ.get("VC2TPU_DECODE_ROUTE", "auto"))
        self._route = (self._route_mode
                       if self._route_mode in ("device", "host") else None)
        self._host_probe_ts: list = []   # auto-route host-synth samples
        if self._route != "device" and not host_synth.available():
            self._route = "device"
        # --mesh DxS: multi-chip row-band synthesis (spatial parallelism
        # over the ``space`` axis; reference decode loop being paralleled:
        # /root/reference/src/DecodeStream/DecodeStream.cpp:205-981).
        # "DxS" string or a ready jax.sharding.Mesh. Built eagerly so a
        # misconfigured mesh fails fast instead of skipping every picture.
        self._mesh_obj = None
        self._sdec_cache: dict = {}
        if mesh is not None:
            if isinstance(mesh, str):
                from vc2tpu.shard.mesh import make_mesh

                d, s = (int(v) for v in mesh.lower().split("x"))
                self._mesh_obj = make_mesh(data=d, space=s)
            else:
                self._mesh_obj = mesh
            self._route = "mesh"

    def log(self, msg):
        if self.verbose:
            print(msg, file=sys.stderr)

    # --- pipelined output: device->host copy overlaps next picture's host
    # work; every write flushes the previous frame first to keep byte order ---

    def _flush(self, keep: int = 0):
        while len(self._pending) > keep:
            words, post = self._pending.pop(0)
            out = post(np.asarray(words))
            if isinstance(out, bytes):
                out = [out]
            for chunk in out:
                self.sink.write(chunk)
                self.frames_out += 1

    def _write(self, data: bytes):
        self._flush()
        self.sink.write(data)

    # --- adaptive synthesis routing ---

    _probe_cache: dict = {}           # process-wide: nbytes -> seconds

    def _probe_link_seconds(self, nbytes: int) -> float:
        """Measured device->host fetch time for an ``nbytes`` buffer (the
        device route's per-frame transfer cost). Two reps, min; cached
        process-wide — the link does not change between streams. Brings up
        the backend if nothing in the process has used it yet."""
        cached = Decoder._probe_cache.get(nbytes)
        if cached is not None:
            return cached
        import jax.numpy as jnp

        n = max(nbytes // 4, 1)
        best = float("inf")
        for i in range(2):
            a = (jnp.zeros((n,), jnp.uint32) + np.uint32(i)).block_until_ready()
            t0 = time.perf_counter()
            np.asarray(a)
            best = min(best, time.perf_counter() - t0)
        Decoder._probe_cache[nbytes] = best
        return best

    def _auto_route(self, host_fn, out_bytes: int):
        """Time this frame's host synthesis against a fetch probe, commit the
        route, and return the (already computed) host result.

        The fetch probe is a min-of-2 warm measurement, so a single COLD
        host frame (first-call page-ins, lru table builds, a transient CPU
        spike) is not a fair opponent: commit on the first frame only when
        the HOST wins decisively (host < link/3 — a cold host sample can
        only understate the host, so a decisive host win is trustworthy,
        while an apparent decisive DEVICE win may be the cold-frame
        artifact); otherwise time a second host frame and compare the min,
        so one borderline cold frame cannot lock a stream onto the slower
        route."""
        t0 = time.perf_counter()
        res = host_fn()
        self._host_probe_ts.append(time.perf_counter() - t0)
        try:
            dev_est = self._probe_link_seconds(out_bytes)
        except Exception:
            dev_est = float("inf")
        best = min(self._host_probe_ts)
        decisive = len(self._host_probe_ts) >= 2 or best < dev_est / 3
        if decisive:
            self._route = "host" if best < dev_est else "device"
            self.log(f"decode route: host synth {best * 1e3:.0f} ms/frame "
                     f"(best of {len(self._host_probe_ts)}) vs device fetch "
                     f"{dev_est * 1e3:.0f} ms -> {self._route}")
        return res

    def _emit_words(self, words, post):
        """Fast decoded-output path: ``words`` is the device buffer of
        formatted output samples for one progressive frame or one field."""
        hdr = self.hdr
        if hdr.interlace:
            # Field pairing is by picture number, not arrival order: losing
            # one field (corrupt or missing) must not pair every later frame
            # from mismatched fields. First fields carry the parity of the
            # first field seen in the stream; a buffered first field is only
            # paired with picture number first+1 (mod 2^32).
            picnum = self._cur_picnum
            if (self.pic == 1
                    and picnum != ((self._first_picnum + 1) & 0xFFFFFFFF)):
                self.log(f"Dropping stale first field {self._first_picnum} "
                         f"(next decoded picture is {picnum})")
                self.pic = 0
                self._first_words = None
            if self.pic == 0:
                if self._field_parity is None:
                    self._field_parity = picnum & 1
                if (picnum & 1) != self._field_parity:
                    self.log(f"Dropping second field {picnum} whose first "
                             "field was not decoded")
                    return
                self._first_words = (words, post)
                self._first_picnum = picnum
                self.pic = 1
                return
            self.pic = 0
            # expand each field to wire bytes (post applies e.g. the 10-bit
            # unpack of a packed device fetch), then interleave rows as
            # opaque wire elements
            elem = np.uint8 if hdr.bitdepth == 8 else np.uint16
            w1, p1 = self._first_words
            first = np.frombuffer(p1(np.asarray(w1)), elem)
            second = np.frombuffer(post(np.asarray(words)), elem)
            self._first_words = None
            top, bottom = ((first, second) if hdr.top_field_first
                           else (second, first))
            g = PictureGeometry.of(hdr.height // 2, hdr.width,
                                   hdr.chroma_format)
            sizes = (g.luma_height * g.luma_width,
                     g.chroma_height * g.chroma_width,
                     g.chroma_height * g.chroma_width)
            widths = (g.luma_width, g.chroma_width, g.chroma_width)
            parts = []
            off = 0
            for n, w in zip(sizes, widths):
                t = top[off:off + n].reshape(-1, w)
                b = bottom[off:off + n].reshape(-1, w)
                parts.append(np.stack([t, b], axis=1).reshape(-1))
                off += n
            self._write(np.concatenate(parts).tobytes())
            self.frame += 1
            self.frames_out += 1
            return
        self._flush(keep=self._depth - 1)
        self._pending.append((words, post))
        self.frame += 1

    # --- multi-chip synthesis (--mesh) ---

    def _sharded_decoder(self, pre, geo):
        """ShardedDecoder for this preamble's geometry (cached per stream
        geometry), or None when y_slices does not divide over the mesh's
        ``space`` axis (single-chip fallback, logged once)."""
        key = (pre.wavelet_kernel, pre.depth, geo)
        if key in self._sdec_cache:
            return self._sdec_cache[key]
        from vc2tpu.pipeline.sharded import ShardedDecoder

        sdec = None
        space = self._mesh_obj.shape["space"]
        if geo.y_slices % space == 0:
            sdec = ShardedDecoder(pre.wavelet_kernel, pre.depth, geo,
                                  self._mesh_obj)
        else:
            print(f"mesh decode: {geo.y_slices} slice rows do not divide "
                  f"over {space} shards; using the single-chip route",
                  file=sys.stderr)
        self._sdec_cache[key] = sdec
        return sdec

    def _ld_mesh_synthesis(self, transform, pre, out_geom):
        """Row-band sharded LD synthesis: halo-exchange IDWT of the
        host-dequantised transform planes over the ``space`` axis — the LD
        analogue of the HQ mesh route (the predictive dequant recurrence
        stays on the host, as in the single-chip paths). Returns
        (words, post) or None when the padded plane rows do not divide
        over the mesh (single-chip fallback, logged once)."""
        from vc2tpu.shard.halo import sharded_inverse_plane

        mesh = self._mesh_obj
        n = mesh.shape["space"]
        ts = 1 << pre.depth
        planes = (transform.y, transform.c1, transform.c2)
        for p in planes:
            rows = p.shape[0]
            if rows % n or (rows // n) % ts:
                if not getattr(self, "_mesh_inert_logged", False):
                    self._mesh_inert_logged = True
                    print(f"--mesh: LD plane of {rows} rows does not divide "
                          f"over {n} shards in units of {ts}; decoding "
                          "single-chip", file=sys.stderr)
                return None
        y, c1, c2 = (np.asarray(sharded_inverse_plane(
            np.asarray(p, np.int32), mesh, pre.wavelet_kernel, pre.depth))
            for p in planes)
        return _format_words_host(
            y[:out_geom.luma_height, :out_geom.luma_width],
            c1[:out_geom.chroma_height, :out_geom.chroma_width],
            c2[:out_geom.chroma_height, :out_geom.chroma_width],
            self.hdr.bitdepth)

    # --- picture decode core (shared by whole pictures and fragments) ---

    def _decode_picture_payload(self, pre, payload: np.ndarray, hq: bool,
                                start: int = 0):
        hdr = self.hdr
        depth = pre.depth
        self._combined = None
        self._widths = None
        pic_h, padded_h, padded_w = _geometry(hdr, depth)
        self._ld_transform = None
        self._ld_dev_words = None
        from vc2tpu.core.config import chroma_dims

        pch, pcw = chroma_dims(padded_h, padded_w, hdr.chroma_format)
        ys, xs = pre.slices_y, pre.slices_x
        geo = SliceGeometry(ys, xs, (padded_h, padded_w), (pch, pcw),
                            (padded_h // ys, padded_w // xs),
                            (pch // ys, pcw // xs))
        Ly = geo.luma_slice[0] * geo.luma_slice[1]
        Lc = geo.chroma_slice[0] * geo.chroma_slice[1]
        self._fused = None
        self._scan_end = None
        self._dev_payload = None
        if hq:
            if (self.output == DecOutput.DECODED
                    and self._route not in ("device", "mesh")
                    and host_synth.available()):
                # host synthesis route: skip the lane decode — the fused
                # native tail decodes the payload straight into the
                # dequantised plane (host_synth.synthesise_payload_to_words)
                from vc2tpu.slices.hq import scan_hq_slice_offsets

                q_idx, dstart, cbytes, _end = scan_hq_slice_offsets(
                    payload, geo.n_slices, pre.slice_prefix,
                    pre.slice_size_scalar, start)
                self._fused = (payload, dstart, cbytes)
                self._scan_end = int(_end)
                self._combined = None
                self._widths = None
                return geo, pic_h, q_idx, None, None, None
            if (self.output == DecOutput.DECODED and self._device_unpack
                    and (self._route == "device"
                         or (self._route == "mesh"
                             and self._sharded_decoder(pre, geo)
                             is not None))):
                # full on-chip decode: scan the slice chain only and ship
                # the compressed payload — the entropy unpack runs on device
                # (vlc/device_unpack.py; per shard under shard_map on the
                # mesh route), then dequant+IDWT+format
                from vc2tpu.pipeline.decoder import _bucket_bytes
                from vc2tpu.slices.hq import scan_hq_slice_offsets
                from vc2tpu.vlc import device_unpack

                q_idx, dstart, cbytes, _end = scan_hq_slice_offsets(
                    payload, geo.n_slices, pre.slice_prefix,
                    pre.slice_size_scalar, start)
                wc = tuple(device_unpack.window_words(
                    _bucket_bytes(int(cbytes[c].max(initial=0))),
                    (Ly, Lc, Lc)[c]) for c in range(3))
                n_est = geo.n_slices
                if self._route == "mesh":
                    n_est //= self._mesh_obj.shape["space"]
                if (device_unpack.block_bytes_estimate(n_est, wc)
                        <= (1 << 28)):
                    self._dev_payload = (payload, dstart, cbytes, start)
                    return geo, pic_h, q_idx, None, None, None
                # pathologically skewed slice sizes would blow the window
                # block's memory: host-unpack device path below instead
            data = decode_hq_slices(payload, geo.n_slices, pre.slice_prefix,
                                    pre.slice_size_scalar, (Ly, Lc, Lc),
                                    start=start)
            q_idx, (ly, lu, lv) = data.q_indices, data.lanes
            self._combined = data.combined
            self._widths = data.widths
        else:
            # The preamble's slice_bytes rational already carries the bytes
            # of THIS picture (the encoder rationalises the per-FIELD byte
            # count when interlaced, EncodeStream.cpp:413) — do NOT halve
            # again. The reference decoder does halve a second time
            # (DecodeStream.cpp:312 + :335) and therefore desyncs on its
            # own encoder's LD interlaced output ("Read bytes do not match
            # expected parse_info_header"); deliberate deviation, see
            # tests/test_golden.py::test_ld_interlaced_reference_defect.
            picture_bytes = (pre.slice_bytes_numerator * ys * xs
                             // pre.slice_bytes_denominator)
            sizes = layout.slice_bytes_map(ys, xs, picture_bytes, 1).ravel()
            if (self.output == DecOutput.DECODED and self._route == "mesh"
                    and self._device_unpack
                    and ld_pipeline.native is not None):
                # LD mesh route with per-shard on-device body unpack: only
                # the header scan + sequential LL DC recurrence stay host
                # (the HQ mesh route's LD counterpart)
                sdec = self._sharded_decoder(pre, geo)
                if sdec is not None:
                    qmatrix = matrices.quant_matrix(pre.wavelet_kernel,
                                                    pre.depth)
                    qm_block_y = ld_pipeline._qm_block(*geo.luma_slice,
                                                       pre.depth, qmatrix)
                    qm_block_c = ld_pipeline._qm_block(*geo.chroma_slice,
                                                       pre.depth, qmatrix)
                    res = sdec.decode_ld_payload_device(
                        payload, sizes, qm_block_y, qm_block_c, start=start)
                    if res is not None:
                        q_idx, (y, c1, c2) = res
                        out_geom = PictureGeometry.of(pic_h, hdr.width,
                                                      hdr.chroma_format)
                        self._ld_dev_words = _format_words_host(
                            y[:out_geom.luma_height, :out_geom.luma_width],
                            c1[:out_geom.chroma_height,
                               :out_geom.chroma_width],
                            c2[:out_geom.chroma_height,
                               :out_geom.chroma_width],
                            hdr.bitdepth)
                        return geo, pic_h, q_idx, None, None, None
                # incompatible mesh geometry / skewed sizes: host-dequant
                # routes below (the halo-IDWT mesh path still applies)
            if (self.output == DecOutput.DECODED and self._route == "device"
                    and self._device_unpack
                    and ld_pipeline.native is not None):
                # full on-chip LD decode: the body entropy unpack, dequant,
                # IDWT and formatting run on device; only the sequential
                # LL DC-prediction recurrence stays host (small grids)
                from vc2tpu.pipeline.decoder import \
                    synthesise_ld_payload_to_words

                qmatrix = matrices.quant_matrix(pre.wavelet_kernel,
                                                pre.depth)
                qm_block_y = ld_pipeline._qm_block(*geo.luma_slice,
                                                   pre.depth, qmatrix)
                qm_block_c = ld_pipeline._qm_block(*geo.chroma_slice,
                                                   pre.depth, qmatrix)
                out_geom = PictureGeometry.of(pic_h, hdr.width,
                                              hdr.chroma_format)
                q_idx, wp = synthesise_ld_payload_to_words(
                    payload, sizes, qmatrix, pre.wavelet_kernel, pre.depth,
                    geo, out_geom, hdr.bitdepth, qm_block_y, qm_block_c,
                    start=start, allow_pack=True)
                if wp is not None:
                    self._ld_dev_words = wp
                    return geo, pic_h, q_idx, None, None, None
                # pathologically skewed sizes: plane route below instead
            if (self.output in (DecOutput.DECODED, DecOutput.TRANSFORM)
                    and self._route not in ("device", "mesh")
                    and ld_pipeline.native is not None):
                # fused native LD decode: bounded gang VLC + dequant
                # straight into the transform planes (host route)
                qmatrix = matrices.quant_matrix(pre.wavelet_kernel,
                                                pre.depth)
                qm_block_y = ld_pipeline._qm_block(*geo.luma_slice,
                                                   pre.depth, qmatrix)
                qm_block_c = ld_pipeline._qm_block(*geo.chroma_slice,
                                                   pre.depth, qmatrix)
                q_idx, transform = ld_pipeline.ld_decode_to_transform_host(
                    payload, sizes, geo, pre.depth, qmatrix, qm_block_y,
                    qm_block_c, hdr.chroma_format, start=start)
                self._ld_transform = transform
                return geo, pic_h, q_idx, None, None, None
            q_idx, ly, lu, lv, _ = decode_ld_slices(payload, sizes, (Ly, Lc),
                                                    start=start)
        return geo, pic_h, q_idx, ly, lu, lv

    def _finish_picture(self, pre, geo, pic_h, q_idx, ly, lu, lv, hq: bool):
        hdr = self.hdr
        qmatrix = matrices.quant_matrix(pre.wavelet_kernel, pre.depth)
        if self.output == DecOutput.INDICES:
            self.sink.write(q_idx.astype(np.uint8).tobytes())
            return
        sig_fmt = SampleFormat(word_width=4, signed=True, offset=False)
        if self.output == DecOutput.QUANTISED:
            pic = Picture(
                layout.lanes_to_plane(ly, geo.y_slices, geo.x_slices,
                                      *geo.luma_slice, pre.depth),
                layout.lanes_to_plane(lu, geo.y_slices, geo.x_slices,
                                      *geo.chroma_slice, pre.depth),
                layout.lanes_to_plane(lv, geo.y_slices, geo.x_slices,
                                      *geo.chroma_slice, pre.depth),
                hdr.chroma_format)
            write_picture(self.sink, pic, sig_fmt)
            return
        out_geom = PictureGeometry.of(pic_h, hdr.width, hdr.chroma_format)
        if self._route == "mesh" and self.output != DecOutput.DECODED:
            # tell the user --mesh is not in effect (mirrors the
            # incompatible-geometry fallback notice in _sharded_decoder)
            if not getattr(self, "_mesh_inert_logged", False):
                self._mesh_inert_logged = True
                print(f"--mesh: no sharded path for output mode "
                      f"{self.output.value}; decoding single-chip",
                      file=sys.stderr)
        if hq and self._route == "mesh" and self.output == DecOutput.DECODED:
            sdec = self._sharded_decoder(pre, geo)
            if sdec is not None:
                if self._dev_payload is not None:
                    # per-shard on-device entropy unpack (no host VLC work)
                    payload_d, dstart, cbytes, _start_d = self._dev_payload
                    self._dev_payload = None
                    y, c1, c2 = sdec.decode_payload_device(
                        payload_d, q_idx, dstart, cbytes)
                else:
                    y, c1, c2 = sdec.synthesise(q_idx, ly, lu, lv)
                words, post = _format_words_host(
                    y[:out_geom.luma_height, :out_geom.luma_width],
                    c1[:out_geom.chroma_height, :out_geom.chroma_width],
                    c2[:out_geom.chroma_height, :out_geom.chroma_width],
                    hdr.bitdepth)
                self._emit_words(words, post)
                return
            # geometry incompatible with the mesh: single-chip fallback below
        if hq:
            if self.output == DecOutput.TRANSFORM:
                pic = synthesise_lanes(ly, lu, lv, q_idx, qmatrix,
                                       pre.wavelet_kernel, pre.depth, geo,
                                       out_geom, hdr.chroma_format,
                                       dequant_only=True)
                write_picture(self.sink, pic, sig_fmt)
                return
            # DECODED: fused synthesis tail (dequant+IDWT+clip+format) on the
            # adaptively chosen route — device (one narrow H2D + one packed
            # D2H, async) or native host (no device traffic at all)
            if self._dev_payload is not None:
                payload_d, dstart, cbytes, start_d = self._dev_payload
                self._dev_payload = None
                words, post = synthesise_payload_to_words(
                    payload_d, q_idx, cbytes, qmatrix, pre.wavelet_kernel,
                    pre.depth, geo, out_geom, hdr.bitdepth,
                    pre.slice_prefix, start=start_d,
                    allow_pack=True)
                self._emit_words(words, post)
                return
            if self._fused is not None:
                payload_f, dstart, cbytes = self._fused
                self._fused = None

                def host_fn():
                    return host_synth.synthesise_payload_to_words_host(
                        payload_f, q_idx, dstart, cbytes, qmatrix,
                        pre.wavelet_kernel, pre.depth, geo, out_geom,
                        hdr.bitdepth)

                if self._route is None:
                    words, post = self._auto_route(
                        host_fn, _fetch_bytes_estimate(out_geom, hdr))
                else:
                    words, post = host_fn()
                self._emit_words(words, post)
                return
            combined = self._combined
            if combined is None:
                combined = np.concatenate(
                    [np.asarray(a).ravel() for a in (ly, lu, lv)]).astype(np.int32)
            can_host = (host_synth.available()
                        and isinstance(combined, np.ndarray)
                        and combined.dtype == np.int16)
            if self._route is None and can_host:
                words, post = self._auto_route(
                    lambda: host_synth.synthesise_to_words_host(
                        combined, q_idx, qmatrix, pre.wavelet_kernel,
                        pre.depth, geo, out_geom, hdr.bitdepth),
                    _fetch_bytes_estimate(out_geom, hdr))
            elif self._route == "host" and can_host:
                words, post = host_synth.synthesise_to_words_host(
                    combined, q_idx, qmatrix, pre.wavelet_kernel, pre.depth,
                    geo, out_geom, hdr.bitdepth)
            else:
                words, post = synthesise_to_words(
                    combined, q_idx, qmatrix, pre.wavelet_kernel, pre.depth,
                    geo, out_geom, hdr.bitdepth,
                    allow_pack=True, widths=self._widths)
            self._emit_words(words, post)
            return
        else:
            if getattr(self, "_ld_dev_words", None) is not None:
                wp = self._ld_dev_words             # full on-chip LD decode
                self._ld_dev_words = None
                self._emit_words(*wp)
                return
            if self._ld_transform is not None:
                transform = self._ld_transform      # fused native decode
                self._ld_transform = None
            else:
                quantised = Picture(
                    layout.lanes_to_plane(ly, geo.y_slices, geo.x_slices,
                                          *geo.luma_slice, pre.depth),
                    layout.lanes_to_plane(lu, geo.y_slices, geo.x_slices,
                                          *geo.chroma_slice, pre.depth),
                    layout.lanes_to_plane(lv, geo.y_slices, geo.x_slices,
                                          *geo.chroma_slice, pre.depth),
                    hdr.chroma_format)
                qm_block_y = ld_pipeline._qm_block(*geo.luma_slice, pre.depth,
                                                   qmatrix)
                qm_block_c = ld_pipeline._qm_block(*geo.chroma_slice,
                                                   pre.depth, qmatrix)
                transform = ld_pipeline.ld_dequantise_picture(
                    quantised, q_idx, qm_block_y, qm_block_c, geo, pre.depth)
            if self.output == DecOutput.TRANSFORM:
                write_picture(self.sink, transform, sig_fmt)
                return
            if self._route == "mesh" and self.output == DecOutput.DECODED:
                wp = self._ld_mesh_synthesis(transform, pre, out_geom)
                if wp is not None:
                    self._emit_words(*wp)
                    return
            # fused synthesis tail (IDWT + clip + format), adaptively routed
            if self._route is None and host_synth.available():
                fetch_bytes = _fetch_bytes_estimate(out_geom, hdr)
                words, post = self._auto_route(
                    lambda: host_synth.synthesise_transform_to_words_host(
                        transform, pre.wavelet_kernel, pre.depth, out_geom,
                        hdr.bitdepth), fetch_bytes)
            elif self._route == "host":
                words, post = host_synth.synthesise_transform_to_words_host(
                    transform, pre.wavelet_kernel, pre.depth, out_geom,
                    hdr.bitdepth)
            else:
                words, post = synthesise_transform_to_words(
                    transform, pre.wavelet_kernel, pre.depth, out_geom,
                    hdr.bitdepth, allow_pack=True)
            self._emit_words(words, post)
            return

    # --- data unit handlers ---

    def run(self, data: bytes) -> int:
        """Decode a complete in-memory stream (library entry)."""
        import io

        return self.run_stream(io.BytesIO(data))

    def run_stream(self, fp, chunk_bytes: int = 1 << 20) -> int:
        """Incremental decode from a binary file object: memory stays
        O(largest data unit) (a rolling window slides over the input),
        matching the reference's istream loop
        (/root/reference/src/DecodeStream/DecodeStream.cpp:205) instead of
        slurping the stream. Resync, skip-on-corrupt and fragment semantics
        are identical to the in-memory path."""
        window = bytearray()
        eof = False
        self.max_window = 0           # high-water mark (memory-bound tests)

        def fill(n=None) -> bool:
            """Grow the window to >= n bytes (or by one chunk). Returns
            False if EOF prevented reaching the target."""
            nonlocal eof
            while not eof and (n is None or len(window) < n):
                b = fp.read(chunk_bytes if n is None
                            else max(chunk_bytes, n - len(window)))
                if not b:
                    eof = True
                else:
                    window.extend(b)
                    self.max_window = max(self.max_window, len(window))
                if n is None:
                    break
            return n is None or len(window) >= n

        def resync() -> bool:
            """Drop bytes until the window starts at a parse_info prefix."""
            nonlocal window
            while True:
                i = window.find(b"BBCD")
                if i >= 0:
                    del window[:i]
                    return True
                # keep a 3-byte tail (possible partial prefix)
                if len(window) > 3:
                    del window[:-3]
                if eof:
                    return False
                fill()

        def consume(n: int):
            del window[:n]

        def skip(n: int):
            """Discard n bytes of input WITHOUT buffering them (aux/padding
            bodies and corrupt-picture skips can be arbitrarily large)."""
            nonlocal eof
            have = min(n, len(window))
            consume(have)
            left = n - have
            while left > 0 and not eof:
                b = fp.read(min(chunk_bytes, left))
                if not b:
                    eof = True
                    break
                left -= len(b)

        first = True
        while True:
            fill(13)
            if len(window) < 13:
                if not eof:
                    continue
                self._flush()
                self.log("End of data stream reached successfully, exiting.")
                return 0
            rd = StreamReader(bytes(window[:13]))
            rd.major_version = self._major_version
            try:
                du_type, next_off, _prev = rd.read_data_unit()
            except ValueError as exc:
                if not first:
                    # corrupt parse_info: re-lock onto the next 'BBCD' (the
                    # reference binary exits here; dataunitio::synchronise
                    # makes continuing strictly better)
                    print(f"Bad parse info ({exc}); resynchronising",
                          file=sys.stderr)
                consume(1)
                if not resync():
                    self._flush()
                    return 0
                continue
            first = False
            self.log(f"Have read data unit of type: {du_type.value}")
            # pull the declared unit body into the window (headers are small;
            # pictures are one data unit — the window's high-water mark).
            # Cap the prefetch: a corrupt next_parse_offset must not force an
            # unbounded buffer (the picture path grows further on demand)
            if 13 <= next_off < (1 << 30):
                fill(min(next_off, 64 << 20))
            if du_type == DataUnitType.SEQUENCE_HEADER:
                fill(min(max(next_off, 4096), 1 << 20))
                rd = StreamReader(bytes(window))
                rd.r.seek(13)
                try:
                    self.hdr = rd.read_sequence_header()
                    self._major_version = rd.major_version
                except Exception as exc:
                    print(f"Bad sequence header ({exc}); resynchronising",
                          file=sys.stderr)
                    consume(1)
                    if not resync():
                        self._flush()
                        return 0
                    continue
                consume(rd.r.byte_pos)
            elif du_type == DataUnitType.END_OF_SEQUENCE:
                self.log(f"End of Sequence after {self.frame} frames")
                consume(13)
            elif du_type in (DataUnitType.AUXILIARY_DATA,
                             DataUnitType.PADDING_DATA):
                if next_off - 13 < 0:
                    raise ValueError("data length is less than zero.")
                skip(next_off)
            elif du_type in (DataUnitType.HQ_PICTURE, DataUnitType.LD_PICTURE):
                hq = du_type == DataUnitType.HQ_PICTURE
                end = None
                grow_cap = min(max(next_off, 0), 64 << 20) + (64 << 20)
                while True:
                    try:
                        end = self._handle_picture_window(window, hq)
                        break
                    except Exception as exc:
                        # the slice chain may genuinely extend past a lying
                        # next_parse_offset: grow the window and retry (up to
                        # a 64 MB margin) before declaring the picture
                        # corrupt. Retry whenever the window actually grew —
                        # hitting EOF short of the requested target must not
                        # discard a picture whose tail just arrived.
                        before = len(window)
                        if not eof and before < grow_cap:
                            fill(min(before + 8 * chunk_bytes, grow_cap))
                        if len(window) > before:
                            continue
                        print(f"Failed to read {'HQ' if hq else 'LD'} "
                              f"compressed frame ({exc})", file=sys.stderr)
                        # drop any buffered first field: a lost second field
                        # must not pair later fields off-by-one
                        self.pic = 0
                        self._first_words = None
                        break
                if end is not None:
                    consume(end)
                elif next_off >= 13:
                    skip(next_off)
                else:
                    consume(1)
                    if not resync():
                        self._flush()
                        return 0
            elif du_type in (DataUnitType.HQ_FRAGMENT,
                             DataUnitType.LD_FRAGMENT):
                hq = du_type == DataUnitType.HQ_FRAGMENT
                fill(max(min(next_off, 64 << 20), 13 + 4 + 8))
                grow_cap = min(max(next_off, 0), 64 << 20) + (64 << 20)
                while True:
                    rd = StreamReader(bytes(window))
                    rd.major_version = self._major_version
                    rd.r.seek(13)
                    try:
                        end = self._handle_fragment(rd, hq)
                        consume(min(end, len(window)))
                        break
                    except _FragmentDecodeError as exc:
                        # the assembled picture failed to decode — a bigger
                        # window cannot help; skip, and drop any buffered
                        # first field (mirrors the picture failure path)
                        print(f"Failed to decode fragmented picture "
                              f"({exc.args[0]})", file=sys.stderr)
                        self.pic = 0
                        self._first_words = None
                        skip(next_off if next_off >= 13 else 13)
                        break
                    except Exception as exc:
                        # a fragment body may extend past a zero/lying
                        # next_parse_offset: grow the window and retry
                        # (mirrors the picture path) before skipping it
                        before = len(window)
                        if not eof and before < grow_cap:
                            fill(min(before + 8 * chunk_bytes, grow_cap))
                        if len(window) > before:
                            continue
                        print(f"Failed to read fragment ({exc})",
                              file=sys.stderr)
                        skip(next_off if next_off >= 13 else 13)
                        break
            else:
                consume(13)

    def _handle_picture_window(self, window, hq: bool) -> int:
        """Decode one picture data unit sitting at the head of ``window``
        (13-byte parse_info included). Returns the consumed byte count."""
        rd = StreamReader(bytes(window))
        rd.major_version = self._major_version
        rd.r.seek(13)
        self._cur_picnum = rd.read_picture_number()
        pre = rd.read_preamble(hq)
        if self.hdr is None:
            self.log("Cannot decode frame, no previous sequence header!")
            return rd.r.byte_pos
        payload = np.frombuffer(rd.data, dtype=np.uint8)
        if not hq:
            # LD slice sizes are header-determined: check the window holds
            # the whole payload BEFORE decoding (the bounded-region reader
            # would otherwise silently decode zeros past the window; the HQ
            # scan raises on its own)
            ys0 = pre.slices_y
            # per-picture bytes straight from the preamble (no interlace
            # re-halving — see _decode_picture_payload)
            pb = (pre.slice_bytes_numerator * ys0 * pre.slices_x
                  // pre.slice_bytes_denominator)
            need = rd.r.byte_pos + int(layout.slice_bytes_map(
                ys0, pre.slices_x, pb, 1).sum())
            if need > len(rd.data):
                raise ValueError("LD slice payload runs past the window")
        geo, pic_h, q_idx, ly, lu, lv = \
            self._decode_picture_payload(pre, payload, hq,
                                         start=rd.r.byte_pos)
        if hq:
            if self._scan_end is not None:
                end = self._scan_end
            else:
                from vc2tpu.slices.hq import scan_hq_slice_offsets

                _, _, _, end = scan_hq_slice_offsets(
                    payload, geo.n_slices, pre.slice_prefix,
                    pre.slice_size_scalar, rd.r.byte_pos)
        else:
            pb = (pre.slice_bytes_numerator * geo.n_slices
                  // pre.slice_bytes_denominator)
            end = rd.r.byte_pos + int(layout.slice_bytes_map(
                geo.y_slices, geo.x_slices, pb, 1).sum())
        self._finish_picture(pre, geo, pic_h, q_idx, ly, lu, lv, hq)
        return int(end)

    def _handle_fragment(self, rd: StreamReader, hq: bool) -> int:
        """Fragment data unit at the window head; returns consumed bytes."""
        picnum = rd.read_picture_number()
        frag = rd.read_fragment_header()
        if frag.n_slices == 0:
            pre = rd.read_preamble(hq)
            if self.hdr is None:
                self.log("Cannot decode frame, no previous sequence header!")
                return rd.r.byte_pos
            self.frags[picnum] = _FragState(preamble=pre, payload_parts={})
            return rd.r.byte_pos
        body = rd.r.get_raw(frag.data_length)
        if len(body) < frag.data_length:
            raise ValueError("truncated fragment body")
        st = self.frags.get(picnum)
        if st is None:
            self.log("Cannot decode slices as no picture header yet "
                     f"read for picture number {picnum}")
            return rd.r.byte_pos
        first = (frag.slice_offset_y * st.preamble.slices_x
                 + frag.slice_offset_x)
        # idempotent under the dispatch loop's grow-and-retry (and under
        # duplicate fragments): a span already seen must not double-count
        if first not in st.payload_parts:
            st.slices_decoded += frag.n_slices
        st.payload_parts[first] = body
        needed = st.preamble.slices_x * st.preamble.slices_y
        if st.slices_decoded >= needed:
            # the unit is complete from here on: drop the reassembly state
            # first so a decode failure neither leaves half-state behind
            # nor gets retried with a bigger window (it is deterministic)
            del self.frags[picnum]
            payload = b"".join(p for _, p in sorted(st.payload_parts.items()))
            arr = np.frombuffer(payload, dtype=np.uint8)
            try:
                geo, pic_h, q_idx, ly, lu, lv = \
                    self._decode_picture_payload(st.preamble, arr, hq)
                self._cur_picnum = picnum
                self._finish_picture(st.preamble, geo, pic_h, q_idx, ly, lu,
                                     lv, hq)
            except Exception as exc:
                raise _FragmentDecodeError(exc) from exc
        return rd.r.byte_pos


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # a JAX process otherwise reserves most of the card on first use, and
    # `encode_stream ... - | decode_stream -` puts two processes on one card
    os.environ.setdefault("XLA_PYTHON_CLIENT_PREALLOCATE", "false")
    # incremental input: memory stays O(one data unit) regardless of stream
    # length (reference DecodeStream.cpp:205 istream loop)
    fp = sys.stdin.buffer if args.inFile == "-" else open(args.inFile, "rb")
    sink = sys.stdout.buffer if args.outFile == "-" else open(args.outFile, "wb")
    dec = Decoder(output=DecOutput(args.output), verbose=args.verbose,
                  sink=sink, mesh=args.mesh)
    if args.profile:
        import jax

        jax.profiler.start_trace(args.profile)
    try:
        rc = dec.run_stream(fp)
    except Exception as exc:
        print(f"Error: {exc}")
        return 1
    finally:
        if args.profile:
            import jax

            jax.profiler.stop_trace()
    if args.outFile != "-":
        sink.close()
    return rc


if __name__ == "__main__":
    sys.exit(main())
