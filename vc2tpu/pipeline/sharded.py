"""Multi-chip encode/decode over a (data, space) mesh — to stream bytes.

Decomposition (SURVEY.md §2 parallelism table):

* ``data``  — independent frames (intra-only codec);
* ``space`` — row bands of each picture; the DWT exchanges halo rows per
  vertical lifting pass (vc2tpu.shard.halo) over a device ring, everything
  afterwards — RDO, quantisation, VLC entropy packing — is slice-local and
  partitions along the same axis with no further communication (slice rows
  coincide with row bands).

The whole encode step, *including the on-device entropy pack*
(vlc.device_pack.pack_hq_core per shard), runs under one shard_map in the
Mallat band form. Each shard's slice run is contiguous in the picture's
raster slice order, so its locally-assembled payload is a contiguous span
of the final stream. Two host drivers consume it: encode_batch
concatenates the per-shard payloads into EncodedPictures for the ordinary
StreamWriter, and encode_batch_to_fragments STREAMS fragment data units
incrementally — each shard's span is framed and written as its buffer
lands on the host (heads validated first, so retries precede any output),
byte-identical to framing the assembled payload. Reference path being
paralleled: /root/reference/src/Library/src/Slices.cpp:662-694 (slice
serialisation loop) + src/DataUnit.cpp:267-342 (fragment framing).

The decode side (ShardedDecoder / make_sharded_decode_step) scatters
entropy-decoded lanes to shards and runs dequant + halo-exchange synthesis
under shard_map; output equals the single-device pipeline exactly (ints,
asserted with == in tests/test_shard.py and __graft_entry__.dryrun_multichip).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vc2tpu.core.config import EncoderConfig, Mode
from vc2tpu.quant.quantiser import MAX_QINDEX, quant_banded, scale_banded
from vc2tpu.rdo.cbr import cbr_quant_indices
from vc2tpu.slices import layout
from vc2tpu.shard.halo import forward_bands_local, inverse_bands_local
from vc2tpu.vlc import device_pack
from vc2tpu.wavelet import lifting, matrices


def _band_meta(geo, depth):
    _, band_y = layout.lane_order(*geo.luma_slice, depth)
    _, band_c = layout.lane_order(*geo.chroma_slice, depth)
    bs_y = tuple(int(c) for c in np.bincount(band_y))
    bs_c = tuple(int(c) for c in np.bincount(band_c))
    return bs_y, bs_c


def make_sharded_encode_step(cfg: EncoderConfig, mesh: Mesh,
                             cap_local: int | None = None,
                             w32: int | None = None):
    """Build a jitted multi-chip HQ encode step with on-device entropy pack.

    Returns (step_fn, plane_sharding, geo, cap_local, w32).
    step_fn(y, c1, c2, budgets) -> (q_indices (B, N), bufs (B, space*M))
    where M = head_bytes(n_local) + cap_local; each shard's segment holds its
    flags/q_idx/totals head followed by its contiguous payload span.
    Shapes are the padded geometry; y_slices must divide by the ``space``
    extent so slice rows align with row bands.
    """
    from vc2tpu.pipeline.encoder import slice_geometry

    geo = slice_geometry(cfg)
    d = cfg.wavelet_depth
    space = mesh.shape["space"]
    if geo.y_slices % space:
        raise ValueError("y_slices must divide by the space mesh extent")
    qmatrix = matrices.quant_matrix(cfg.kernel, d)
    qm = jnp.asarray(qmatrix.astype(np.int32))
    bs_y, bs_c = _band_meta(geo, d)
    ys_local = geo.y_slices // space
    n_loc = ys_local * geo.x_slices
    cbr = cfg.mode == Mode.HQ_CBR
    w32_max = (cfg.slice_prefix + 4 + 3 * 255 * cfg.slice_scalar + 3) // 4
    if cbr:
        picture_bytes = (cfg.compressed_bytes // 2 if cfg.interlaced
                         else cfg.compressed_bytes)
        budgets_map = layout.slice_bytes_map(
            geo.y_slices, geo.x_slices, picture_bytes, cfg.slice_scalar)
        shard_sums = budgets_map.ravel().reshape(space, n_loc).sum(axis=1)
        if cap_local is None:
            cap_local = int(shard_sums.max()) + n_loc * cfg.slice_prefix
        if w32 is None:
            w32 = min((cfg.slice_prefix + int(budgets_map.max()) + 3) // 4,
                      w32_max)
    else:
        coeffs = n_loc * (geo.luma_slice[0] * geo.luma_slice[1]
                          + 2 * geo.chroma_slice[0] * geo.chroma_slice[1])
        if cap_local is None:
            guess = n_loc * (cfg.slice_prefix + 4) + coeffs // 4
            cap_local = 1 << max(12, int(np.ceil(np.log2(guess))))
        if w32 is None:
            per_slice = 2 * cap_local // max(n_loc, 1) + 16
            w32 = min(1 << int(np.ceil(np.log2(per_slice / 4))), w32_max)
    plane_spec = NamedSharding(mesh, P("data", "space", None))
    budget_spec = NamedSharding(mesh, P("data", "space"))

    def local(y, c1, c2, budgets):
        lanes = []
        for p in (y, c1, c2):
            bands = forward_bands_local(p, cfg.kernel, d, "space")
            lanes.append(lifting.bands_to_lanes(bands, ys_local,
                                                geo.x_slices))
        ly, lu, lv = lanes
        b = ly.shape[0]
        if cbr:
            q_idx = cbr_quant_indices(
                ly.reshape(b * n_loc, -1), lu.reshape(b * n_loc, -1),
                lv.reshape(b * n_loc, -1), qm, bs_y, bs_c,
                budgets.reshape(b * n_loc), cfg.slice_scalar).reshape(b, n_loc)
        else:
            q_idx = jnp.full((b, n_loc), cfg.q_index, dtype=jnp.int32)
        qy = quant_banded(ly, q_idx, qm, bs_y)
        qu = quant_banded(lu, q_idx, qm, bs_c)
        qv = quant_banded(lv, q_idx, qm, bs_c)
        buf = jax.vmap(lambda a, b_, c, q, s: device_pack.pack_hq_core(
            a, b_, c, q, s, prefix=cfg.slice_prefix, scalar=cfg.slice_scalar,
            w32=w32, cap_bytes=cap_local, cbr=cbr))(qy, qu, qv, q_idx,
                                                    budgets)
        return q_idx, buf

    shmap = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("data", "space", None),) * 3 + (P("data", "space"),),
        out_specs=(P("data", "space"), P("data", "space")))

    with mesh:
        step_jit = jax.jit(shmap, in_shardings=(plane_spec,) * 3
                           + (budget_spec,))
    return step_jit, plane_spec, geo, cap_local, w32


class ShardedEncoder:
    """Host driver: pads + shards input frames, runs the sharded encode
    step, and reassembles per-shard payloads into EncodedPicture results
    that feed the ordinary StreamWriter (whole pictures or fragments) —
    byte-identical to the single-chip Encoder."""

    def __init__(self, cfg: EncoderConfig, mesh: Mesh):
        cfg.validate()
        self.cfg = cfg
        self.mesh = mesh
        self.space = mesh.shape["space"]
        self.data = mesh.shape["data"]
        self._build(None, None)
        geo = self.geo
        self.n_loc = geo.n_slices // self.space
        if cfg.mode == Mode.HQ_CBR:
            picture_bytes = (cfg.compressed_bytes // 2 if cfg.interlaced
                             else cfg.compressed_bytes)
            self.slice_budgets = layout.slice_bytes_map(
                geo.y_slices, geo.x_slices, picture_bytes, cfg.slice_scalar)
        else:
            self.slice_budgets = None

    def _build(self, cap_local, w32):
        (self.step, self.plane_spec, self.geo,
         self.cap_local, self.w32) = make_sharded_encode_step(
            self.cfg, self.mesh, cap_local, w32)

    def _pad(self, plane: np.ndarray, target) -> np.ndarray:
        ph, pw = target
        h, w = plane.shape
        if (h, w) == (ph, pw):
            return plane
        return np.pad(plane, ((0, ph - h), (0, pw - w)), mode="edge")

    def _prep(self, pictures):
        geo = self.geo
        B = len(pictures)
        y = np.stack([self._pad(np.asarray(p.y, np.int32), geo.padded_luma)
                      for p in pictures])
        c1 = np.stack([self._pad(np.asarray(p.c1, np.int32), geo.padded_chroma)
                       for p in pictures])
        c2 = np.stack([self._pad(np.asarray(p.c2, np.int32), geo.padded_chroma)
                       for p in pictures])
        if self.slice_budgets is not None:
            budgets = self.slice_budgets.ravel().astype(np.int32)
        else:
            budgets = np.zeros(geo.n_slices, np.int32)
        bud = np.tile(budgets[None, :], (B, 1))
        return y, c1, c2, bud

    def _run_step(self, y, c1, c2, bud):
        with self.mesh:
            return self.step(
                jax.device_put(y, self.plane_spec),
                jax.device_put(c1, self.plane_spec),
                jax.device_put(c2, self.plane_spec),
                jax.device_put(bud, NamedSharding(self.mesh,
                                                  P("data", "space"))))

    def encode_batch(self, pictures):
        """Encode a batch of Pictures (len divisible by the ``data`` extent).
        Returns a list of (q_indices (ys, xs), payload bytes, slice_totals)
        EncodedPicture objects, identical to Encoder.encode_picture's."""
        y, c1, c2, bud = self._prep(pictures)
        while True:
            q_idx, bufs = self._run_step(y, c1, c2, bud)
            out, retry = self._assemble(np.asarray(q_idx), np.asarray(bufs),
                                        pictures)
            if not retry:
                return out
            # capacity / slice-row miss: grow the static buckets and rebuild
            self._build(retry[0], retry[1])

    def _assemble(self, q_idx, bufs, pictures):
        from vc2tpu.pipeline.encoder import EncodedPicture, Encoder

        geo = self.geo
        n_loc = self.n_loc
        head = device_pack.head_bytes(n_loc)
        seg = head + self.cap_local
        out = []
        for b in range(bufs.shape[0]):
            payloads = []
            totals_all = []
            fallback = False
            for s in range(self.space):
                buf = bufs[b, s * seg:(s + 1) * seg]
                flags, q_l, totals, payload = device_pack.unpack_result(
                    buf, n_loc)
                if flags & device_pack.FLAG_W32:
                    w32_max = (self.cfg.slice_prefix + 4
                               + 3 * 255 * self.cfg.slice_scalar + 3) // 4
                    if self.w32 < w32_max:
                        return None, (self.cap_local,
                                      min(self.w32 * 2, w32_max))
                    fallback = True
                    break
                total = int(totals.sum(dtype=np.int64))
                if total > self.cap_local:
                    return None, (1 << int(np.ceil(np.log2(total))), self.w32)
                if flags & device_pack.FLAG_CODE_OVERFLOW:
                    fallback = True
                    break
                if flags & device_pack.FLAG_CBR_FIT:
                    raise ValueError(
                        "SliceIO, HQ CBR mode: Too many bytes for the slice")
                if flags & device_pack.FLAG_SCALAR:
                    raise ValueError(
                        "Slice scalar is too small, consider using a larger "
                        "slice scalar.")
                payloads.append(payload[:total].tobytes())
                totals_all.append(totals.astype(np.int64))
            if fallback:
                # oversized codes: the exact single-chip host path (rare)
                if pictures is None:
                    raise ValueError(
                        "oversized exp-Golomb code in multi-host encode; "
                        "no local pixel data for the host fallback")
                enc = Encoder(self.cfg)
                out.append(enc.encode_picture(pictures[b]))
                continue
            q = q_idx[b].reshape(geo.y_slices, geo.x_slices)
            if (q > MAX_QINDEX).any():
                raise ValueError(
                    "quantization index exceeds maximum implemented value.")
            out.append(EncodedPicture(
                q_indices=q, payload=b"".join(payloads),
                slice_totals=np.concatenate(totals_all)))
        return out, None

    # ---- streaming fragment emission ----------------------------------

    def _check_heads(self, heads):
        """Validate the per-shard result heads (flags / q / totals) BEFORE
        any stream byte is written. Returns (retry, fallback_pictures):
        retry = (cap_local, w32) to rebuild with, or None; fallback is the
        set of batch indices needing the single-chip host path."""
        fallback = set()
        for b, row in enumerate(heads):
            for flags, q_l, totals in row:
                if flags & device_pack.FLAG_W32:
                    w32_max = (self.cfg.slice_prefix + 4
                               + 3 * 255 * self.cfg.slice_scalar + 3) // 4
                    if self.w32 < w32_max:
                        return (self.cap_local,
                                min(self.w32 * 2, w32_max)), None
                    fallback.add(b)
                    continue
                total = int(totals.sum(dtype=np.int64))
                if total > self.cap_local:
                    return (1 << int(np.ceil(np.log2(total))), self.w32), None
                if flags & device_pack.FLAG_CODE_OVERFLOW:
                    fallback.add(b)
                    continue
                if flags & device_pack.FLAG_CBR_FIT:
                    raise ValueError(
                        "SliceIO, HQ CBR mode: Too many bytes for the slice")
                if flags & device_pack.FLAG_SCALAR:
                    raise ValueError(
                        "Slice scalar is too small, consider using a larger "
                        "slice scalar.")
                if (np.asarray(q_l) > MAX_QINDEX).any():
                    raise ValueError(
                        "quantization index exceeds maximum implemented "
                        "value.")
        return None, fallback

    def encode_batch_to_fragments(self, pictures, writer, picture_numbers,
                                  preamble):
        """Run the sharded encode step and stream every picture out as
        fragment data units, feeding each shard's contiguous payload span
        to a FragmentWriter as that shard's buffer lands on the host: the
        small per-shard heads (flags / q / totals) are fetched and
        validated first, so capacity retries and host fallbacks happen
        before any byte reaches the stream, then each payload span is
        fetched in shard order and framed immediately — fragments stream
        out while later shards' device->host copies are still in flight.
        Byte-identical to write_picture over the assembled payload
        (reference framing: /root/reference/src/Library/src/
        DataUnit.cpp:267-342)."""
        y, c1, c2, bud = self._prep(pictures)
        while True:
            q_idx, bufs = self._run_step(y, c1, c2, bud)
            heads, head, seg = self._fetch_heads(bufs, len(pictures))
            retry, fallback = self._check_heads(heads)
            if retry is None:
                break
            self._build(retry[0], retry[1])
        return self._stream_payloads(writer, bufs, heads, head, seg,
                                     fallback, picture_numbers, preamble,
                                     pictures)

    def _fetch_heads(self, bufs, B):
        """Per-(picture, shard) (flags, q, totals) heads; ``bufs`` indexes
        as (B, space*seg) device or host array. All B*space head regions
        come over in ONE gathered transfer: per-(picture, shard) fetches
        would pay B*space device->host round trips for a few hundred bytes
        each."""
        head = device_pack.head_bytes(self.n_loc)
        seg = head + self.cap_local
        idx = (np.arange(self.space)[:, None] * seg
               + np.arange(head)[None, :]).ravel()        # (space*head,)
        # ascontiguousarray: mixed basic+advanced indexing of a host array
        # lands the advanced axis first in memory, and unpack_result views
        # the rows as uint32/int32 (contiguity required); the copy is heads
        # only, a few KB
        all_heads = np.ascontiguousarray(
            np.asarray(bufs[:, idx])).reshape(B, self.space, head)
        heads = [[device_pack.unpack_result(all_heads[b, s], self.n_loc)[:3]
                  for s in range(self.space)] for b in range(B)]
        return heads, head, seg

    def _stream_payloads(self, writer, bufs, heads, head, seg, fallback,
                         picture_numbers, preamble, pictures):
        """Frame + write each picture's fragments, fetching one shard's
        payload span at a time. Returns per-picture q-index arrays."""
        geo = self.geo
        q_out = []
        for b, picnum in enumerate(picture_numbers):
            fw = writer.begin_fragments(picnum, preamble, hq=True)
            if b in fallback:
                # oversized codes: exact single-chip host path (rare)
                from vc2tpu.pipeline.encoder import Encoder

                if pictures is None:
                    raise ValueError(
                        "oversized exp-Golomb code in multi-host encode; "
                        "no local pixel data for the host fallback")
                enc = Encoder(self.cfg).encode_picture(pictures[b])
                fw.feed(enc.slice_totals, enc.payload)
                q_out.append(enc.q_indices)
            else:
                for s in range(self.space):
                    totals = heads[b][s][2]
                    total = int(totals.sum(dtype=np.int64))
                    span = np.asarray(
                        bufs[b, s * seg + head:s * seg + head + total])
                    fw.feed(totals, span.tobytes())
                q_out.append(np.concatenate(
                    [np.asarray(heads[b][s][1]) for s in range(self.space)]
                ).reshape(geo.y_slices, geo.x_slices))
            fw.close()
        return q_out


def _local_synth_builder(kernel, depth: int, geo, space: int):
    """Shared shard-local synthesis body: (q_idx, ly, lu, lv) local lanes ->
    dequant -> band-form halo-exchange IDWT over the ``space`` ring."""
    qmatrix = matrices.quant_matrix(kernel, depth)
    qm = jnp.asarray(qmatrix.astype(np.int32))
    bs_y, bs_c = _band_meta(geo, depth)
    ys_local = geo.y_slices // space
    dims_y = [(h // space, w) for (h, w) in
              lifting.band_dims(*geo.padded_luma, depth)]
    dims_c = [(h // space, w) for (h, w) in
              lifting.band_dims(*geo.padded_chroma, depth)]

    def local(q_idx, ly, lu, lv):
        def synth(lanes, dims, bs):
            t = scale_banded(lanes, q_idx, qm, bs)
            bands = lifting.lanes_to_bands(t, ys_local, geo.x_slices, dims)
            return inverse_bands_local(bands, kernel, depth, "space")

        return (synth(ly, dims_y, bs_y), synth(lu, dims_c, bs_c),
                synth(lv, dims_c, bs_c))

    return local


def make_sharded_decode_step(kernel, depth: int, geo, mesh: Mesh,
                             batch_axis: str | None = "data"):
    """Jitted multi-chip HQ synthesis: lanes -> dequant -> IDWT (band form,
    halo exchange per vertical pass). Counterpart of the single-device
    synthesis tail (pipeline/decoder.py); output equals it exactly.
    ``batch_axis=None`` replicates the frame axis (single-picture decode over
    the ``space`` ring only).
    Reference path: /root/reference/src/DecodeStream/DecodeStream.cpp:451-613."""
    space = mesh.shape["space"]
    if geo.y_slices % space:
        raise ValueError("y_slices must divide by the space mesh extent")
    local = _local_synth_builder(kernel, depth, geo, space)

    shmap = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(batch_axis, "space"),)
        + (P(batch_axis, "space", None),) * 3,
        out_specs=(P(batch_axis, "space", None),) * 3)

    with mesh:
        return jax.jit(shmap)


def make_sharded_payload_decode_step(kernel, depth: int, geo, mesh: Mesh,
                                     word_counts: tuple[int, int, int]):
    """Jitted multi-chip HQ decode from the *compressed* slice payload:
    each shard entropy-unpacks its own contiguous slice run on device
    (vlc/device_unpack.py — slice rows coincide with row bands, so the
    per-shard regions are just the scan's offset rows), then dequant +
    halo-exchange synthesis. This removes the host-serial entropy decode
    from the mesh route: the only host work is the ~4-reads-per-slice chain
    scan. Reference decode loop being paralleled:
    /root/reference/src/DecodeStream/DecodeStream.cpp:451-613."""
    from vc2tpu.vlc import device_unpack

    space = mesh.shape["space"]
    if geo.y_slices % space:
        raise ValueError("y_slices must divide by the space mesh extent")
    Ly = geo.luma_slice[0] * geo.luma_slice[1]
    Lc = geo.chroma_slice[0] * geo.chroma_slice[1]
    synth = _local_synth_builder(kernel, depth, geo, space)

    def local(payload_u8, q_idx, dstart, clen):
        words = device_unpack.assemble_words(payload_u8)
        ly = device_unpack.unpack_component(words, dstart[0, 0], clen[0, 0],
                                            Ly, word_counts[0])
        lu, lv = device_unpack.unpack_chroma_pair(
            words, dstart[0, 1], dstart[0, 2], clen[0, 1], clen[0, 2],
            Lc, max(word_counts[1], word_counts[2]))
        return synth(q_idx, ly[None], lu[None], lv[None])

    shmap = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(None, "space"), P(None, None, "space"),
                  P(None, None, "space")),
        out_specs=(P(None, "space", None),) * 3)

    with mesh:
        return jax.jit(shmap)


def make_sharded_ld_payload_decode_step(kernel, depth: int, geo, mesh: Mesh,
                                        word_counts: tuple[int, int]):
    """Jitted multi-chip LD decode from the *compressed* slice payload:
    each shard entropy-unpacks its own contiguous slice run's body
    coefficients on device (vlc/device_unpack.unpack_component_bits —
    bit-granular bounded regions), dequantises, swaps in the host's
    DC-prediction LL grids, and runs the halo-exchange IDWT. Only the
    strictly sequential LL recurrence stays host-side (grids 1/4^depth the
    picture). LD counterpart of make_sharded_payload_decode_step.
    Reference: /root/reference/src/Library/src/Slices.cpp:195-303 (LD slice
    layout) + src/DecodeStream/DecodeStream.cpp:289-450."""
    from vc2tpu.vlc import device_unpack

    space = mesh.shape["space"]
    if geo.y_slices % space:
        raise ValueError("y_slices must divide by the space mesh extent")
    (lsh, lsw), (csh, csw) = geo.luma_slice, geo.chroma_slice
    Ly, Lc = lsh * lsw, csh * csw
    qmatrix = matrices.quant_matrix(kernel, depth)
    qm = jnp.asarray(qmatrix.astype(np.int32))
    bs_y, bs_c = _band_meta(geo, depth)
    ys_local = geo.y_slices // space
    dims_y = [(h // space, w) for (h, w) in
              lifting.band_dims(*geo.padded_luma, depth)]
    dims_c = [(h // space, w) for (h, w) in
              lifting.band_dims(*geo.padded_chroma, depth)]

    def local(payload_u8, q_idx, s_bits, len_bits, y_bits, uv_bits,
              ll_y, ll_u, ll_v):
        words = device_unpack.assemble_words(payload_u8)
        d_y = (s_bits[0] + 7 + len_bits[0]).astype(jnp.int32)
        qy = device_unpack.unpack_component_bits(words, d_y, y_bits[0], Ly,
                                                 word_counts[0])
        quv = device_unpack.unpack_component_bits(
            words, (d_y + y_bits[0]).astype(jnp.int32), uv_bits[0],
            2 * Lc, word_counts[1])
        qu, qv = quv[:, 0::2], quv[:, 1::2]

        def synth(lanes, bs, dims, ll):
            t = scale_banded(lanes[None], q_idx, qm, bs)
            bands = list(lifting.lanes_to_bands(t, ys_local, geo.x_slices,
                                                dims))
            # the device-decoded LL lanes carry no DC prediction — the host
            # recurrence's dequantised grid replaces that band
            bands[0] = ll
            return inverse_bands_local(bands, kernel, depth, "space")

        return (synth(qy, bs_y, dims_y, ll_y), synth(qu, bs_c, dims_c, ll_u),
                synth(qv, bs_c, dims_c, ll_v))

    shmap = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(None, "space")) + (P(None, "space"),) * 4
        + (P(None, "space", None),) * 3,
        out_specs=(P(None, "space", None),) * 3)

    with mesh:
        return jax.jit(shmap)


class ShardedDecoder:
    """Host driver for multi-chip stream decode: entropy-unpack on host
    (native), scatter lanes across the ``space`` axis, synthesise under
    shard_map, crop. Output is bit-exact vs the single-device decoder."""

    def __init__(self, kernel, depth: int, geo, mesh: Mesh):
        self.kernel = kernel
        self.depth = depth
        self.geo = geo
        self.mesh = mesh
        self.step = make_sharded_decode_step(kernel, depth, geo, mesh,
                                             batch_axis=None)
        self.lane_spec = NamedSharding(mesh, P(None, "space", None))
        self.q_spec = NamedSharding(mesh, P(None, "space"))
        self._payload_steps: dict = {}

    def synthesise(self, q_idx, ly, lu, lv):
        """Entropy-decoded lanes -> (y, c1, c2) padded planes (np): scatter
        across the ``space`` ring, dequant + halo IDWT under shard_map."""
        with self.mesh:
            y, c1, c2 = self.step(
                jax.device_put(np.asarray(q_idx, np.int32)[None],
                               self.q_spec),
                jax.device_put(np.asarray(ly, np.int32)[None], self.lane_spec),
                jax.device_put(np.asarray(lu, np.int32)[None], self.lane_spec),
                jax.device_put(np.asarray(lv, np.int32)[None], self.lane_spec))
        return np.asarray(y)[0], np.asarray(c1)[0], np.asarray(c2)[0]

    def decode_payload(self, payload: np.ndarray, prefix: int, scalar: int,
                       start: int = 0):
        """One picture's slice payload -> (y, c1, c2) padded planes (np)."""
        from vc2tpu.slices.hq import decode_hq_slices

        geo = self.geo
        Ly = geo.luma_slice[0] * geo.luma_slice[1]
        Lc = geo.chroma_slice[0] * geo.chroma_slice[1]
        data = decode_hq_slices(payload, geo.n_slices, prefix, scalar,
                                (Ly, Lc, Lc), start=start)
        ly, lu, lv = data.lanes
        return self.synthesise(data.q_indices, ly, lu, lv)

    def decode_ld_payload_device(self, payload: np.ndarray, sizes,
                                 qm_block_y, qm_block_c, start: int = 0):
        """One LD picture's slice payload -> (q_indices, (y, c1, c2) padded
        planes) with the body entropy unpack ON DEVICE, each shard decoding
        its own slice run (make_sharded_ld_payload_decode_step). Host work
        is the header scan plus the sequential LL DC-prediction dequant.
        Returns None when the per-shard window blocks would be
        pathologically large (callers use the host-dequant mesh route)."""
        from vc2tpu.pipeline.decoder import (_bucket, _bucket_bytes,
                                             ld_ll_grids)
        from vc2tpu.slices.ld import ld_header_fields
        from vc2tpu.vlc import device_unpack

        geo = self.geo
        (lsh, lsw), (csh, csw) = geo.luma_slice, geo.chroma_slice
        Ly, Lc = lsh * lsw, csh * csw
        q, s_bits, len_bits, y_bits, uv_bits, _end = ld_header_fields(
            payload, sizes, start)
        wy = device_unpack.window_words_bits(
            _bucket_bytes(int(y_bits.max(initial=0)) // 8 + 1) * 8, Ly)
        wc = device_unpack.window_words_bits(
            _bucket_bytes(int(uv_bits.max(initial=0)) // 8 + 1) * 8, 2 * Lc)
        n_shard = geo.n_slices // self.mesh.shape["space"]
        if 4 * n_shard * (wy + wc) > (1 << 28):
            return None                     # skewed sizes: fall back
        gy, gu, gv = ld_ll_grids(payload, q, s_bits, len_bits, y_bits,
                                 uv_bits, geo, self.depth, qm_block_y,
                                 qm_block_c)
        p4 = _bucket((len(payload) + 3) // 4 * 4 + 8)
        key = ("ld", wy, wc, p4)
        step = self._payload_steps.get(key)
        if step is None:
            step = make_sharded_ld_payload_decode_step(
                self.kernel, self.depth, self.geo, self.mesh, (wy, wc))
            self._payload_steps[key] = step
        padded = np.full(p4, 0xFF, np.uint8)   # at-EOF reads are 1-bits
        padded[:len(payload)] = payload
        sl_spec = NamedSharding(self.mesh, P(None, "space"))
        grid_spec = NamedSharding(self.mesh, P(None, "space", None))

        def put_rows(a):
            return jax.device_put(np.asarray(a, np.int32)[None], sl_spec)

        with self.mesh:
            y, c1, c2 = step(
                jax.device_put(padded, NamedSharding(self.mesh, P())),
                put_rows(q), put_rows(s_bits), put_rows(len_bits),
                put_rows(y_bits), put_rows(uv_bits),
                jax.device_put(gy[None], grid_spec),
                jax.device_put(gu[None], grid_spec),
                jax.device_put(gv[None], grid_spec))
        return q, (np.asarray(y)[0], np.asarray(c1)[0], np.asarray(c2)[0])

    def decode_payload_device(self, payload: np.ndarray, q_idx, dstart,
                              cbytes, prefix: int | None = None,
                              scalar: int | None = None, start: int = 0):
        """One picture's slice payload -> (y, c1, c2) padded planes with the
        entropy unpack ON DEVICE, each shard decoding its own slice run
        (make_sharded_payload_decode_step). Host work is only the chain scan
        whose (q, dstart, cbytes) rows arrive here.

        The per-shard window block is sized by the LARGEST component
        region, so a pathologically skewed stream (one huge slice among
        thousands of tiny ones) can inflate it far past the payload size;
        when ``prefix``/``scalar`` are provided, such streams fall back to
        the host-unpack ``decode_payload`` route instead of requesting an
        enormous device allocation."""
        from vc2tpu.pipeline.decoder import _bucket, _bucket_bytes
        from vc2tpu.vlc import device_unpack

        geo = self.geo
        Ly = geo.luma_slice[0] * geo.luma_slice[1]
        Lc = geo.chroma_slice[0] * geo.chroma_slice[1]
        cbytes = np.asarray(cbytes)
        word_counts = tuple(
            device_unpack.window_words(
                _bucket_bytes(int(cbytes[c].max(initial=0))),
                (Ly, Lc, Lc)[c])
            for c in range(3))
        if prefix is not None:
            n_shard = geo.n_slices // self.mesh.shape["space"]
            if (device_unpack.block_bytes_estimate(n_shard, word_counts)
                    > (1 << 28)):
                return self.decode_payload(payload, prefix, scalar,
                                           start=start)
        p4 = _bucket((len(payload) + 3) // 4 * 4 + 8)
        key = (word_counts, p4)
        step = self._payload_steps.get(key)
        if step is None:
            step = make_sharded_payload_decode_step(
                self.kernel, self.depth, self.geo, self.mesh, word_counts)
            self._payload_steps[key] = step
        padded = np.zeros(p4, np.uint8)
        padded[:len(payload)] = payload
        off_spec = NamedSharding(self.mesh, P(None, None, "space"))
        with self.mesh:
            y, c1, c2 = step(
                jax.device_put(padded,
                               NamedSharding(self.mesh, P())),
                jax.device_put(np.asarray(q_idx, np.int32)[None],
                               self.q_spec),
                jax.device_put(np.asarray(dstart, np.int32)[None], off_spec),
                jax.device_put(cbytes.astype(np.int32)[None], off_spec))
        return np.asarray(y)[0], np.asarray(c1)[0], np.asarray(c2)[0]
