"""Multi-host orchestration: distributed init, cross-host mesh, host-0
stream assembly, and the scaling-efficiency harness.

The reference is strictly single-process (SURVEY.md §2: no MPI/NCCL/any
distributed anything); this module is the scale-out across hosts for
config #5 (8K row-band sharding across hosts):

* ``data`` axis — frame parallelism across hosts, over the inter-host
  network (frames are
  independent in an intra-only codec);
* ``space`` axis — row-band parallelism inside each frame, over the
  host's own device interconnect (per-lifting-pass halo rings, vc2tpu.shard.halo).

Each process contributes its local devices; the sharded encode step
(pipeline.sharded) runs identically to the single-process case — the only
multi-host-specific machinery is (a) jax.distributed initialisation, (b)
building global arrays from per-process frame data, and (c) gathering the
per-shard payload buffers across hosts so process 0 can emit the byte stream:
either assembled whole pictures (encode_local_batch) or fragment data
units streamed span-by-span as stream_fragments walks the gathered
shard buffers (FragmentWriter — bounded buffering, no full-payload
assembly).

Validated without a multi-host cluster by the multiprocess CPU harness in
tests/test_multihost.py (N processes x M virtual CPU devices each), which
asserts the assembled stream is byte-identical to the single-chip encoder.
"""

from __future__ import annotations

import os

import numpy as np
import jax
from jax.sharding import Mesh, PartitionSpec as P

from vc2tpu.core.config import EncoderConfig
from vc2tpu.pipeline.sharded import ShardedEncoder


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Bring up the JAX distributed runtime. Where no cluster environment
    tells JAX the coordinator, pass all three arguments (the CPU harness
    does)."""
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def make_global_mesh(data: int | None = None,
                     space: int | None = None) -> Mesh:
    """Mesh over ALL processes' devices: ``data`` (frames, across hosts) x
    ``space`` (row bands, within a host). Defaults: data = process count (each
    host owns whole frames), space = devices per process."""
    devices = jax.devices()
    if data is None:
        data = jax.process_count()
    if space is None:
        space = len(devices) // data
    if data * space != len(devices):
        raise ValueError(f"mesh {data}x{space} != {len(devices)} devices")
    # jax.devices() orders by process; reshaping (data, space) keeps each
    # row's ``space`` ring within one process where possible (one host's
    # interconnect, not the network)
    return Mesh(np.array(devices).reshape(data, space), ("data", "space"))


class MultiHostEncoder:
    """Frame-parallel multi-host HQ encoder.

    Every process calls encode_batch() with the SAME global batch metadata
    but only its own frames' pixel data (frames are distributed over the
    ``data`` axis, one block of B/data frames per mesh row). The sharded
    step runs globally; per-shard payload buffers are allgathered across hosts
    and every process can assemble the identical stream — process 0 writes
    it (write_stream)."""

    def __init__(self, cfg: EncoderConfig, mesh: Mesh):
        self.enc = ShardedEncoder(cfg, mesh)
        self.cfg = cfg
        self.mesh = mesh

    def _dispatch_global(self, pictures):
        """Run the sharded step on this process's frames; returns the
        global (q_idx, bufs) device arrays."""
        from jax.experimental import multihost_utils

        enc = self.enc
        # same pad/stack/budget prep as the single-host step — one copy
        # (pipeline/sharded.ShardedEncoder._prep), so the paths cannot drift
        y, c1, c2, bud = enc._prep(pictures)
        gy = multihost_utils.host_local_array_to_global_array(
            y, self.mesh, P("data", "space", None))
        gc1 = multihost_utils.host_local_array_to_global_array(
            c1, self.mesh, P("data", "space", None))
        gc2 = multihost_utils.host_local_array_to_global_array(
            c2, self.mesh, P("data", "space", None))
        gbud = multihost_utils.host_local_array_to_global_array(
            bud, self.mesh, P("data", "space"))
        with self.mesh:
            return enc.step(gy, gc1, gc2, gbud)

    def encode_local_batch(self, pictures):
        """pictures: this process's frames (B/data of them, the mesh-row
        block owned by this process). Returns EncodedPicture list for the
        GLOBAL batch, identical on every process."""
        from jax.experimental import multihost_utils

        enc = self.enc
        q_idx, bufs = self._dispatch_global(pictures)
        # cross-host gather: every process receives the full (B, space*M)
        # buffers
        q_all = multihost_utils.process_allgather(q_idx, tiled=True)
        bufs_all = multihost_utils.process_allgather(bufs, tiled=True)
        out, retry = enc._assemble(np.asarray(q_all), np.asarray(bufs_all),
                                   None)
        if retry is not None:
            raise ValueError(
                "payload capacity miss in multi-host encode; raise cap_local "
                f"(need {retry})")
        return out

    def stream_fragments(self, pictures, writer, picture_numbers, preamble):
        """Fragment-streaming multi-host output: run the global step,
        gather the per-shard buffers across hosts (one allgather — the
        transport granularity), and on process 0 frame + write each
        shard's payload span incrementally through FragmentWriter — no
        full-picture payload is ever assembled. picture_numbers cover the
        GLOBAL batch (data-axis order). Returns per-picture q arrays on
        process 0, None elsewhere; bytes are identical to the single-chip
        fragmented writer (reference framing: /root/reference/src/Library/
        src/DataUnit.cpp:267-342)."""
        import jax

        from jax.experimental import multihost_utils

        enc = self.enc
        _, bufs = self._dispatch_global(pictures)
        bufs_np = np.asarray(
            multihost_utils.process_allgather(bufs, tiled=True))
        heads, head, seg = enc._fetch_heads(bufs_np, bufs_np.shape[0])
        retry, fallback = enc._check_heads(heads)
        if retry is not None:
            raise ValueError(
                "payload capacity miss in multi-host encode; raise "
                f"cap_local (need {retry})")
        if jax.process_index() != 0:
            return None
        return enc._stream_payloads(writer, bufs_np, heads, head, seg,
                                    fallback, picture_numbers, preamble,
                                    None)


def collect_hq_payloads(stream: bytes):
    """Parse a well-formed HQ stream into (sequence_header, [(picture
    number, preamble, payload bytes)]) — whole pictures and reassembled
    fragments (the reference's FragmentedPictureData reassembly,
    /root/reference/src/DecodeStream/DecodeStream.cpp:62-101, 799-976).

    This is the multi-host decode front-end: every process parses the
    stream identically (stream bytes are ~2 orders of magnitude smaller
    than pixels, so replicating the parse costs nothing) and then
    synthesises only its own block. Resilience-hardened parsing (resync,
    lying offsets, corrupt slices) lives in cli.decode_stream; this helper
    requires valid next_parse_offsets."""
    from vc2tpu.stream.dataunit import DataUnitType, StreamReader

    rd = StreamReader(stream)
    hdr = None
    out = []
    frags: dict = {}
    pos = 0
    while pos + 13 <= len(stream):
        rd.r.seek(pos)
        du, next_off, _prev = rd.read_data_unit()
        if du == DataUnitType.SEQUENCE_HEADER:
            hdr = rd.read_sequence_header()
        elif du == DataUnitType.HQ_PICTURE:
            picnum = rd.read_picture_number()
            pre = rd.read_preamble(True)
            end = pos + next_off if next_off >= 13 else len(stream)
            out.append((picnum, pre,
                        np.frombuffer(stream[rd.r.byte_pos:end], np.uint8)))
        elif du == DataUnitType.HQ_FRAGMENT:
            picnum = rd.read_picture_number()
            frag = rd.read_fragment_header()
            if frag.n_slices == 0:
                frags[picnum] = (rd.read_preamble(True), {}, 0)
            elif picnum in frags:
                pre, parts, cnt = frags[picnum]
                body = rd.r.get_raw(frag.data_length)
                first = (frag.slice_offset_y * pre.slices_x
                         + frag.slice_offset_x)
                parts[first] = body
                cnt += frag.n_slices
                if cnt >= pre.slices_x * pre.slices_y:
                    payload = b"".join(p for _, p in sorted(parts.items()))
                    out.append((picnum, pre,
                                np.frombuffer(payload, np.uint8)))
                    del frags[picnum]
                else:
                    frags[picnum] = (pre, parts, cnt)
        if next_off >= 13:
            pos += next_off
        elif du == DataUnitType.END_OF_SEQUENCE:
            pos += 13
        else:
            break                      # this helper needs valid offsets
    return hdr, out


class MultiHostDecoder:
    """Frame-parallel multi-host HQ decode: pictures are partitioned
    round-robin over processes, each process entropy-unpacks and
    synthesises its block row-band-sharded over its LOCAL ``space``
    devices (halo rings), and process 0 gathers the cropped planes
    across hosts for in-order planar output — the multi-host analogue of the
    reference decode tail + fragment reassembly
    (/root/reference/src/DecodeStream/DecodeStream.cpp:799-976)."""

    def __init__(self, kernel, depth: int, geo, space: int | None = None):
        import jax

        from vc2tpu.pipeline.sharded import ShardedDecoder

        local = jax.local_devices()
        space = space if space is not None else len(local)
        lmesh = Mesh(np.array(local[:space]).reshape(1, space),
                     ("data", "space"))
        self.sdec = ShardedDecoder(kernel, depth, geo, lmesh)
        self.geo = geo
        self._device_unpack = os.environ.get("VC2TPU_DEVICE_UNPACK",
                                             "1") != "0"

    def _decode_one(self, payload, prefix: int, scalar: int):
        """One picture's payload -> padded planes, entropy-unpacking on the
        local devices (per-shard, vlc/device_unpack.py) when enabled."""
        if self._device_unpack:
            from vc2tpu.slices.hq import scan_hq_slice_offsets

            q, dstart, cbytes, _ = scan_hq_slice_offsets(
                np.ascontiguousarray(payload, np.uint8), self.geo.n_slices,
                prefix, scalar)
            # prefix/scalar enable the skewed-stream host-unpack fallback
            return self.sdec.decode_payload_device(payload, q, dstart,
                                                   cbytes, prefix=prefix,
                                                   scalar=scalar)
        return self.sdec.decode_payload(payload, prefix, scalar)

    def decode_pictures(self, items, prefix: int, scalar: int,
                        out_luma, out_chroma):
        """items: the GLOBAL [(picture_number, payload)] list in output
        order. Returns the ordered [(y, c1, c2)] cropped int32 planes on
        process 0, None elsewhere. Picture i is decoded by process
        i % process_count; process 0 receives every block via one cross-host
        allgather of the stacked planes."""
        import jax
        from jax.experimental import multihost_utils

        nproc = jax.process_count()
        pid = jax.process_index()
        n = len(items)
        if n == 0:
            return [] if pid == 0 else None
        k = -(-n // nproc)              # pictures per process, padded
        lh, lw = out_luma
        ch, cw = out_chroma
        ys = np.empty((k, lh, lw), np.int32)
        c1s = np.empty((k, ch, cw), np.int32)
        c2s = np.empty((k, ch, cw), np.int32)
        for j in range(k):
            i = min(pid + j * nproc, n - 1)
            y, c1, c2 = self._decode_one(items[i][1], prefix, scalar)
            ys[j] = y[:lh, :lw]
            c1s[j] = c1[:ch, :cw]
            c2s[j] = c2[:ch, :cw]
        gy = multihost_utils.process_allgather(ys, tiled=True)
        gc1 = multihost_utils.process_allgather(c1s, tiled=True)
        gc2 = multihost_utils.process_allgather(c2s, tiled=True)
        if pid != 0:
            return None
        out = []
        for i in range(n):
            p, j = i % nproc, i // nproc
            g = p * k + j
            out.append((gy[g], gc1[g], gc2[g]))
        return out


def scaling_efficiency(cfg: EncoderConfig, mesh: Mesh, n_frames: int = 4,
                       seed: int = 0):
    """Throughput harness for the 1->N-host scaling target (BASELINE.json
    north star: >=80% at 8K). Times the sharded encode step end-to-end on
    ``mesh`` and returns frames/s; run with meshes of increasing host count
    and divide. Works on any backend (CPU virtual mesh for validation, real
    devices for the measurement)."""
    import time

    from vc2tpu.core.picture import Picture

    rng = np.random.default_rng(seed)
    g = cfg.geometry
    pics = [Picture(
        rng.integers(-512, 511, (g.luma_height, g.luma_width)).astype(np.int32),
        rng.integers(-512, 511, (g.chroma_height, g.chroma_width)).astype(np.int32),
        rng.integers(-512, 511, (g.chroma_height, g.chroma_width)).astype(np.int32),
        cfg.chroma_format) for _ in range(n_frames)]
    enc = ShardedEncoder(cfg, mesh)
    data = mesh.shape["data"]
    enc.encode_batch((pics * data)[:data])               # compile
    t0 = time.perf_counter()
    done = 0
    while done < n_frames:
        k = min(data, n_frames - done)
        batch = pics[done:done + k]
        batch = batch + [batch[-1]] * (data - k)         # pad to the extent
        enc.encode_batch(batch)
        done += k
    return n_frames / (time.perf_counter() - t0)
