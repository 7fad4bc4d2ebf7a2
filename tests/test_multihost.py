"""Multi-host validation on the multiprocess CPU backend (SURVEY §4:
"multi-host simulated with multiprocess CPU mesh").

Spawns N real OS processes, each owning 4 virtual CPU devices, connected by
jax.distributed over a localhost coordinator. The global (data=N, space=4)
mesh runs the full sharded encode step (halo DWT + sharded RDO + quantise +
per-shard entropy pack); process 0 assembles the stream. The stream must be
byte-identical to the single-chip encoder's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(__file__)


@pytest.mark.slow
def test_two_process_encode_byte_identical(tmp_path):
    import socket

    out = str(tmp_path / "mh.vc2")
    n = 2
    with socket.socket() as s:        # pick a free coordinator port
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)        # worker sets its own device count
    env["JAX_PLATFORMS"] = "cpu"
    # the worker must import vc2tpu even on a machine without the .pth
    # registration (CLAUDE.md setup step) — pass the repo root explicitly
    repo = os.path.dirname(HERE)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    for pid in range(n):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "multihost_worker.py"),
             f"localhost:{port}", str(n), str(pid), out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    fail = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, _ = p.communicate()
            fail.append("timeout")
        if p.returncode != 0:
            fail.append(stdout.decode(errors="replace")[-2000:])
    assert not fail, f"worker failures: {fail}"

    # single-chip reference stream over the same deterministic batch
    import io

    from vc2tpu.core.config import (ColourFormat, EncoderConfig, FrameRate,
                                    Mode, Profile, WaveletKernel)
    from vc2tpu.core.picture import Picture
    from vc2tpu.pipeline.encoder import Encoder
    from vc2tpu.stream.dataunit import PicturePreamble, StreamWriter
    from vc2tpu.stream.headers import SequenceHeader

    H, W = 64, 64
    cfg = EncoderConfig(height=H, width=W, chroma_format=ColourFormat.CF422,
                        kernel=WaveletKernel.LeGall, wavelet_depth=2,
                        y_size=1, x_size=2, mode=Mode.HQ_CBR,
                        luma_depth=10, chroma_depth=10,
                        frame_rate=FrameRate.FR25,
                        compressed_bytes=H * W // 2, slice_scalar=1)
    rng = np.random.default_rng(7)
    frames = [
        Picture(rng.integers(-512, 512, (H, W)).astype(np.int32),
                rng.integers(-512, 512, (H, W // 2)).astype(np.int32),
                rng.integers(-512, 512, (H, W // 2)).astype(np.int32),
                cfg.chroma_format) for _ in range(n)]
    enc = Encoder(cfg)
    encoded = [enc.encode_picture(p) for p in frames]
    buf = io.BytesIO()
    wtr = StreamWriter(buf)
    wtr.start_sequence()
    wtr.write_sequence_header(SequenceHeader(
        profile=Profile.PROFILE_HQ, height=H, width=W,
        chroma_format=cfg.chroma_format, interlace=False,
        frame_rate=cfg.frame_rate, top_field_first=True, bitdepth=10))
    for i, e in enumerate(encoded):
        wtr.write_picture(i, PicturePreamble(
            wavelet_kernel=cfg.kernel, depth=cfg.wavelet_depth,
            slices_x=enc.geo.x_slices, slices_y=enc.geo.y_slices,
            slice_prefix=cfg.slice_prefix,
            slice_size_scalar=cfg.slice_scalar),
            e.payload, hq=True, slice_sizes=e.slice_totals)
    wtr.end_sequence()
    assert open(out, "rb").read() == buf.getvalue()

    # fragment-streaming leg: host-0 span-by-span emission must equal the
    # single-chip fragmented writer byte-for-byte
    fbuf = io.BytesIO()
    fwtr = StreamWriter(fbuf)
    fwtr.fragment_length = 256
    fwtr.start_sequence()
    fwtr.write_sequence_header(SequenceHeader(
        profile=Profile.PROFILE_HQ, height=H, width=W,
        chroma_format=cfg.chroma_format, interlace=False,
        frame_rate=cfg.frame_rate, top_field_first=True, bitdepth=10))
    for i, e in enumerate(encoded):
        fwtr.write_picture(i, PicturePreamble(
            wavelet_kernel=cfg.kernel, depth=cfg.wavelet_depth,
            slices_x=enc.geo.x_slices, slices_y=enc.geo.y_slices,
            slice_prefix=cfg.slice_prefix,
            slice_size_scalar=cfg.slice_scalar),
            e.payload, hq=True, slice_sizes=e.slice_totals)
    fwtr.end_sequence()
    assert open(out + ".frag", "rb").read() == fbuf.getvalue()

    # multi-host decode leg: N-process round-robin sharded synthesis of
    # the fragmented stream must equal the single-chip decoder bit-exact
    from vc2tpu.cli.decode_stream import Decoder

    sink = io.BytesIO()
    dec = Decoder(sink=sink)
    assert dec.run(fbuf.getvalue()) == 0
    assert dec.frames_out == n
    assert open(out + ".dec", "rb").read() == sink.getvalue()


def test_collect_hq_payloads_matches_fragment_reassembly():
    """The multi-host decode front-end (collect_hq_payloads) reassembles
    fragments exactly: rebuilding a whole-picture stream from its output
    decodes bit-identical to the fragmented golden."""
    import io

    from vc2tpu.cli.decode_stream import Decoder
    from vc2tpu.shard.multihost import collect_hq_payloads
    from vc2tpu.stream.dataunit import StreamWriter

    golden = os.path.join(HERE, "golden")
    stream = open(os.path.join(golden, "cbr_fragmented.vc2"), "rb").read()
    want = open(os.path.join(golden, "cbr_fragmented.dec.16p2"), "rb").read()
    hdr, items = collect_hq_payloads(stream)
    assert hdr is not None and items

    buf = io.BytesIO()
    wtr = StreamWriter(buf)
    wtr.start_sequence()
    wtr.write_sequence_header(hdr)
    for picnum, pre, payload in items:
        wtr.write_picture(picnum, pre, payload.tobytes(), hq=True)
    wtr.end_sequence()

    sink = io.BytesIO()
    dec = Decoder(sink=sink)
    assert dec.run(buf.getvalue()) == 0
    assert sink.getvalue() == want


def test_scaling_harness_smoke():
    """scaling_efficiency runs end-to-end on a virtual mesh and returns a
    finite throughput (the real measurement needs several hosts)."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from vc2tpu.core.config import (ColourFormat, EncoderConfig, FrameRate,
                                    Mode, WaveletKernel)
    from vc2tpu.shard.mesh import make_mesh
    from vc2tpu.shard.multihost import scaling_efficiency

    cfg = EncoderConfig(height=64, width=64, chroma_format=ColourFormat.CF422,
                        kernel=WaveletKernel.LeGall, wavelet_depth=2,
                        y_size=1, x_size=2, mode=Mode.HQ_CBR,
                        luma_depth=10, chroma_depth=10,
                        frame_rate=FrameRate.FR25,
                        compressed_bytes=2048, slice_scalar=1)
    fps = scaling_efficiency(cfg, make_mesh(data=2, space=4), n_frames=2)
    assert fps > 0


@pytest.mark.slow
@pytest.mark.skipif(not os.environ.get("VC2TPU_SLOW"),
                    reason="8K sharded step is minutes on one CPU core; "
                           "set VC2TPU_SLOW=1")
def test_8k_sharded_encode_step(tmp_path):
    """BASELINE.json config #5: the 8K CBR sharded encode step runs on an
    8-way mesh and its stream bytes equal the single-chip encoder's."""
    import jax

    from vc2tpu.core.config import (ColourFormat, EncoderConfig, FrameRate,
                                    Mode, WaveletKernel)
    from vc2tpu.core.picture import Picture
    from vc2tpu.pipeline.encoder import Encoder
    from vc2tpu.pipeline.sharded import ShardedEncoder
    from vc2tpu.shard.mesh import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    H, W = 4320, 7680
    cfg = EncoderConfig(height=H, width=W, chroma_format=ColourFormat.CF422,
                        kernel=WaveletKernel.LeGall, wavelet_depth=2,
                        y_size=1, x_size=2, mode=Mode.HQ_CBR,
                        luma_depth=10, chroma_depth=10,
                        frame_rate=FrameRate.FR50,
                        compressed_bytes=16 * 829440, slice_scalar=2)
    rng = np.random.default_rng(1)
    pic = Picture(rng.integers(-512, 512, (H, W)).astype(np.int32),
                  rng.integers(-512, 512, (H, W // 2)).astype(np.int32),
                  rng.integers(-512, 512, (H, W // 2)).astype(np.int32),
                  cfg.chroma_format)
    mesh = make_mesh(data=1, space=8)
    senc = ShardedEncoder(cfg, mesh)
    got = senc.encode_batch([pic])[0]
    want = Encoder(cfg).encode_picture(pic)
    np.testing.assert_array_equal(got.q_indices, want.q_indices)
    assert got.payload == want.payload

    # decode leg: 8-way sharded synthesis of the 8K payload == host engine
    from vc2tpu.pipeline.sharded import ShardedDecoder
    from vc2tpu.pipeline import host_synth
    from vc2tpu.wavelet import matrices

    sdec = ShardedDecoder(cfg.kernel, cfg.wavelet_depth, senc.geo, mesh)
    payload = np.frombuffer(got.payload, np.uint8)
    ry, _, _ = sdec.decode_payload(payload, cfg.slice_prefix,
                                   cfg.slice_scalar)
    if host_synth.available():
        from vc2tpu.slices.hq import decode_hq_slices

        geo = senc.geo
        Ly = geo.luma_slice[0] * geo.luma_slice[1]
        Lc = geo.chroma_slice[0] * geo.chroma_slice[1]
        d = decode_hq_slices(payload, geo.n_slices, cfg.slice_prefix,
                             cfg.slice_scalar, (Ly, Lc, Lc))
        ref_y = host_synth.synthesise_component(
            np.ascontiguousarray(d.lanes[0], np.int16), d.q_indices,
            matrices.quant_matrix(cfg.kernel, cfg.wavelet_depth).astype(np.int32),
            cfg.kernel, cfg.wavelet_depth, geo.y_slices, geo.x_slices,
            *geo.luma_slice)
        np.testing.assert_array_equal(np.asarray(ry), ref_y)

    # full 8K mesh STREAM decode (the decode CLI's --mesh path) vs the
    # single-chip decoder, byte-identical
    import io

    from vc2tpu.cli.decode_stream import Decoder
    from vc2tpu.core.config import Profile
    from vc2tpu.stream.dataunit import PicturePreamble, StreamWriter
    from vc2tpu.stream.headers import SequenceHeader

    buf = io.BytesIO()
    wtr = StreamWriter(buf)
    wtr.start_sequence()
    wtr.write_sequence_header(SequenceHeader(
        profile=Profile.PROFILE_HQ, height=H, width=W,
        chroma_format=cfg.chroma_format, interlace=False,
        frame_rate=cfg.frame_rate, top_field_first=True, bitdepth=10))
    wtr.write_picture(0, PicturePreamble(
        wavelet_kernel=cfg.kernel, depth=cfg.wavelet_depth,
        slices_x=senc.geo.x_slices, slices_y=senc.geo.y_slices,
        slice_prefix=cfg.slice_prefix, slice_size_scalar=cfg.slice_scalar),
        got.payload, hq=True, slice_sizes=got.slice_totals)
    wtr.end_sequence()
    stream = buf.getvalue()
    a, b = io.BytesIO(), io.BytesIO()
    d0 = Decoder(sink=a)
    assert d0.run(stream) == 0 and d0.frames_out == 1
    d1 = Decoder(sink=b, mesh=mesh)
    assert d1.run(stream) == 0 and d1.frames_out == 1
    assert b.getvalue() == a.getvalue()
