"""Sharded DWT == unsharded DWT, exactly (ints), on a virtual CPU mesh."""

import os

import jax
import numpy as np
import pytest

from vc2tpu.core.config import WaveletKernel
from vc2tpu.shard.halo import sharded_forward_plane, sharded_inverse_plane
from vc2tpu.shard.mesh import make_mesh
from vc2tpu.wavelet import lifting

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

# Every (kernel, depth, space) combination compiles its own shard_map
# program (~5-40 s each on this one-core host), so the default tier keeps
# the hardest point of the matrix — every kernel at space=8 depth=2 (most
# shard boundaries, deepest halo reach) plus one cheap (2, 1) smoke — and
# the full matrix runs in the slow tier.
SLOW = pytest.mark.skipif(not os.environ.get("VC2TPU_SLOW"),
                          reason="redundant mesh permutation; "
                                 "set VC2TPU_SLOW=1")

KERNELS = [WaveletKernel.LeGall, WaveletKernel.Haar1, WaveletKernel.DD97,
           WaveletKernel.DD137, WaveletKernel.Fidelity, WaveletKernel.Daub97]


def _forward_params():
    out = []
    for space in (2, 4, 8):
        for depth in (1, 2):
            for k in KERNELS:
                default = (space == 8 and depth == 2) or (
                    k is WaveletKernel.LeGall and space == 2 and depth == 1)
                out.append(pytest.param(
                    k, depth, space, id=f"{space}-{depth}-{k.name}",
                    marks=() if default else (SLOW,)))
    return out


@pytest.mark.parametrize("kernel,depth,space", _forward_params())
def test_sharded_forward_matches(kernel, depth, space):
    mesh = make_mesh(data=1, space=space)
    rng = np.random.default_rng(0)
    x = rng.integers(-512, 512, (space * 16, 32)).astype(np.int32)
    ref = np.asarray(lifting.forward_plane(x, kernel, depth))
    got = np.asarray(sharded_forward_plane(x, mesh, kernel, depth))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kernel", [
    pytest.param(WaveletKernel.LeGall, marks=SLOW,
                 id="LeGall"),       # covered end-to-end by the mesh
                                     # decode CLI tests below
    pytest.param(WaveletKernel.Fidelity, id="Fidelity"),
])
def test_sharded_inverse_matches(kernel):
    mesh = make_mesh(data=1, space=4)
    rng = np.random.default_rng(1)
    t = rng.integers(-2048, 2048, (64, 48)).astype(np.int32)
    ref = np.asarray(lifting.inverse_plane(t, kernel, 2))
    got = np.asarray(sharded_inverse_plane(t, mesh, kernel, 2))
    np.testing.assert_array_equal(got, ref)


def test_sharded_roundtrip_with_data_axis():
    mesh = make_mesh(data=2, space=4)
    rng = np.random.default_rng(2)
    x = rng.integers(-512, 512, (2, 32, 32)).astype(np.int32)
    from jax.sharding import NamedSharding, PartitionSpec as P

    xs = jax.device_put(x, NamedSharding(mesh, P("data", "space", None)))
    t = sharded_forward_plane(xs, mesh, WaveletKernel.LeGall, 2)
    r = np.asarray(sharded_inverse_plane(t, mesh, WaveletKernel.LeGall, 2))
    np.testing.assert_array_equal(r, x)


def _cbr_cfg(H, W, depth=2, scalar=1):
    from vc2tpu.core.config import (ColourFormat, EncoderConfig, FrameRate,
                                    Mode)

    return EncoderConfig(height=H, width=W, chroma_format=ColourFormat.CF422,
                         kernel=WaveletKernel.LeGall, wavelet_depth=depth,
                         y_size=1, x_size=2, mode=Mode.HQ_CBR,
                         luma_depth=10, chroma_depth=10,
                         frame_rate=FrameRate.FR25,
                         compressed_bytes=H * W // 2, slice_scalar=scalar)


def _frames(B, H, W, seed=3):
    from vc2tpu.core.config import ColourFormat
    from vc2tpu.core.picture import Picture

    rng = np.random.default_rng(seed)
    return [Picture(rng.integers(-512, 512, (H, W)).astype(np.int32),
                    rng.integers(-512, 512, (H, W // 2)).astype(np.int32),
                    rng.integers(-512, 512, (H, W // 2)).astype(np.int32),
                    ColourFormat.CF422) for _ in range(B)]


def test_sharded_encode_to_bytes_matches_single_chip():
    """The full multi-chip encode step — halo DWT + sharded RDO + quantise +
    per-shard on-device entropy pack — must produce payload bytes, slice
    totals and q indices identical to the single-chip Encoder, and the
    assembled stream (whole picture AND fragmented) must be byte-identical."""
    import io

    from vc2tpu.core.config import Profile
    from vc2tpu.pipeline.encoder import Encoder
    from vc2tpu.pipeline.sharded import ShardedEncoder
    from vc2tpu.stream.dataunit import PicturePreamble, StreamWriter
    from vc2tpu.stream.headers import SequenceHeader

    mesh = make_mesh(data=2, space=4)
    H, W = 64, 64
    cfg = _cbr_cfg(H, W)
    pics = _frames(2, H, W)
    senc = ShardedEncoder(cfg, mesh)
    got = senc.encode_batch(pics)

    enc = Encoder(cfg)
    want = [enc.encode_picture(p) for p in pics]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.q_indices, w.q_indices)
        np.testing.assert_array_equal(g.slice_totals, w.slice_totals)
        assert g.payload == w.payload

    def stream_bytes(encoded, fragment_length=0):
        buf = io.BytesIO()
        wtr = StreamWriter(buf)
        wtr.fragment_length = fragment_length
        wtr.start_sequence()
        wtr.write_sequence_header(SequenceHeader(
            profile=Profile.PROFILE_HQ, height=H, width=W,
            chroma_format=cfg.chroma_format, interlace=False,
            frame_rate=cfg.frame_rate, top_field_first=True, bitdepth=10))
        for i, e in enumerate(encoded):
            wtr.write_picture(i, PicturePreamble(
                wavelet_kernel=cfg.kernel, depth=cfg.wavelet_depth,
                slices_x=senc.geo.x_slices, slices_y=senc.geo.y_slices,
                slice_prefix=cfg.slice_prefix,
                slice_size_scalar=cfg.slice_scalar),
                e.payload, hq=True, slice_sizes=e.slice_totals)
        wtr.end_sequence()
        return buf.getvalue()

    assert stream_bytes(got) == stream_bytes(want)
    assert stream_bytes(got, 512) == stream_bytes(want, 512)


def test_sharded_vbr_encode_to_bytes_matches_single_chip():
    """ConstQ (VBR, self-sized slices) through the sharded pack — exercises
    the adaptive capacity bucket instead of the exact CBR budget."""
    from vc2tpu.core.config import (ColourFormat, EncoderConfig, FrameRate,
                                    Mode)
    from vc2tpu.pipeline.encoder import Encoder
    from vc2tpu.pipeline.sharded import ShardedEncoder

    mesh = make_mesh(data=1, space=8)
    H, W = 64, 64
    cfg = EncoderConfig(height=H, width=W, chroma_format=ColourFormat.CF422,
                        kernel=WaveletKernel.DD97, wavelet_depth=2,
                        y_size=1, x_size=2, mode=Mode.HQ_ConstQ,
                        luma_depth=10, chroma_depth=10,
                        frame_rate=FrameRate.FR25, q_index=24)
    pics = _frames(1, H, W, seed=9)
    got = ShardedEncoder(cfg, mesh).encode_batch(pics)
    want = Encoder(cfg).encode_picture(pics[0])
    np.testing.assert_array_equal(got[0].q_indices, want.q_indices)
    assert got[0].payload == want.payload


def _hq_stream(cfg, geo, encoded, H, W, fragment_length=0, interlace=False):
    import io

    from vc2tpu.core.config import Profile
    from vc2tpu.stream.dataunit import PicturePreamble, StreamWriter
    from vc2tpu.stream.headers import SequenceHeader

    buf = io.BytesIO()
    wtr = StreamWriter(buf)
    wtr.fragment_length = fragment_length
    wtr.start_sequence()
    wtr.write_sequence_header(SequenceHeader(
        profile=Profile.PROFILE_HQ, height=H, width=W,
        chroma_format=cfg.chroma_format, interlace=interlace,
        frame_rate=cfg.frame_rate, top_field_first=True, bitdepth=10))
    for i, e in enumerate(encoded):
        wtr.write_picture(i, PicturePreamble(
            wavelet_kernel=cfg.kernel, depth=cfg.wavelet_depth,
            slices_x=geo.x_slices, slices_y=geo.y_slices,
            slice_prefix=cfg.slice_prefix,
            slice_size_scalar=cfg.slice_scalar),
            e.payload, hq=True, slice_sizes=e.slice_totals)
    wtr.end_sequence()
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["cbr", "vbr"])
def test_fragment_streaming_matches_batch(mode):
    """encode_batch_to_fragments (per-shard span emission through
    FragmentWriter) must produce the byte-identical stream to framing the
    batch-assembled payload, for the exact-budget CBR pack and the
    adaptive-bucket VBR pack."""
    import io

    from vc2tpu.core.config import (ColourFormat, EncoderConfig, FrameRate,
                                    Mode, Profile)
    from vc2tpu.pipeline.sharded import ShardedEncoder
    from vc2tpu.stream.dataunit import PicturePreamble, StreamWriter
    from vc2tpu.stream.headers import SequenceHeader

    mesh = make_mesh(data=2, space=4)
    H, W = 64, 64
    if mode == "cbr":
        cfg = _cbr_cfg(H, W)
    else:
        cfg = EncoderConfig(height=H, width=W,
                            chroma_format=ColourFormat.CF422,
                            kernel=WaveletKernel.LeGall, wavelet_depth=2,
                            y_size=1, x_size=2, mode=Mode.HQ_ConstQ,
                            luma_depth=10, chroma_depth=10,
                            frame_rate=FrameRate.FR25, q_index=20)
    pics = _frames(2, H, W, seed=13)
    senc = ShardedEncoder(cfg, mesh)
    pre = PicturePreamble(
        wavelet_kernel=cfg.kernel, depth=cfg.wavelet_depth,
        slices_x=senc.geo.x_slices, slices_y=senc.geo.y_slices,
        slice_prefix=cfg.slice_prefix, slice_size_scalar=cfg.slice_scalar)
    hdr = SequenceHeader(
        profile=Profile.PROFILE_HQ, height=H, width=W,
        chroma_format=cfg.chroma_format, interlace=False,
        frame_rate=cfg.frame_rate, top_field_first=True, bitdepth=10)

    def seq(writer):
        writer.fragment_length = 300
        writer.start_sequence()
        writer.write_sequence_header(hdr)

    sbuf = io.BytesIO()
    swtr = StreamWriter(sbuf)
    seq(swtr)
    qs = senc.encode_batch_to_fragments(pics, swtr, [0, 1], pre)
    swtr.end_sequence()

    bbuf = io.BytesIO()
    bwtr = StreamWriter(bbuf)
    seq(bwtr)
    batch = senc.encode_batch(pics)
    for i, e in enumerate(batch):
        bwtr.write_picture(i, pre, e.payload, hq=True,
                           slice_sizes=e.slice_totals)
    bwtr.end_sequence()
    assert sbuf.getvalue() == bbuf.getvalue()
    for q, e in zip(qs, batch):
        np.testing.assert_array_equal(q, e.q_indices)


def test_fragment_streaming_cli_byte_identical(tmp_path):
    """--mesh with -F drives the streaming fragment path behind the CLI;
    bytes must equal the reference encoder's fragmented output."""
    import os

    from tests.test_golden import CASES, GOLDEN, _encode_args, _run_encode

    case, inp, extra = next(c for c in CASES if c[0] == "cbr_fragmented")
    src = os.path.join(GOLDEN, f"{inp}.16p2")
    out = str(tmp_path / "out.vc2")
    _run_encode(_encode_args(case, inp, extra) + ["--mesh", "1x8"], src, out)
    ref = open(os.path.join(GOLDEN, f"{case}.vc2"), "rb").read()
    assert open(out, "rb").read() == ref


@pytest.mark.parametrize("fragment_length", [0, 512],
                         ids=["whole", "fragmented"])
def test_mesh_decode_cli_bit_exact(fragment_length):
    """End-to-end mesh decode (the decode CLI's --mesh path): stream
    dispatch -> entropy unpack -> lane scatter -> shard_map synthesis ->
    format, byte-identical to the single-chip decoder for whole pictures
    AND reassembled fragments. Reference loop being paralleled:
    /root/reference/src/DecodeStream/DecodeStream.cpp:205-981."""
    import io

    from vc2tpu.cli.decode_stream import Decoder
    from vc2tpu.pipeline.encoder import Encoder

    H, W = 64, 64
    cfg = _cbr_cfg(H, W)
    enc = Encoder(cfg)
    encoded = [enc.encode_picture(p) for p in _frames(3, H, W, seed=11)]
    stream = _hq_stream(cfg, enc.geo, encoded, H, W, fragment_length)

    ref_sink = io.BytesIO()
    ref = Decoder(sink=ref_sink)
    assert ref.run(stream) == 0
    assert ref.frames_out == 3

    sink = io.BytesIO()
    dec = Decoder(sink=sink, mesh="1x8")
    assert dec.run(stream) == 0
    assert dec.frames_out == 3
    assert sink.getvalue() == ref_sink.getvalue()


@pytest.mark.parametrize("device_unpack", [
    "1",
    pytest.param("0", marks=SLOW),   # legacy host-unpack mesh route; the
                                     # default tier keeps the shipping
                                     # per-shard device-unpack route
])
def test_mesh_decode_ld_bit_exact(device_unpack, monkeypatch):
    """--mesh covers LD pictures on both unpack routes: per-shard on-device
    body entropy unpack (VC2TPU_DEVICE_UNPACK=1, only the LL DC recurrence
    host-side) and host predictive dequant + halo-exchange IDWT (=0) —
    byte-identical to the single-chip decode either way."""
    import io
    import pathlib

    from vc2tpu._native.bridge import native
    from vc2tpu.cli.decode_stream import Decoder

    if native is None:
        pytest.skip("LD decode needs the native host codec")
    monkeypatch.setenv("VC2TPU_DEVICE_UNPACK", device_unpack)
    golden = pathlib.Path(__file__).resolve().parent / "golden"
    stream = (golden / "ld_legall_d2.vc2").read_bytes()
    want = (golden / "ld_legall_d2.dec.16p2").read_bytes()
    sink = io.BytesIO()
    dec = Decoder(sink=sink, mesh="1x8")
    assert dec.run(stream) == 0
    assert sink.getvalue() == want
    # the route must actually engage: the sharded LD payload step is cached
    # under an "ld" key only when the per-shard device unpack ran
    used_dev = any(isinstance(k, tuple) and k and k[0] == "ld"
                   for sd in dec._sdec_cache.values() if sd is not None
                   for k in sd._payload_steps)
    assert used_dev == (device_unpack == "1")


def test_mesh_decode_ld_indivisible_falls_back(capsys):
    """LD interlaced fields (16 padded rows, depth 2) cannot split 8 ways
    in units of 4 — the mesh route must fall back single-chip, log once,
    and stay bit-exact."""
    import io
    import pathlib

    from vc2tpu._native.bridge import native
    from vc2tpu.cli.decode_stream import Decoder

    if native is None:
        pytest.skip("LD decode needs the native host codec")
    golden = pathlib.Path(__file__).resolve().parent / "golden"
    stream = (golden / "ld_interlaced.vc2").read_bytes()
    want = (golden / "ld_interlaced.dec.16p2").read_bytes()
    sink = io.BytesIO()
    dec = Decoder(sink=sink, mesh="1x8")
    assert dec.run(stream) == 0
    assert sink.getvalue() == want
    err = capsys.readouterr().err
    assert err.count("decoding single-chip") == 1


def test_mesh_decode_incompatible_geometry_falls_back(capsys):
    """A stream whose slice rows do not divide over the mesh still decodes
    bit-exact through the single-chip fallback."""
    import io
    import pathlib

    from vc2tpu.cli.decode_stream import Decoder

    golden = pathlib.Path(__file__).resolve().parent / "golden"
    stream = (golden / "constq_legall_d2.vc2").read_bytes()
    want = (golden / "constq_legall_d2.dec.16p2").read_bytes()
    sink = io.BytesIO()
    dec = Decoder(sink=sink, mesh="1x7")      # 7 never divides y_slices
    assert dec.run(stream) == 0
    assert sink.getvalue() == want


def test_sharded_stream_decode_bit_exact():
    """8-way sharded decode of an encoded payload == the single-device
    synthesis, exactly (value-verified, not shape-verified)."""
    from vc2tpu.core.config import PictureGeometry
    from vc2tpu.pipeline.decoder import synthesise_lanes
    from vc2tpu.pipeline.encoder import Encoder
    from vc2tpu.pipeline.sharded import ShardedDecoder
    from vc2tpu.slices.hq import decode_hq_slices

    mesh = make_mesh(data=1, space=8)
    H, W = 64, 64
    cfg = _cbr_cfg(H, W)
    pic = _frames(1, H, W, seed=5)[0]
    enc = Encoder(cfg)
    e = enc.encode_picture(pic)
    payload = np.frombuffer(e.payload, np.uint8)

    sdec = ShardedDecoder(cfg.kernel, cfg.wavelet_depth, enc.geo, mesh)
    y, c1, c2 = sdec.decode_payload(payload, cfg.slice_prefix,
                                    cfg.slice_scalar)

    geo = enc.geo
    Ly = geo.luma_slice[0] * geo.luma_slice[1]
    Lc = geo.chroma_slice[0] * geo.chroma_slice[1]
    data = decode_hq_slices(payload, geo.n_slices, cfg.slice_prefix,
                            cfg.slice_scalar, (Ly, Lc, Lc))
    ref = synthesise_lanes(*data.lanes, data.q_indices,
                           enc.qmatrix, cfg.kernel, cfg.wavelet_depth, geo,
                           PictureGeometry.of(H, W, cfg.chroma_format),
                           cfg.chroma_format)
    np.testing.assert_array_equal(y[:H, :W], np.asarray(ref.y))
    np.testing.assert_array_equal(c1[:H, :W // 2], np.asarray(ref.c1))
    np.testing.assert_array_equal(c2[:H, :W // 2], np.asarray(ref.c2))

    # per-shard ON-DEVICE entropy unpack (make_sharded_payload_decode_step)
    # must equal the host-unpacked lane path exactly
    from vc2tpu.slices.hq import scan_hq_slice_offsets

    q, dstart, cbytes, _ = scan_hq_slice_offsets(
        payload, geo.n_slices, cfg.slice_prefix, cfg.slice_scalar)
    y2, c12, c22 = sdec.decode_payload_device(payload, q, dstart, cbytes)
    np.testing.assert_array_equal(y2, y)
    np.testing.assert_array_equal(c12, c1)
    np.testing.assert_array_equal(c22, c2)
