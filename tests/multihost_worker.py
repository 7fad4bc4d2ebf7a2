"""Worker process for the multiprocess CPU multi-host harness
(tests/test_multihost.py). Launched N times with:

  python multihost_worker.py <coordinator> <num_procs> <proc_id> <outfile>

Each process owns 4 virtual CPU devices; the global mesh is
(data=num_procs, space=4). Every process encodes ITS OWN frame block
(frame i goes to mesh row i), the payload buffers are allgathered over the
distributed runtime, and every process assembles the identical stream;
process 0 writes it to <outfile>.
"""

import io
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main():
    coordinator, n_procs, pid, outfile = (sys.argv[1], int(sys.argv[2]),
                                          int(sys.argv[3]), sys.argv[4])
    from vc2tpu.shard import multihost

    multihost.init_distributed(coordinator, n_procs, pid)
    assert jax.process_count() == n_procs
    mesh = multihost.make_global_mesh(data=n_procs, space=4)

    from vc2tpu.core.config import (ColourFormat, EncoderConfig, FrameRate,
                                    Mode, Profile, WaveletKernel)
    from vc2tpu.core.picture import Picture
    from vc2tpu.stream.dataunit import PicturePreamble, StreamWriter
    from vc2tpu.stream.headers import SequenceHeader

    H, W = 64, 64
    cfg = EncoderConfig(height=H, width=W, chroma_format=ColourFormat.CF422,
                        kernel=WaveletKernel.LeGall, wavelet_depth=2,
                        y_size=1, x_size=2, mode=Mode.HQ_CBR,
                        luma_depth=10, chroma_depth=10,
                        frame_rate=FrameRate.FR25,
                        compressed_bytes=H * W // 2, slice_scalar=1)
    # deterministic global batch; each process materialises only its frame
    rng = np.random.default_rng(7)
    frames = [
        Picture(rng.integers(-512, 512, (H, W)).astype(np.int32),
                rng.integers(-512, 512, (H, W // 2)).astype(np.int32),
                rng.integers(-512, 512, (H, W // 2)).astype(np.int32),
                cfg.chroma_format) for _ in range(n_procs)]
    local = [frames[pid]]

    enc = multihost.MultiHostEncoder(cfg, mesh)
    encoded = enc.encode_local_batch(local)
    assert len(encoded) == n_procs

    if pid == 0:
        buf = io.BytesIO()
        wtr = StreamWriter(buf)
        wtr.start_sequence()
        wtr.write_sequence_header(SequenceHeader(
            profile=Profile.PROFILE_HQ, height=H, width=W,
            chroma_format=cfg.chroma_format, interlace=False,
            frame_rate=cfg.frame_rate, top_field_first=True, bitdepth=10))
        geo = enc.enc.geo
        for i, e in enumerate(encoded):
            wtr.write_picture(i, PicturePreamble(
                wavelet_kernel=cfg.kernel, depth=cfg.wavelet_depth,
                slices_x=geo.x_slices, slices_y=geo.y_slices,
                slice_prefix=cfg.slice_prefix,
                slice_size_scalar=cfg.slice_scalar),
                e.payload, hq=True, slice_sizes=e.slice_totals)
        wtr.end_sequence()
        with open(outfile, "wb") as f:
            f.write(buf.getvalue())

    # fragment-streaming leg: process 0 frames + writes each shard's
    # payload span incrementally (multihost.stream_fragments); every
    # process participates in the dispatch + cross-host gather
    geo = enc.enc.geo
    pre = PicturePreamble(
        wavelet_kernel=cfg.kernel, depth=cfg.wavelet_depth,
        slices_x=geo.x_slices, slices_y=geo.y_slices,
        slice_prefix=cfg.slice_prefix, slice_size_scalar=cfg.slice_scalar)
    buf2 = io.BytesIO()
    wtr2 = StreamWriter(buf2)
    wtr2.fragment_length = 256
    wtr2.start_sequence()
    if pid == 0:
        wtr2.write_sequence_header(SequenceHeader(
            profile=Profile.PROFILE_HQ, height=H, width=W,
            chroma_format=cfg.chroma_format, interlace=False,
            frame_rate=cfg.frame_rate, top_field_first=True, bitdepth=10))
    qs = enc.stream_fragments(local, wtr2, list(range(n_procs)), pre)
    if pid == 0:
        assert qs is not None and len(qs) == n_procs
        wtr2.end_sequence()
        with open(outfile + ".frag", "wb") as f:
            f.write(buf2.getvalue())
    else:
        assert qs is None

    # multi-host DECODE leg: every process parses the same fragmented
    # stream (built locally from the identical encoded batch), decodes its
    # round-robin picture block row-band-sharded over its local devices,
    # and process 0 gathers + writes the planar output
    from vc2tpu.cli.decode_stream import _format_words_host
    from vc2tpu.shard.multihost import MultiHostDecoder, collect_hq_payloads

    fbuf = io.BytesIO()
    fwtr = StreamWriter(fbuf)
    fwtr.fragment_length = 256
    fwtr.start_sequence()
    fwtr.write_sequence_header(SequenceHeader(
        profile=Profile.PROFILE_HQ, height=H, width=W,
        chroma_format=cfg.chroma_format, interlace=False,
        frame_rate=cfg.frame_rate, top_field_first=True, bitdepth=10))
    for i, e in enumerate(encoded):
        fwtr.write_picture(i, pre, e.payload, hq=True,
                           slice_sizes=e.slice_totals)
    fwtr.end_sequence()
    hdr2, items = collect_hq_payloads(fbuf.getvalue())
    assert hdr2 is not None and len(items) == n_procs

    dec = MultiHostDecoder(cfg.kernel, cfg.wavelet_depth, geo, space=4)
    frames_out = dec.decode_pictures(
        [(p, pl) for (p, _pre, pl) in items],
        cfg.slice_prefix, cfg.slice_scalar, (H, W), (H, W // 2))
    if pid == 0:
        with open(outfile + ".dec", "wb") as f:
            for (y, c1, c2) in frames_out:
                words, post = _format_words_host(y, c1, c2, 10)
                f.write(post(words))
    else:
        assert frames_out is None
    print(f"worker {pid} done", flush=True)


if __name__ == "__main__":
    main()
