"""EncodeStream-compatible CLI.

Flag surface mirrors /root/reference/src/EncodeStream/EncodeParams.cpp:80-107
so reference command lines work with this encoder, including the seven
tap outputs (Transform / Quantised / Indices / Packaged / Stream / Decoded /
PSNR — reference EncodeStream.cpp:486-767).
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np

from vc2tpu.core import intmath
from vc2tpu.core.config import (ColourFormat, EncOutput, EncoderConfig, FrameRate,
                                Mode, PictureGeometry, Profile, WaveletKernel)
from vc2tpu.core.picture import Picture, interleave_fields, signal_clip
from vc2tpu.core.planario import PlanarReader, SampleFormat, encode_plane, write_picture
from vc2tpu.pipeline.encoder import Encoder
from vc2tpu.pipeline import ld as ld_pipeline
from vc2tpu.stream.dataunit import PicturePreamble, StreamWriter
from vc2tpu.stream.headers import SequenceHeader


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vc2tpu-encode",
        description="Encodes an uncompressed planar video file with the "
                    "JAX VC-2 encoder")
    p.add_argument("inFile")
    p.add_argument("outFile")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-m", "--mode", required=True,
                   choices=[m.value for m in Mode])
    p.add_argument("-o", "--output", default="Stream",
                   choices=[o.value for o in EncOutput])
    p.add_argument("-a", "--hSlice", type=int, required=True)
    p.add_argument("-u", "--vSlice", type=int, required=True)
    p.add_argument("-d", "--waveletDepth", type=int, required=True)
    p.add_argument("-k", "--kernel", required=True,
                   choices=[k.name for k in WaveletKernel if k.name != "NullKernel"]
                   + ["NullKernel"])
    p.add_argument("-b", "--bottomFieldFirst", action="store_true")
    p.add_argument("-t", "--topFieldFirst", action="store_true")
    p.add_argument("-i", "--interlace", action="store_true")
    p.add_argument("-p", "--progressive", action="store_true")
    p.add_argument("-c", "--chromaDepth", type=int, default=None)
    p.add_argument("-l", "--lumaDepth", type=int, default=None)
    p.add_argument("-z", "--bitDepth", type=int, default=None)
    p.add_argument("-n", "--bytes", type=int, default=2)
    p.add_argument("-f", "--format", required=True,
                   choices=["4:4:4", "4:2:2", "4:2:0"])
    p.add_argument("-x", "--width", type=int, required=True)
    p.add_argument("-y", "--height", type=int, required=True)
    p.add_argument("-r", "--framerate", type=int, default=3)
    p.add_argument("-S", "--scalar", type=int, default=None)
    p.add_argument("-P", "--prefix", type=int, default=None)
    p.add_argument("-F", "--fragmentLength", type=int, default=None)
    p.add_argument("-s", "--compressedBytes", type=int, default=None)
    p.add_argument("-q", "--quantIndex", type=int, default=None)
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a jax.profiler trace of the run to DIR "
                        "(view with TensorBoard / xprof)")
    p.add_argument("--mesh", metavar="DxS", default=None,
                   help="encode on a DxS device mesh (frames x row-bands), "
                        "e.g. --mesh 2x4: the full sharded pipeline incl. "
                        "per-shard entropy pack for the HQ modes; LD shards "
                        "the analysis DWT (Stream output only); bytes are "
                        "identical to the single-chip path")
    return p


def config_from_args(args) -> EncoderConfig:
    """Cross-flag validation matrix of the reference CLI
    (/root/reference/src/EncodeStream/EncodeParams.cpp:139-204)."""
    mode = Mode(args.mode)
    hq = mode in (Mode.HQ_CBR, Mode.HQ_ConstQ)
    rate = mode in (Mode.HQ_CBR, Mode.LD)
    if args.bitDepth is not None and (args.lumaDepth is not None
                                      or args.chromaDepth is not None):
        raise ValueError("bitDepth is incompatible with luma depth (and/or "
                         "chroma depth): use one or the other")
    if args.progressive and args.interlace:
        raise ValueError("image can't be both interlaced and progressive: "
                         "specify one or the other")
    if args.progressive and (args.topFieldFirst or args.bottomFieldFirst):
        raise ValueError("field parity is incompatible with progressive image")
    if args.topFieldFirst and args.bottomFieldFirst:
        raise ValueError("image can't be both top field first and bottom "
                         "field first: specify one or the other")
    if not hq and args.scalar is not None:
        raise ValueError("Slice Scalar is only used in HQ_CBR and HQ_ConstQ modes")
    if not hq and args.prefix is not None:
        raise ValueError("Slice Prefix is only used in HQ_CBR and HQ_ConstQ modes")
    if not rate and args.fragmentLength is not None:
        raise ValueError("Fragment length is only used in HQ_CBR and LD modes")
    if not rate and args.compressedBytes is not None:
        raise ValueError("Compressed bytes is only used in HQ_CBR and LD modes")
    if mode != Mode.HQ_ConstQ and args.quantIndex is not None:
        raise ValueError("Quantisation index is only used in HQ_ConstQ mode")
    if rate and args.compressedBytes is None:
        raise ValueError("Compressed bytes must be set in HQ_CBR and LD modes")
    if mode == Mode.HQ_ConstQ and args.quantIndex is None:
        raise ValueError("Quantisation index must be set in HQ_ConstQ mode")

    # None-aware (not falsy): an explicit 0 must reach the range check
    # ("bit depth must be in range 1 to 8*(bytes per sample)"), not be
    # silently replaced with the default, as the reference CLI's isSet()
    # handling does (EncodeParams.cpp:166-170)
    bit_depth = 8 * args.bytes if args.bitDepth is None else args.bitDepth
    luma_depth = bit_depth if args.lumaDepth is None else args.lumaDepth
    chroma_depth = luma_depth if args.chromaDepth is None else args.chromaDepth
    args.scalar = 1 if args.scalar is None else args.scalar
    args.prefix = 0 if args.prefix is None else args.prefix
    args.fragmentLength = args.fragmentLength or 0
    args.compressedBytes = args.compressedBytes or 0
    args.quantIndex = args.quantIndex or 0
    return EncoderConfig(
        height=args.height, width=args.width,
        chroma_format=ColourFormat.parse(args.format),
        kernel=WaveletKernel.parse(args.kernel),
        wavelet_depth=args.waveletDepth,
        y_size=args.vSlice, x_size=args.hSlice,
        mode=Mode(args.mode), bytes_per_sample=args.bytes,
        luma_depth=luma_depth, chroma_depth=chroma_depth,
        interlaced=args.interlace, top_field_first=not args.bottomFieldFirst,
        frame_rate=FrameRate(args.framerate),
        slice_scalar=args.scalar, slice_prefix=args.prefix,
        fragment_length=args.fragmentLength,
        compressed_bytes=args.compressedBytes, q_index=args.quantIndex,
    )


def _psnr(orig: np.ndarray, dec: np.ndarray, depth: int, pixels: int) -> float:
    # the reference squares per-pixel diffs in 32-bit int
    # (std::multiplies<int>, EncodeStream.cpp:710-713 — wraps for
    # |diff| > 46340) and accumulates in long long; match both exactly
    d = (orig.astype(np.int64) - dec.astype(np.int64)).astype(np.int32)
    ss = int((d * d).astype(np.int64).sum())
    if ss < 0:                   # wrapped squares can sum negative; the
        return float("nan")      # reference's sqrt(negative) prints nan
    rms = math.sqrt(ss / float(pixels)) / (1 << depth)
    return -20.0 * math.log10(rms) if rms > 0 else float("inf")


class _ShardedAdapter:
    """Drives the multi-chip pipeline (pipeline.sharded.ShardedEncoder)
    behind the single-picture CLI loop: pictures batch over the ``data``
    mesh axis (frame parallelism) and each batch runs the full sharded step
    — halo DWT, sharded RDO/quantise, per-shard entropy pack. Results are
    byte-identical to the single-chip Encoder."""

    def __init__(self, cfg, mesh_arg: str):
        from vc2tpu.pipeline.sharded import ShardedEncoder
        from vc2tpu.shard.mesh import make_mesh

        d, s = (int(v) for v in mesh_arg.lower().split("x"))
        self.impl = ShardedEncoder(cfg, make_mesh(data=d, space=s))
        self.geo = self.impl.geo
        self.data = d
        self._batch = []            # [(seq, Picture)]
        self._done = {}             # seq -> EncodedPicture
        self._seq = 0

    def _flush_batch(self, force=False):
        if not self._batch or (not force and len(self._batch) < self.data):
            return
        idxs = [i for i, _ in self._batch]
        pics = [p for _, p in self._batch]
        pad = self.data - len(pics)
        res = self.impl.encode_batch(pics + [pics[-1]] * pad)
        for i, r in zip(idxs, res):
            self._done[i] = r
        self._batch = []

    def encode_picture_async(self, picture):
        seq = self._seq
        self._seq += 1
        self._batch.append((seq, picture))
        self._flush_batch()

        def handle():
            if seq not in self._done:
                self._flush_batch(force=True)
            return self._done.pop(seq)

        return handle

    @property
    def pipeline_depth(self) -> int:
        return self.data

    def encode_picture(self, picture, keep_planes=False):
        return self.encode_picture_async(picture)()

    # -- streaming fragment mode (-F with --mesh): each shard's payload
    # span is framed and written as its device buffer lands --

    def stream_picture(self, writer, picture_number, pre, picture):
        self._frag_batch = getattr(self, "_frag_batch", [])
        self.q_log = getattr(self, "q_log", [])
        self._frag_batch.append((picture_number, pre, picture))
        if len(self._frag_batch) >= self.data:
            self.flush_stream(writer)

    def flush_stream(self, writer):
        batch = getattr(self, "_frag_batch", [])
        if not batch:
            return
        nums = [n for n, _, _ in batch]
        pics = [p for _, _, p in batch]
        pad = self.data - len(pics)
        qs = self.impl.encode_batch_to_fragments(
            pics + [pics[-1]] * pad, writer, nums, batch[0][1])
        self.q_log.extend(q.ravel() for q in qs)
        self._frag_batch = []


def run(args) -> int:
    cfg = config_from_args(args)
    output = EncOutput(args.output)
    verbose = args.verbose
    geometry = cfg.geometry
    luma_fmt = SampleFormat(word_width=cfg.bytes_per_sample,
                            bit_depth=cfg.luma_depth, offset=True)
    chroma_fmt = SampleFormat(word_width=cfg.bytes_per_sample,
                              bit_depth=cfg.chroma_depth, offset=True)

    infile = sys.stdin.buffer if args.inFile == "-" else open(args.inFile, "rb")
    outfile = sys.stdout.buffer if args.outFile == "-" else open(args.outFile, "wb")
    reader = PlanarReader(infile, geometry, luma_fmt, chroma_fmt)

    if args.mesh:
        if output != EncOutput.STREAM:
            raise ValueError("--mesh supports Stream output only")
        if cfg.mode == Mode.LD:
            # LD: the analysis DWT shards over ``space`` (halo forward);
            # the rate-control recurrence stays host, as always
            encoder = ld_pipeline.LDEncoder(cfg, mesh=args.mesh)
        else:
            encoder = _ShardedAdapter(cfg, args.mesh)
    elif cfg.mode == Mode.LD:
        encoder = ld_pipeline.LDEncoder(cfg)
    else:
        encoder = Encoder(cfg)
    geo = encoder.geo
    frame_pics = 2 if cfg.interlaced else 1
    picture_bytes = (cfg.compressed_bytes // 2 if cfg.interlaced
                     else cfg.compressed_bytes)

    if verbose:
        # operator-facing narration parity with the reference's -v
        # (EncodeStream.cpp:284-293, 349-365, 408-429)
        e = lambda *a: print(*a, file=sys.stderr)
        e()
        e(" ".join(sys.argv))
        e(f"input file = {args.inFile}")
        e(f"output file = {args.outFile}")
        e(f"mode= {cfg.mode.value}")
        e(f"bytes per sample= {cfg.bytes_per_sample}")
        e(f"luma depth (bits) = {cfg.luma_depth}")
        e(f"chroma depth (bits) = {cfg.chroma_depth}")
        e(f"height = {geometry.luma_height}")
        e(f"width = {geometry.luma_width}")
        e(f"chroma format = {args.format}")
        e(f"interlaced = {str(cfg.interlaced).lower()}")
        if cfg.interlaced:
            e(f"top field first = {str(cfg.top_field_first).lower()}")
        e(f"wavelet kernel = {cfg.kernel.name}")
        e(f"wavelet depth = {cfg.wavelet_depth}")
        e("vertical slice size (in units of 2**(wavelet depth)) = "
          f"{cfg.y_size}")
        e("horizontal slice size (in units of 2**(wavelet depth)) = "
          f"{cfg.x_size}")
        e(f"compressed bytes = {cfg.compressed_bytes}")
        e(f"output = {output.value}")
        e(f"Vertical slices per picture          = {geo.y_slices}")
        e(f"Horizontal slices per picture        = {geo.x_slices}")
        if cfg.mode == Mode.HQ_CBR:
            num, den = intmath.rationalise(picture_bytes, geo.n_slices)
            e(f"Slice bytes numerator                = {num}")
            e(f"Slice bytes denominator              = {den}")
        from vc2tpu.wavelet import matrices as _m

        qm = _m.quant_matrix(cfg.kernel, cfg.wavelet_depth)
        e("Quantisation matrix = "
          + ", ".join(str(int(v)) for v in qm))

    writer = StreamWriter(outfile)
    writer.fragment_length = (cfg.fragment_length
                              if cfg.mode in (Mode.HQ_CBR, Mode.LD) else 0)
    if output == EncOutput.STREAM:
        if verbose:
            print("\nWriting Sequence Header\n", file=sys.stderr)
        writer.start_sequence()
        profile = Profile.PROFILE_LD if cfg.mode == Mode.LD else Profile.PROFILE_HQ
        writer.write_sequence_header(SequenceHeader(
            profile=profile, height=geometry.luma_height,
            width=geometry.luma_width, chroma_format=cfg.chroma_format,
            interlace=cfg.interlaced, frame_rate=cfg.frame_rate,
            top_field_first=cfg.top_field_first, bitdepth=cfg.luma_depth))

    frame = 0
    all_q_indices = []          # quantiser-index stats (EncodeStream.cpp:676)
    keep_planes = output in (EncOutput.TRANSFORM, EncOutput.QUANTISED,
                             EncOutput.DECODED, EncOutput.PSNR)
    sig_fmt = SampleFormat(word_width=4, signed=True, offset=False)
    # STREAM one-picture software pipeline: the next frame's file read and
    # dispatch overlap the previous picture's device work + fetch
    can_pipeline = (output == EncOutput.STREAM and not keep_planes
                    and hasattr(encoder, "encode_picture_async"))
    # --mesh with -F: stream each shard's span as a fragment the moment its
    # buffer lands (pipeline.sharded.encode_batch_to_fragments) instead of
    # assembling whole-picture payloads first
    stream_frags = (args.mesh is not None and output == EncOutput.STREAM
                    and writer.fragment_length > 0)
    from collections import deque

    pending = deque()           # FIFO of (picture_number, preamble, handle)
    # pictures in flight before the oldest result is forced: 1 for the
    # single-chip pipeline; the mesh adapter needs its whole frame batch
    # dispatched before any result exists (otherwise every flush pads the
    # batch with duplicate frames and wastes the data axis)
    pipe_depth = getattr(encoder, "pipeline_depth", 1)

    def flush_one():
        picture_number, pre, handle = pending.popleft()
        enc = handle()
        all_q_indices.append(enc.q_indices.ravel())
        writer.write_picture(picture_number, pre, enc.payload,
                             hq=cfg.mode != Mode.LD,
                             slice_sizes=enc.slice_totals)

    def flush_pending():
        while pending:
            flush_one()

    while True:
        in_frame = reader.read_frame()
        if in_frame is None:
            if frame == 0:
                print("Failed to read input frame number 0", file=sys.stderr)
                return 1
            break
        if verbose:
            # per-frame narration (EncodeStream.cpp:455-603); the transform,
            # rate-control and quantise stages are one fused device dispatch
            # here, so their lines print together at dispatch time
            print(f"Reading input frame number {frame}", file=sys.stderr)
            print("Forward transform (fused)", file=sys.stderr)
            if cfg.mode in (Mode.HQ_CBR, Mode.LD):
                print("Determine quantisation indices (fused)",
                      file=sys.stderr)
            print("Quantise transform coefficients (fused)", file=sys.stderr)
            print("Split quantised coefficients into slices", file=sys.stderr)
            if output == EncOutput.STREAM:
                print("Writing compressed output to file", file=sys.stderr)
        decoded_fields = []
        frame_q_indices = []
        for pic_i in range(frame_pics):
            if cfg.interlaced:
                picture = (in_frame.first_field(cfg.top_field_first) if pic_i == 0
                           else in_frame.second_field(cfg.top_field_first))
            else:
                picture = in_frame
            if can_pipeline or stream_frags:
                picture_number = intmath.picture_number(pic_i, frame,
                                                        frame_pics)
                pre = PicturePreamble(
                    wavelet_kernel=cfg.kernel, depth=cfg.wavelet_depth,
                    slices_x=geo.x_slices, slices_y=geo.y_slices,
                    slice_prefix=cfg.slice_prefix,
                    slice_size_scalar=cfg.slice_scalar)
                if stream_frags:
                    encoder.stream_picture(writer, picture_number, pre,
                                           picture)
                    continue
                pending.append((picture_number, pre,
                                encoder.encode_picture_async(picture)))
                while len(pending) > pipe_depth:
                    flush_one()
                continue
            enc = encoder.encode_picture(picture, keep_planes=keep_planes)
            frame_q_indices.append(enc.q_indices.ravel())
            if output == EncOutput.TRANSFORM:
                write_picture(outfile, enc.transform, sig_fmt)
                continue
            if output == EncOutput.INDICES:
                outfile.write(enc.q_indices.astype(np.uint8).tobytes())
                continue
            if output == EncOutput.QUANTISED:
                write_picture(outfile, enc.quantised, sig_fmt)
                continue
            if output == EncOutput.PACKAGED:
                outfile.write(enc.payload)
                continue
            if output == EncOutput.STREAM:
                picture_number = intmath.picture_number(pic_i, frame, frame_pics)
                pre = PicturePreamble(
                    wavelet_kernel=cfg.kernel, depth=cfg.wavelet_depth,
                    slices_x=geo.x_slices, slices_y=geo.y_slices,
                    slice_prefix=cfg.slice_prefix,
                    slice_size_scalar=cfg.slice_scalar)
                if cfg.mode == Mode.LD:
                    num, den = intmath.rationalise(picture_bytes, geo.n_slices)
                    pre.slice_bytes_numerator = num
                    pre.slice_bytes_denominator = den
                writer.write_picture(picture_number, pre, enc.payload,
                                     hq=cfg.mode != Mode.LD,
                                     slice_sizes=enc.slice_totals)
                continue
            # DECODED / PSNR: in-process decode
            pic_geom = PictureGeometry.of(
                geometry.luma_height // frame_pics, geometry.luma_width,
                cfg.chroma_format)
            dec = encoder.decode_inprocess(enc, pic_geom)
            dec = signal_clip(dec, cfg.luma_depth, cfg.chroma_depth)
            decoded_fields.append(dec)
        if output in (EncOutput.DECODED, EncOutput.PSNR):
            if cfg.interlaced:
                out_frame = interleave_fields(decoded_fields[0], decoded_fields[1],
                                              cfg.top_field_first)
            else:
                out_frame = decoded_fields[0]
            ypsnr = _psnr(np.asarray(in_frame.y), np.asarray(out_frame.y),
                          cfg.luma_depth, cfg.width * cfg.height)
            upsnr = _psnr(np.asarray(in_frame.c1), np.asarray(out_frame.c1),
                          cfg.chroma_depth,
                          geometry.chroma_width * geometry.chroma_height)
            vpsnr = _psnr(np.asarray(in_frame.c2), np.asarray(out_frame.c2),
                          cfg.chroma_depth,
                          geometry.chroma_width * geometry.chroma_height)
            if output == EncOutput.DECODED:
                write_picture(outfile, out_frame, luma_fmt, chroma_fmt)
            else:
                outfile.write(f"Frame {frame}\n".encode())
                qi = np.concatenate(frame_q_indices).astype(np.float64)
                mean = float(qi.mean())
                std = float(np.sqrt((qi * qi).mean() - mean * mean))
                outfile.write(f"{mean:.2f} {std:.2f}\n".encode())
                outfile.write(f"{ypsnr:.4f} {upsnr:.4f} {vpsnr:.4f}\n".encode())
            if verbose:
                print(f"PSNR for Y/R, U/G, V/B = {ypsnr:.4f}, {upsnr:.4f}, "
                      f"{vpsnr:.4f}", file=sys.stderr)
                if output == EncOutput.DECODED:
                    print(f"Writing decoded output frame {frame}",
                          file=sys.stderr)
        all_q_indices.extend(frame_q_indices)
        frame += 1
    flush_pending()
    if stream_frags:
        encoder.flush_stream(writer)
        all_q_indices.extend(getattr(encoder, "q_log", []))
    if verbose:
        print(f"\rEnd of input reached after {frame} frames", file=sys.stderr)
    if verbose and output != EncOutput.TRANSFORM and all_q_indices:
        qi = np.concatenate(all_q_indices).astype(np.float64)
        mean = float(qi.mean())
        std = float(np.sqrt(max((qi * qi).mean() - mean * mean, 0.0)))
        print(file=sys.stderr)
        print(f"Mean, Standard Deviation of quantiser index = {mean:.2f}, "
              f"{std:.2f}", file=sys.stderr)
    if output == EncOutput.STREAM:
        writer.end_sequence()
    if args.inFile != "-":
        infile.close()
    if args.outFile != "-":
        outfile.close()
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # a JAX process otherwise reserves most of the card on first use, and
    # `encode_stream ... - | decode_stream -` puts two processes on one card
    os.environ.setdefault("XLA_PYTHON_CLIENT_PREALLOCATE", "false")
    if args.profile:
        import jax

        jax.profiler.start_trace(args.profile)
    try:
        return run(args)
    except Exception as exc:  # mirror reference's catch-all (EncodeStream.cpp:782)
        print(f"Error: {exc}")
        return 1
    finally:
        if args.profile:
            import jax

            jax.profiler.stop_trace()


if __name__ == "__main__":
    sys.exit(main())
