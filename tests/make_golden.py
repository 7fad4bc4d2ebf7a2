#!/usr/bin/env python3
"""Generate golden-stream conformance fixtures from the reference binaries.

Run once (needs the reference built via scripts/build_reference.sh):

    python tests/make_golden.py

Produces small planar inputs plus reference-encoded streams / decoded
outputs / tap outputs under tests/golden/. The fixtures are committed, so
the test suite does not depend on the reference toolchain.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
REFBIN = os.environ.get("VC2_REF_BIN", "/tmp/refbuild/bin")

# (name, width, height, format, lumaDepth, frames)
INPUTS = [
    ("tiny422", 64, 32, "4:2:2", 10, 2),
    ("tiny420", 48, 32, "4:2:0", 8, 1),
    ("tiny444", 32, 32, "4:4:4", 12, 1),
    # full-amplitude checkerboard + saturated edges: drives coefficients
    # past int16 (exercising the decoder's int32 re-decode fallback) and up
    # to the widest in-spec exp-Golomb codes (32 bits). NOTE: magnitudes
    # >= 65535 (codes > 32 bits) are deliberately NOT covered by a golden —
    # the reference's own VLC encoder overflows its 32-bit code word there
    # (unsigned int bits, /root/reference/src/Library/src/VLC.cpp:21-52,
    # shift UB) and corrupts its output, so no byte-exact conformance
    # fixture can exist; our device packer's FLAG_CODE_OVERFLOW host
    # fallback (which emits the spec-correct long codes) is covered by
    # tests/test_device_pack.py instead.
    ("extreme444", 32, 32, "4:4:4", 12, 1),
    # mid-size case: puts multi-word slice sizes and the adaptive
    # capacity-bucket/retry logic in every default suite run (the tiny
    # cases fit their first bucket)
    ("midsize422", 256, 128, "4:2:2", 10, 1),
    # full 16-bit depth: widest legal sample path (the PSNR tap's int32
    # diff-square wrap also lives here)
    ("tiny422_16", 48, 32, "4:2:2", 16, 1),
]

# (case name, input, extra encoder args)
CASES = [
    ("constq_legall_d2", "tiny422", ["-m", "HQ_ConstQ", "-k", "LeGall", "-d", "2",
                                     "-u", "1", "-a", "2", "-q", "20"]),
    ("constq_haar1_d1", "tiny422", ["-m", "HQ_ConstQ", "-k", "Haar1", "-d", "1",
                                    "-u", "2", "-a", "4", "-q", "8"]),
    ("constq_dd97_d3", "tiny422", ["-m", "HQ_ConstQ", "-k", "DD97", "-d", "3",
                                   "-u", "1", "-a", "2", "-q", "16"]),
    ("constq_dd137_d2", "tiny420", ["-m", "HQ_ConstQ", "-k", "DD137", "-d", "2",
                                    "-u", "2", "-a", "2", "-q", "12"]),
    ("constq_fidelity_d1", "tiny444", ["-m", "HQ_ConstQ", "-k", "Fidelity", "-d", "1",
                                       "-u", "4", "-a", "4", "-q", "10"]),
    ("constq_daub97_d2", "tiny444", ["-m", "HQ_ConstQ", "-k", "Daub97", "-d", "2",
                                     "-u", "2", "-a", "2", "-q", "24"]),
    ("cbr_legall_d2", "tiny422", ["-m", "HQ_CBR", "-k", "LeGall", "-d", "2",
                                  "-u", "1", "-a", "2", "-S", "1", "-s", "2048"]),
    ("cbr_scalar2_prefix3", "tiny422", ["-m", "HQ_CBR", "-k", "LeGall", "-d", "2",
                                        "-u", "1", "-a", "2", "-S", "2", "-P", "3",
                                        "-s", "4096"]),
    ("ld_legall_d2", "tiny422", ["-m", "LD", "-k", "LeGall", "-d", "2",
                                 "-u", "1", "-a", "2", "-s", "2048"]),
    ("constq_interlaced", "tiny422", ["-m", "HQ_ConstQ", "-k", "LeGall", "-d", "2",
                                      "-u", "1", "-a", "2", "-q", "20", "-i"]),
    ("cbr_fragmented", "tiny422", ["-m", "HQ_CBR", "-k", "LeGall", "-d", "2",
                                   "-u", "1", "-a", "2", "-S", "1", "-s", "2048",
                                   "-F", "512"]),
    ("ld_fragmented", "tiny422", ["-m", "LD", "-k", "LeGall", "-d", "2",
                                  "-u", "1", "-a", "2", "-s", "2048", "-F", "512"]),
    ("constq_scalar2_prefix1", "tiny422", ["-m", "HQ_ConstQ", "-k", "LeGall",
                                           "-d", "2", "-u", "1", "-a", "2",
                                           "-q", "14", "-S", "2", "-P", "1"]),
    ("constq_420_interlaced", "tiny420", ["-m", "HQ_ConstQ", "-k", "LeGall",
                                          "-d", "1", "-u", "2", "-a", "2",
                                          "-q", "10", "-i"]),
    ("cbr_interlaced", "tiny422", ["-m", "HQ_CBR", "-k", "DD137", "-d", "2",
                                   "-u", "1", "-a", "2", "-S", "1",
                                   "-s", "3072", "-i"]),
    ("constq_haar0_d2", "tiny422", ["-m", "HQ_ConstQ", "-k", "Haar0", "-d", "2",
                                    "-u", "1", "-a", "2", "-q", "12"]),
    ("constq_legall_d4", "tiny422", ["-m", "HQ_ConstQ", "-k", "LeGall", "-d", "4",
                                     "-u", "1", "-a", "2", "-q", "16",
                                     "-S", "4"]),
    ("constq_extreme_fidelity", "extreme444",
     ["-m", "HQ_ConstQ", "-k", "Fidelity", "-d", "2", "-u", "2", "-a", "2",
      "-q", "0", "-S", "8"]),
    ("cbr_midsize", "midsize422", ["-m", "HQ_CBR", "-k", "LeGall", "-d", "2",
                                   "-u", "2", "-a", "2", "-S", "2",
                                   "-s", "32768"]),
    ("ld_midsize", "midsize422", ["-m", "LD", "-k", "LeGall", "-d", "2",
                                  "-u", "2", "-a", "2", "-s", "32768"]),
    ("ld_interlaced", "tiny422", ["-m", "LD", "-k", "LeGall", "-d", "2",
                                  "-u", "1", "-a", "2", "-s", "2048", "-i"]),
    ("constq_16bit", "tiny422_16", ["-m", "HQ_ConstQ", "-k", "LeGall", "-d", "2",
                                    "-u", "1", "-a", "2", "-q", "24"]),
    ("cbr_16bit", "tiny422_16", ["-m", "HQ_CBR", "-k", "DD97", "-d", "2",
                                 "-u", "1", "-a", "2", "-S", "1", "-s", "3072"]),
]

# Cases the reference cannot decode because of defects in the reference
# itself; the .dec fixture is OUR decoder's output — a regression pin for
# the only self-consistent interpretation, sanity-checked in
# tests/test_golden.py::test_ld_interlaced_reference_defect.
#
# ld_interlaced — the reference has NO working decode path for it:
# * DecodeStream: the encoder writes the preamble slice_bytes rational
#   from the per-FIELD byte count (EncodeStream.cpp:413 with pictureBytes
#   = compressedBytes/2 at :377), but the decoder reconstructs
#   compressedBytes from that rational (DecodeStream.cpp:312) and halves
#   it AGAIN (:335) — it reads each field at half its real size, desyncs,
#   and exits ("Read bytes do not match expected parse_info_header").
# * The encoder's in-process `-o Decoded`/PSNR tap: LD quantises WITH DC
#   prediction (EncodeStream.cpp:544 quantise_transform) but the tap
#   inverse-quantises WITHOUT it (:651 inverse_quantise_transform_np), so
#   the tap's LD output is wrong (~30x the true MSE on this content).
# * DecodeFrame's LD mode has its own defects (see cli/decode_frame.py).
REF_DECODE_DEFECTS = {"ld_interlaced"}

TAP_CASES = [
    ("constq_legall_d2", "Transform"),
    ("constq_legall_d2", "Quantised"),
    ("constq_legall_d2", "Indices"),
    ("constq_legall_d2", "Packaged"),
    ("constq_legall_d2", "PSNR"),
    ("cbr_legall_d2", "Indices"),
    ("cbr_legall_d2", "PSNR"),
    ("ld_legall_d2", "Quantised"),
    ("constq_16bit", "PSNR"),       # int32 diff-square wrap domain
]


def geometry(fmt: str, w: int, h: int):
    if fmt == "4:4:4":
        return h, w
    if fmt == "4:2:2":
        return h, w // 2
    return h // 2, w // 2


def make_input(name, w, h, fmt, depth, frames):
    import zlib

    rng = np.random.default_rng(zlib.crc32(name.encode()))
    ch, cw = geometry(fmt, w, h)
    path = os.path.join(GOLDEN, f"{name}.16p2")
    shift = 16 - depth
    with open(path, "wb") as f:
        for _ in range(frames):
            for (hh, ww) in ((h, w), (ch, cw), (ch, cw)):
                yy, xx = np.mgrid[0:hh, 0:ww]
                if name.startswith("extreme"):
                    # pixel-rate checkerboard at full amplitude with
                    # saturated flat quadrants: maximal high-band energy
                    v = np.where((yy + xx) % 2 == 0, (1 << depth) - 1, 0)
                    v = np.where((yy < hh // 4) & (xx < ww // 4),
                                 (1 << depth) - 1, v)
                    v = np.where((yy >= 3 * hh // 4) & (xx >= 3 * ww // 4),
                                 0, v).astype(np.int64)
                else:
                    base = ((1 << (depth - 1))
                            + (0.4 * (1 << depth)) * np.sin(yy / 7.0)
                            * np.cos(xx / 9.0))
                    v = base.astype(np.int64) + rng.integers(-20, 20, (hh, ww))
                v = np.clip(v, 0, (1 << depth) - 1).astype(np.uint16) << shift
                f.write(v.astype(">u2").tobytes())
    return path


def run(cmd):
    subprocess.run(cmd, check=True, capture_output=True)


def main():
    os.makedirs(GOLDEN, exist_ok=True)
    enc = os.path.join(REFBIN, "EncodeStream")
    dec = os.path.join(REFBIN, "DecodeStream")
    if not os.path.exists(enc):
        print(f"reference binaries not found in {REFBIN}; "
              "run scripts/build_reference.sh first", file=sys.stderr)
        return 1
    meta = {}
    for name, w, h, fmt, depth, frames in INPUTS:
        make_input(name, w, h, fmt, depth, frames)
        meta[name] = dict(width=w, height=h, fmt=fmt, depth=depth, frames=frames)
    import json

    for case, inp, extra in CASES:
        m = meta[inp]
        base = [enc, "-x", str(m["width"]), "-y", str(m["height"]),
                "-f", m["fmt"], "-l", str(m["depth"]), "-n", "2"]
        src = os.path.join(GOLDEN, f"{inp}.16p2")
        stream = os.path.join(GOLDEN, f"{case}.vc2")
        run(base + extra + [src, stream])
        dec_out = os.path.join(GOLDEN, f"{case}.dec.16p2")
        if case in REF_DECODE_DEFECTS:
            import io

            from vc2tpu.cli.decode_stream import Decoder

            # pin only what BOTH independent synthesis routes agree on —
            # a regression in one route cannot silently become the new pin
            outs = []
            for route in ("host", "device"):
                sink = io.BytesIO()
                d = Decoder(sink=sink, route=route)
                assert d.run(open(stream, "rb").read()) == 0, (case, route)
                outs.append(sink.getvalue())
            assert outs[0] == outs[1], \
                f"{case}: host and device decode routes disagree; refusing to pin"
            with open(dec_out, "wb") as f:
                f.write(outs[0])
        else:
            run([dec, stream, dec_out])
    for case, tap in TAP_CASES:
        inp = next(i for c, i, _ in CASES if c == case)
        extra = next(e for c, _, e in CASES if c == case)
        m = meta[inp]
        base = [enc, "-x", str(m["width"]), "-y", str(m["height"]),
                "-f", m["fmt"], "-l", str(m["depth"]), "-n", "2"]
        src = os.path.join(GOLDEN, f"{inp}.16p2")
        out = os.path.join(GOLDEN, f"{case}.{tap.lower()}.raw")
        run(base + extra + ["-o", tap, src, out])
    with open(os.path.join(GOLDEN, "meta.json"), "w") as f:
        json.dump({"inputs": meta,
                   "cases": [[c, i, e] for c, i, e in CASES],
                   "taps": TAP_CASES}, f, indent=1)
    print("golden fixtures written to", GOLDEN)
    return 0


if __name__ == "__main__":
    sys.exit(main())
