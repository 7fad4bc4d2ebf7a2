"""Proof that the codec's main path runs on an NVIDIA GPU, bit-exact.

Run from the repository root on a machine with the card:

    python chip_smoke.py             # one card: every single-card phase
    python chip_smoke.py --cards 4   # four cards: the mesh phase only

One process owns the card(s) and starts no other JAX process. Each phase
prints one line; the first failure raises, and the script exits non-zero
without a result line. The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Single-card phases, each against an oracle independent of the code it
checks:

* device   -- the backend is a GPU; card name and power limit from
  nvidia-smi (run in a child process that does not use JAX);
* goldens  -- every case of tests/golden/meta.json encodes through
  ``encode_stream.run`` byte-identical to the reference encoder's stream,
  and decodes on the device route bit-identical to the reference decoder;
* exact    -- the quantiser exactness checks of tests/test_quant_exact.py;
* 1080p50 4:2:2 10-bit, 4 frames of ``bench.synth_frames(seed=7)``:
  HQ-CBR (the stream from ``encode_stream.run`` equals the Encoder's, and
  frame 0 equals the same Encoder run on the CPU with the gather lookup),
  the lookup-form A/B of the CBR analyse step, HQ ConstQ q=40 and LD (the
  device route equals the host route), and each stream's device decode
  (equal to the host C++ decode);
* 4K       -- one 3840x2160 HQ-CBR frame, both directions, same oracles;
* auto     -- a fresh ``Decoder()`` commits a route it measured.

Times are informational: compile time as set-up, then steady ms/frame over
work that ends on the host or in ``block_until_ready``.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden")
H1080, W1080 = 1080, 1920
H4K, W4K = 2160, 3840
BITS = 10
CBR_BYTES_1080P = 829440          # 3G-SDI class, BASELINE.json config #2
N_FRAMES = 4


class SmokeFailure(AssertionError):
    pass


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


@contextlib.contextmanager
def env(**values):
    """Set (value str) or unset (None) environment variables for a block."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def median_ms(ts) -> float:
    return float(np.median(ts)) * 1e3


def load_test_module(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class NullSink:
    def write(self, b):
        pass


# --- phases -----------------------------------------------------------------

def phase_device(count: int):
    import jax

    devs = jax.devices()
    d0 = devs[0]
    if d0.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs an NVIDIA GPU; JAX found "
                         f"platform {d0.platform!r} ({d0.device_kind})")
    require(len(devs) >= count,
            f"needs {count} cards, JAX found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        print(line.strip(), flush=True)
    say("device", f"platform={d0.platform} kind={d0.device_kind} "
        f"count={len(devs)}")
    return devs


def phase_goldens():
    """Every golden case: CLI encode (device routes) == reference stream,
    device-route decode == reference decode."""
    from vc2tpu._native.bridge import native
    from vc2tpu.cli import encode_stream
    from vc2tpu.cli.decode_stream import Decoder

    tg = load_test_module("test_golden")
    t0 = time.perf_counter()
    n = 0
    took = []
    with tempfile.TemporaryDirectory() as tmp, \
            env(VC2TPU_ENCODE_ROUTE="device", VC2TPU_DECODE_ROUTE=None):
        for case, inp, extra in tg.CASES:
            require(native is not None or not case.startswith("ld_"),
                    f"{case}: the LD profile needs the native host codec")
            t_case = time.perf_counter()
            src = os.path.join(GOLDEN, f"{inp}.16p2")
            out = os.path.join(tmp, f"{case}.vc2")
            args = encode_stream.build_parser().parse_args(
                tg._encode_args(case, inp, extra) + [src, out])
            require(encode_stream.run(args) == 0, f"{case}: encode failed")
            with open(os.path.join(GOLDEN, f"{case}.vc2"), "rb") as f:
                ref = f.read()
            with open(out, "rb") as f:
                require(f.read() == ref, f"{case}: stream differs from the "
                        "reference encoder's")
            sink = io.BytesIO()
            require(Decoder(sink=sink, route="device").run(ref) == 0,
                    f"{case}: decode failed")
            with open(os.path.join(GOLDEN, f"{case}.dec.16p2"), "rb") as f:
                require(sink.getvalue() == f.read(),
                        f"{case}: decode differs from the reference decoder's")
            n += 1
            took.append((time.perf_counter() - t_case, case))
    slowest = ", ".join(f"{c} {t:.1f} s" for t, c in sorted(took)[-3:])
    say("goldens", f"{n} cases: encode byte-identical, device decode "
        f"bit-exact ({time.perf_counter() - t0:.1f} s incl. compiles; "
        f"slowest {slowest})")


def phase_exact():
    import pytest

    from vc2tpu.quant.quantiser import mxu_tables_enabled

    tq = load_test_module("test_quant_exact")
    t0 = time.perf_counter()
    sweep = tq.make_sweep()
    tq.test_quant_exact(sweep)
    tq.test_scale_exact(sweep)
    tq.test_banded_lookup_exact()
    tq.test_banded_matches_elementwise(sweep)
    with pytest.MonkeyPatch.context() as mp:
        tq.test_mxu_route_parity(sweep, mp)
    say("exact", f"quant/scale sweep, banded lookup, both lookup forms exact "
        f"(eager and jitted; default form "
        f"{'matmul' if mxu_tables_enabled() else 'gather'}; "
        f"{time.perf_counter() - t0:.1f} s)")


def make_pictures(n, h, w, seed):
    import bench
    from vc2tpu.core.config import ColourFormat
    from vc2tpu.core.picture import Picture

    off = 1 << (BITS - 1)
    return [Picture(y - off, c1 - off, c2 - off, ColourFormat.CF422)
            for (y, c1, c2) in bench.synth_frames(n, h, w, BITS, seed=seed)]


def hq_config(h, w, mode, y_size=2, **kw):
    """1080p50-style 4:2:2 10-bit LeGall depth 2, 2x2 slices (BASELINE.json
    configs #1/#2) at any size."""
    from vc2tpu.core.config import (ColourFormat, EncoderConfig, FrameRate,
                                    WaveletKernel)

    return EncoderConfig(height=h, width=w, chroma_format=ColourFormat.CF422,
                         kernel=WaveletKernel.LeGall, wavelet_depth=2,
                         y_size=y_size, x_size=2, mode=mode, luma_depth=BITS,
                         chroma_depth=BITS, frame_rate=FrameRate.FR50, **kw)


def stream_of(cfg, geo, encoded):
    import bench
    from vc2tpu.core.config import Mode, Profile

    profile = Profile.PROFILE_LD if cfg.mode == Mode.LD else Profile.PROFILE_HQ
    return bench.build_stream(cfg, geo, encoded, cfg.height, cfg.width, BITS,
                              profile, cfg.frame_rate)


def timed_encodes(encode, pics):
    """(set-up s, steady ms/frame, encoded pictures): two warm-up calls
    compile and settle the adaptive payload buckets (the second may
    recompile once); the frames are then encoded, each to host bytes."""
    t0 = time.perf_counter()
    encode(pics[0])
    encode(pics[0])
    compile_s = time.perf_counter() - t0
    out, ts = [], []
    for p in pics:
        t0 = time.perf_counter()
        out.append(encode(p))
        ts.append(time.perf_counter() - t0)
    return compile_s, median_ms(ts), out


def check_same_pictures(a, b, what):
    require(len(a) == len(b), f"{what}: {len(a)} vs {len(b)} pictures")
    for i, (x, y) in enumerate(zip(a, b)):
        require(np.array_equal(x.q_indices, y.q_indices),
                f"{what}: frame {i} quantiser indices differ")
        require(x.payload == y.payload, f"{what}: frame {i} payload differs")


def encode_on_cpu(cfg, pic):
    """The oracle encode: the same Encoder on the CPU backend, with the
    gather table lookup (the accelerator default is the matmul form)."""
    import jax

    from vc2tpu.pipeline.encoder import Encoder

    with jax.default_device(jax.devices("cpu")[0]), \
            env(VC2TPU_MXU_TABLES="0"):
        return Encoder(cfg).encode_picture(pic)


def decode_both_routes(phase, stream, n_frames):
    """Device-route decode == host C++ decode; returns the decoded bytes."""
    from vc2tpu.cli.decode_stream import Decoder

    out = {}
    for route in ("device", "host"):
        sink = io.BytesIO()
        t0 = time.perf_counter()
        require(Decoder(sink=sink, route=route).run(stream) == 0,
                f"{phase} decode[{route}] failed")
        first_s = time.perf_counter() - t0
        dec = Decoder(sink=NullSink(), route=route)
        t0 = time.perf_counter()
        dec.run(stream)
        steady = (time.perf_counter() - t0) / n_frames * 1e3
        require(dec.frames_out == n_frames,
                f"{phase} decode[{route}]: {dec.frames_out} frames")
        out[route] = sink.getvalue()
        say(phase, f"decode[{route}] first run {first_s:.2f} s (compile "
            f"incl.), steady {steady:.2f} ms/frame")
    require(out["device"] == out["host"],
            f"{phase}: device decode differs from the host decode")
    say(phase, f"decode device == host ({len(out['host'])} bytes)")
    return out["host"]


def analyse_step_ms(enc, pic, reps=10):
    """Device time of the jitted analyse step (DWT, rate control,
    quantise), block_until_ready around each call; returns (ms, outputs)."""
    import jax

    budgets = enc._budgets()
    buf, packed = enc._put_planes(pic)
    res = jax.block_until_ready(enc._analyse(buf, budgets, packed10=packed))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(enc._analyse(buf, budgets, packed10=packed))
        ts.append(time.perf_counter() - t0)
    return median_ms(ts), {k: np.asarray(v) for k, v in res.items()}


def write_planar(path, pics):
    from vc2tpu.core.planario import SampleFormat, write_picture

    fmt = SampleFormat(word_width=2, bit_depth=BITS, offset=True)
    with open(path, "wb") as f:
        for p in pics:
            write_picture(f, p, fmt)


def cli_encode(cfg, src, dst, extra):
    from vc2tpu.cli import encode_stream

    argv = ["-x", str(cfg.width), "-y", str(cfg.height), "-f", "4:2:2",
            "-l", str(BITS), "-n", "2", "-k", "LeGall", "-d", "2",
            "-u", "2", "-a", "2", "-r", str(int(cfg.frame_rate)),
            *extra, src, dst]
    args = encode_stream.build_parser().parse_args(argv)
    require(encode_stream.run(args) == 0, f"CLI encode failed: {argv}")
    with open(dst, "rb") as f:
        return f.read()


def phase_cbr(phase, h, w, compressed_bytes, pics, tmp):
    """HQ-CBR: CLI stream == Encoder stream, frame 0 == CPU encode, both
    decode routes agree. Returns the config."""
    from vc2tpu.core.config import Mode
    from vc2tpu.pipeline.encoder import Encoder

    cfg = hq_config(h, w, Mode.HQ_CBR, compressed_bytes=compressed_bytes,
                    slice_scalar=2)
    enc = Encoder(cfg)
    compile_s, steady, encoded = timed_encodes(
        lambda p: enc.encode_picture_async(p)(), pics)
    say(phase, f"encode set-up {compile_s:.2f} s, steady {steady:.2f} "
        f"ms/frame end to end (route=device: CBR has no host route)")
    step_ms, _ = analyse_step_ms(enc, pics[0])
    budgets = enc._budgets()
    buf, packed = enc._put_planes(pics[0])
    mem = enc._analyse.lower(buf, budgets,
                             packed10=packed).compile().memory_analysis()
    say(phase, f"analyse step {step_ms:.2f} ms (block_until_ready); "
        f"memory_analysis: {mem}")
    src = os.path.join(tmp, f"{phase}.16p2")
    write_planar(src, pics)
    stream = cli_encode(cfg, src, os.path.join(tmp, f"{phase}.vc2"),
                        ["-m", "HQ_CBR", "-S", "2",
                         "-s", str(compressed_bytes)])
    require(stream == stream_of(cfg, enc.geo, encoded),
            f"{phase}: encode_stream.run stream differs from the Encoder's")
    t0 = time.perf_counter()
    ref = encode_on_cpu(cfg, pics[0])
    check_same_pictures(encoded[:1], [ref], f"{phase} GPU vs CPU")
    say(phase, f"encode == CPU encode for frame 0 ({len(ref.payload)} B, "
        f"CPU {time.perf_counter() - t0:.1f} s); CLI stream == Encoder "
        f"stream ({len(stream)} B)")
    decode_both_routes(phase, stream, len(pics))
    return cfg


def phase_lookup_ab(phase, cfg, pic):
    """The CBR analyse step with the matmul and the gather table lookup:
    both exact (identical outputs), each timed on a fresh Encoder."""
    from vc2tpu.pipeline.encoder import Encoder

    res, ms = {}, {}
    for form in ("1", "0"):
        with env(VC2TPU_MXU_TABLES=form):
            ms[form], res[form] = analyse_step_ms(Encoder(cfg), pic)
    for k in res["1"]:
        require(np.array_equal(res["1"][k], res["0"][k]),
                f"{phase}: lookup forms disagree on {k}")
    say(phase, f"CBR analyse step: matmul lookup {ms['1']:.3f} ms, gather "
        f"lookup {ms['0']:.3f} ms (identical outputs)")


def counting(fn, counter, key):
    def wrapped(*a, **k):
        counter[key] = counter.get(key, 0) + 1
        return fn(*a, **k)
    return wrapped


def phase_constq(phase, h, w, pics):
    """HQ ConstQ q=40: forced device route == forced host route. Returns
    the stream and its decoded bytes."""
    from vc2tpu.core.config import Mode
    from vc2tpu.pipeline import host_synth
    from vc2tpu.pipeline.encoder import Encoder

    require(host_synth.available(), "the host route needs the native codec")
    cfg = hq_config(h, w, Mode.HQ_ConstQ, q_index=40)
    encoded = {}
    for route in ("device", "host"):
        calls = {}
        with env(VC2TPU_ENCODE_ROUTE=route):
            enc = Encoder(cfg)
            enc._encode_host = counting(enc._encode_host, calls, "host")
            compile_s, steady, encoded[route] = timed_encodes(
                lambda p: enc.encode_picture_async(p)(), pics)
        require(enc._route == route,
                f"{phase}: committed {enc._route}, forced {route}")
        require((calls.get("host", 0) > 0) == (route == "host"),
                f"{phase}: route {route} ran the host path {calls} times")
        say(phase, f"encode[{route}] set-up {compile_s:.2f} s, steady "
            f"{steady:.2f} ms/frame")
    check_same_pictures(encoded["device"], encoded["host"],
                        f"{phase} device vs host")
    stream = stream_of(cfg, enc.geo, encoded["device"])
    say(phase, f"encode device == host ({len(stream)} B stream)")
    return stream, decode_both_routes(phase, stream, len(pics))


def phase_ld(phase, h, w, compressed_bytes, pics):
    """LD: forced device route (wavefront rate control on the card) ==
    forced host route (native raster scan)."""
    from vc2tpu.core.config import Mode
    from vc2tpu.pipeline.ld import LDEncoder

    cfg = hq_config(h, w, Mode.LD, compressed_bytes=compressed_bytes)
    encoded = {}
    for route in ("device", "host"):
        calls = {}
        with env(VC2TPU_ENCODE_ROUTE=route):
            enc = LDEncoder(cfg)
            enc._encode_host = counting(enc._encode_host, calls, "host")
            compile_s, steady, encoded[route] = timed_encodes(
                enc.encode_picture, pics)
        require(enc._rdo_route == route,
                f"{phase}: committed {enc._rdo_route}, forced {route}")
        require((calls.get("host", 0) > 0) == (route == "host"),
                f"{phase}: route {route} ran the host path {calls} times")
        say(phase, f"encode[{route}] set-up {compile_s:.2f} s, steady "
            f"{steady:.2f} ms/frame")
    check_same_pictures(encoded["device"], encoded["host"],
                        f"{phase} device vs host")
    stream = stream_of(cfg, enc.geo, encoded["device"])
    say(phase, f"encode device == host ({len(stream)} B stream)")
    decode_both_routes(phase, stream, len(pics))


def phase_auto_decode(phase, stream, n_frames, want):
    """A fresh Decoder() with no route: it must commit a route it measured
    (a finite probe of the device fetch), and decode bit-exact."""
    from vc2tpu.cli.decode_stream import Decoder

    Decoder._probe_cache.clear()
    sink = io.BytesIO()
    with env(VC2TPU_DECODE_ROUTE=None):
        dec = Decoder(sink=sink)
        require(dec.run(stream) == 0, f"{phase}: decode failed")
    probes = dict(Decoder._probe_cache)
    require(dec._route in ("device", "host"),
            f"{phase}: no route committed ({dec._route})")
    require(probes and all(math.isfinite(v) for v in probes.values()),
            f"{phase}: route not measured (probe {probes})")
    require(dec.frames_out == n_frames and sink.getvalue() == want,
            f"{phase}: auto-route decode differs from the host decode")
    say(phase, f"fresh Decoder() committed route={dec._route}: host synth "
        f"{min(dec._host_probe_ts) * 1e3:.2f} ms/frame (best of "
        f"{len(dec._host_probe_ts)}) vs device fetch "
        f"{max(probes.values()) * 1e3:.3f} ms; output bit-exact")


def single_card():
    phase_goldens()
    phase_exact()
    pics = make_pictures(N_FRAMES, H1080, W1080, seed=7)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = phase_cbr("cbr_1080p", H1080, W1080, CBR_BYTES_1080P, pics,
                        tmp)
        phase_lookup_ab("lookup_ab_1080p", cfg, pics[0])
        constq, decoded = phase_constq("constq_1080p", H1080, W1080, pics)
        phase_ld("ld_1080p", H1080, W1080, CBR_BYTES_1080P, pics)
        phase_auto_decode("auto_decode_1080p", constq, len(pics), decoded)
        del pics
        pics4k = make_pictures(1, H4K, W4K, seed=11)
        phase_cbr("cbr_4k", H4K, W4K, 4 * CBR_BYTES_1080P, pics4k, tmp)


# --- four cards -------------------------------------------------------------

def mesh_case(phase, h, w, compressed_bytes, data, space, seed):
    """Sharded CBR encode on a (data, space) mesh == the single-card Encoder
    on device 0; mesh stream decode == single-card device decode."""
    import jax

    from vc2tpu.cli.decode_stream import Decoder
    from vc2tpu.core.config import Mode
    from vc2tpu.pipeline.encoder import Encoder
    from vc2tpu.pipeline.sharded import ShardedEncoder
    from vc2tpu.shard.mesh import make_mesh

    # y_size=1: 1080p's 135 slice rows at y_size=2 do not split in two
    cfg = hq_config(h, w, Mode.HQ_CBR, y_size=1,
                    compressed_bytes=compressed_bytes, slice_scalar=2)
    pics = make_pictures(data, h, w, seed=seed)
    mesh = make_mesh(data=data, space=space)
    senc = ShardedEncoder(cfg, mesh)
    t0 = time.perf_counter()
    got = senc.encode_batch(pics)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = senc.encode_batch(pics)
    steady = (time.perf_counter() - t0) / data * 1e3
    with jax.default_device(jax.devices()[0]):
        enc = Encoder(cfg)
        want = [enc.encode_picture(p) for p in pics]
    check_same_pictures(got, want, f"{phase} mesh vs single card")
    say(phase, f"mesh {data}x{space} encode first {first_s:.2f} s, steady "
        f"{steady:.2f} ms/frame; byte-identical to the single card")
    stream = stream_of(cfg, senc.geo, got)
    outs = {}
    for name, kw in (("mesh", dict(mesh=mesh)), ("single", dict(route="device"))):
        sink = io.BytesIO()
        dec = Decoder(sink=sink, **kw)
        require(dec.run(stream) == 0 and dec.frames_out == data,
                f"{phase} decode[{name}] failed")
        outs[name] = sink.getvalue()
    require(outs["mesh"] == outs["single"],
            f"{phase}: mesh decode differs from the single-card decode")
    say(phase, f"mesh decode byte-identical to the single card "
        f"({len(outs['mesh'])} B)")


def four_cards():
    """dryrun_multichip(4): the tiny sharded encode + decode checks, then
    1080p HQ-CBR on a 2x2 (data, space) mesh against the single-card
    Encoder, and its fragmented stream's mesh decode against the
    single-card decode. Then 4K on a 1x4 space mesh."""
    import __graft_entry__

    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(4)
    say("dryrun_multichip", f"4 cards, incl. 1080p on a 2x2 mesh: encode and "
        f"mesh decode byte-identical to one card "
        f"({time.perf_counter() - t0:.1f} s)")
    mesh_case("mesh_1x4_4k", H4K, W4K, 4 * CBR_BYTES_1080P, 1, 4, seed=11)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cards", type=int, choices=(1, 4), default=1,
                   help="4: run only the multi-card mesh phase")
    args = p.parse_args(argv)
    devs = phase_device(args.cards)
    t0 = time.perf_counter()
    if args.cards == 4:
        four_cards()
    else:
        single_card()
    say("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    d0 = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
