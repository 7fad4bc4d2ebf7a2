"""Headline benchmark: 1080p HQ decode frames/s, end-to-end (stream bytes ->
entropy unpack -> dequant + IDWT -> planar output bytes, adaptive route).

Prints ONE JSON line on stdout:
  {"metric": "hq_decode_1080p_fps", "value": N, "unit": "frames/s",
   "vs_baseline": N / 1.32}

plus a machine-readable secondary tail on stderr
(``bench-tail: {...}``) covering every BASELINE.md comparison row AND the
device-route / device-compute-only numbers the adaptive routing would
otherwise hide. Both lines name the device (platform, device_kind, count);
the script fails when JAX finds no GPU:

* hq_decode_1080p_fps            — auto route (the headline)
* hq_decode_1080p_device_fps     — VC2TPU_DECODE_ROUTE=device, transfers included
* cbr_decode_1080p_fps, ld_decode_1080p_fps, cbr_decode_4k_fps
* constq_encode_1080p_fps, cbr_encode_1080p_fps, ld_encode_1080p_fps,
  cbr_encode_4k_fps
* device_constq_analyse_ms, device_cbr_analyse_ms, device_cbr_search_ms,
  device_decode_synth_ms, device_decode_step_ms (+ the derived
  device_hq_decode_fps_per_chip: the FULL on-chip decode — on-device
  entropy unpack + dequant + IDWT + output format) — on-chip ms/frame with
  transfers excluded: the dependent chain runs inside one jitted fori_loop
  dispatch and the slope between two loop lengths cancels dispatch latency
  and the finishing fetch.
* device_ld_encode_step_ms — the full on-chip LD encode step (DWT +
  wavefront rate control rdo/ld.py + quantise + bit-granular pack).
* device_{cbr_encode,decode}_step_{4k,8k}_ms — the same chains at 4K/8K
  (BASELINE configs #4/#5, single device).
* device_{cbr_encode,decode}_step_{dd137_d3,fidelity_d2}_ms — the on-chip
  kernel matrix: one encode + decode chain per non-flagship kernel family
  so the fps/chip story is not LeGall-depth-2-only.

Baseline denominators: the reference binaries compiled at -O2 on this host,
measured 2026-08-17 on exactly this content family (BASELINE.md round-2
re-measurement + round-3 4K decode row).

Config matches BASELINE.json config #1 / BASELINE.md: 1920x1080 4:2:2 10-bit,
HQ ConstQ q=40, LeGall depth 2, 2x2 slice size (reference flags
`-x 1920 -y 1080 -f 4:2:2 -l 10 -k LeGall -d 2 -u 2 -a 2 -q 40`).
"""

from __future__ import annotations

import io
import json
import os
import sys
import time

import numpy as np

N_FRAMES = 16          # frames timed per measurement
# reference binaries at -O2 on this host, measured on exactly the
# synth_frames content family (BASELINE.md "round-2 re-measurement";
# 4K decode row added round 3)
BASELINES = {
    "hq_decode_1080p_fps": 1.32,       # DecodeStream, HQ ConstQ stream
    "hq_decode_1080p_device_fps": 1.32,
    "cbr_decode_1080p_fps": 1.18,      # DecodeStream, HQ CBR stream
    "ld_decode_1080p_fps": 1.27,       # DecodeStream, LD stream
    "constq_encode_1080p_fps": 0.98,   # EncodeStream HQ_ConstQ
    "cbr_encode_1080p_fps": 0.152,     # EncodeStream HQ_CBR
    "ld_encode_1080p_fps": 0.37,       # EncodeStream LD
    "cbr_decode_4k_fps": 0.34,         # DecodeStream, 4K CBR (r3, best of 3)
    "cbr_encode_4k_fps": 0.049,        # EncodeStream HQ_CBR 4K (r3)
}


def synth_frames(n, h=1080, w=1920, bits=10, seed=7):
    """Deterministic synthetic video: sinusoid + noise in ALL planes — the
    same content family as tests/make_golden.py and, critically, as the
    BASELINE.md reference-binary measurements (the denominators above were
    timed on this family; pure-noise chroma would make our stream strictly
    harder than the one the reference was benchmarked on)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    cyy, cxx = np.mgrid[0:h, 0:w // 2]
    frames = []
    for i in range(n):
        base = (np.sin(xx / (19.0 + i)) * np.cos(yy / 13.0) + 1.0) / 2.0
        y = (base * (2 ** bits - 1)).astype(np.int64)
        y += rng.integers(0, 64, (h, w))
        y = np.clip(y, 0, 2 ** bits - 1).astype(np.int32)
        cb = (np.sin(cxx / (11.0 + i)) * np.cos(cyy / 17.0) + 1.0) / 2.0
        c1 = (cb * (2 ** bits - 1)).astype(np.int64)
        c1 += rng.integers(-32, 32, (h, w // 2))
        c1 = np.clip(c1, 0, 2 ** bits - 1).astype(np.int32)
        c2 = np.clip((2 ** bits - 1) - c1 // 2 +
                     rng.integers(-16, 16, (h, w // 2)),
                     0, 2 ** bits - 1).astype(np.int32)
        frames.append((y, c1, c2))
    return frames


class NullSink:
    def write(self, b):
        self.n = getattr(self, "n", 0) + len(b)


def log(msg):
    print(f"bench: {msg}", file=sys.stderr)


def build_stream(cfg, geo, encoded, h, w, bits, profile, frame_rate,
                 interlace=False):
    from vc2tpu.core import intmath
    from vc2tpu.core.config import Mode
    from vc2tpu.stream.dataunit import PicturePreamble, StreamWriter
    from vc2tpu.stream.headers import SequenceHeader

    buf = io.BytesIO()
    writer = StreamWriter(buf)
    writer.start_sequence()
    writer.write_sequence_header(SequenceHeader(
        profile=profile, height=h, width=w,
        chroma_format=cfg.chroma_format, interlace=interlace,
        frame_rate=frame_rate, top_field_first=True, bitdepth=bits))
    for i, e in enumerate(encoded):
        pre = PicturePreamble(
            wavelet_kernel=cfg.kernel, depth=cfg.wavelet_depth,
            slices_x=geo.x_slices, slices_y=geo.y_slices,
            slice_prefix=cfg.slice_prefix, slice_size_scalar=cfg.slice_scalar)
        if cfg.mode == Mode.LD:
            num, den = intmath.rationalise(cfg.compressed_bytes,
                                           geo.n_slices)
            pre.slice_bytes_numerator = num
            pre.slice_bytes_denominator = den
        writer.write_picture(i, pre, e.payload, hq=cfg.mode != Mode.LD,
                             slice_sizes=e.slice_totals)
    writer.end_sequence()
    return buf.getvalue()


def decode_fps(stream, n_frames, route=None, runs=3, label="", tail=None,
               key=None):
    """Median decode fps over `runs` repeats with the adaptive route
    COMMITTED before the timed window: the warm-up run probes (device-timed
    frame + host-timed frame) and the
    timed runs are then forced onto the committed route, so they measure
    steady-state decoding, not per-run re-probing."""
    from vc2tpu.cli.decode_stream import Decoder

    dec = Decoder(sink=NullSink(), route=route)     # warm-up (jit + probe)
    dec.run(stream)
    assert dec.frames_out == n_frames, (label, dec.frames_out, n_frames)
    committed = route or dec._route
    times = []
    for _ in range(runs):
        dec = Decoder(sink=NullSink(), route=committed)
        t0 = time.perf_counter()
        dec.run(stream)
        times.append(dec.frames_out / (time.perf_counter() - t0))
    fps = float(np.median(times))
    log(f"{label} route={committed} runs={[round(r, 2) for r in sorted(times)]}")
    if tail is not None and key:
        tail[key + "_runs"] = [round(r, 2) for r in sorted(times)]
    return fps


def encode_fps(enc, pics, runs=3, label="", tail=None, key=None):
    """Median async-pipelined encode fps over `runs` repeats of the batch."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for r in [enc.encode_picture_async(p) for p in pics]:
            r()
        times.append(len(pics) / (time.perf_counter() - t0))
    fps = float(np.median(times))
    if label:
        log(f"{label} runs={[round(r, 2) for r in sorted(times)]}")
    if tail is not None and key:
        tail[key + "_runs"] = [round(r, 2) for r in sorted(times)]
    return fps


def link_probe(tail, suffix=""):
    """Host<->device transfer metadata on the bench record: per-transfer
    latency plus H2D / D2H bandwidth of an 8 MB buffer, each timed to a
    fetched result."""
    import jax
    import jax.numpy as jnp

    lat = []
    for _ in range(3):
        t0 = time.perf_counter()
        np.asarray(jnp.zeros((8,), jnp.int32) + 1)
        lat.append(time.perf_counter() - t0)
    buf = np.arange(2_000_000, dtype=np.uint32)     # 8 MB
    h2d = d2h = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        d = jax.device_put(buf)
        np.asarray(d[:1] + np.uint32(0))
        h2d = min(h2d, time.perf_counter() - t0)
    d = jax.device_put(buf)
    np.asarray(d[:1] + np.uint32(0))
    for _ in range(2):
        dd = d + np.uint32(1)
        t0 = time.perf_counter()
        np.asarray(dd)
        d2h = min(d2h, time.perf_counter() - t0)
    lat_ms = round(float(np.median(lat)) * 1e3, 1)
    tail["link_latency_ms" + suffix] = lat_ms
    tail["link_h2d_mbps" + suffix] = round(8 / h2d, 1)
    tail["link_d2h_mbps" + suffix] = round(8 / d2h, 1)
    log(f"link{suffix or ''}: latency {lat_ms} ms, "
        f"H2D {8 / h2d:.1f} MB/s, D2H {8 / d2h:.1f} MB/s")


def cpu_probe(tail, suffix=""):
    """Host-CPU metadata, the host-side twin of link_probe: a fixed
    native-engine workload (1080p LeGall depth-2 inverse DWT, best of 3)
    timed at the start and end of the run. The host-route legs (decode,
    LD, ConstQ analysis) run on a host core that other work may share;
    this pins what the core was worth when each end of the bench ran."""
    try:
        from vc2tpu._native.bridge import native
        from vc2tpu.pipeline.host_synth import _inverted_ladder
        from vc2tpu.core.config import WaveletKernel

        if native is None:
            return
        meta, taps, shift = _inverted_ladder(WaveletKernel.LeGall)
        plane0 = (np.arange(1080 * 1920, dtype=np.int32)
                  .reshape(1080, 1920) % 997 - 498)
        best = float("inf")
        for _ in range(3):
            p = plane0.copy()
            t0 = time.perf_counter()
            native.idwt_plane(p, 2, meta, taps, shift)
            best = min(best, time.perf_counter() - t0)
        tail["cpu_idwt_1080p_ms" + suffix] = round(best * 1e3, 2)
        log(f"cpu{suffix or ''}: 1080p IDWT probe {best * 1e3:.2f} ms")
    except Exception as exc:                      # metadata must not kill bench
        log(f"cpu probe skipped ({exc})")


def chain_ms(step, n_lo=8, n_hi=40, reps=3, label=""):
    """Device-only ms per step. The dependent chain runs inside ONE jitted
    ``lax.fori_loop`` dispatch, and the slope between two loop lengths
    cancels that single dispatch plus the one-element finishing fetch.
    ``step`` maps the
    previous output pytree (None on the first, eager call) to the next
    output; its data dependency must not be foldable — derive it as
    ``prev_leaf & 1``, never ``prev_leaf * 0`` (XLA folds integer ``x*0``,
    hoists the then-invariant body out of the loop, and times nothing)."""
    import jax
    from jax import lax

    init = step(None)
    body = lambda i, c: step(c)
    run_lo = jax.jit(lambda c: lax.fori_loop(0, n_lo, body, c))
    run_hi = jax.jit(lambda c: lax.fori_loop(0, n_hi, body, c))

    def force(c):
        return np.asarray(jax.tree_util.tree_leaves(c)[0].ravel()[:1])

    force(run_lo(init))
    force(run_hi(init))               # absorb both compiles
    times = {}
    for nm, run in (("lo", run_lo), ("hi", run_hi)):
        best = float("inf")
        c = init
        for _ in range(reps):
            t0 = time.perf_counter()
            c = run(c)
            force(c)
            best = min(best, time.perf_counter() - t0)
        times[nm] = best
    dt = max((times["hi"] - times["lo"]) / (n_hi - n_lo) * 1e3, 0.0)
    log(f"device chain {label}: {dt:.2f} ms/step (lo {times['lo']*1e3:.0f} ms"
        f"/{n_lo}, hi {times['hi']*1e3:.0f} ms/{n_hi})")
    return dt


def _kernel_chain(kernel, depth, y_size, x_size, pic, h, w, bits, tail,
                  tag):
    """One on-chip CBR encode step + one full decode step for a non-flagship
    (kernel, depth) at 1080p — the fps/chip kernel matrix. Mirrors the
    LeGall chains in main(); reference ladders:
    /root/reference/src/Library/src/WaveletTransform.cpp:478-1265."""
    import jax
    import jax.numpy as jnp

    from vc2tpu.core.config import (ColourFormat, EncoderConfig, FrameRate,
                                    Mode)
    from vc2tpu.pipeline.decoder import (_bucket, _bucket_bytes,
                                         _payload_synthesis_fn)
    from vc2tpu.pipeline.encoder import Encoder
    from vc2tpu.slices.hq import scan_hq_slice_offsets
    from vc2tpu.vlc import device_pack, device_unpack

    cfg = EncoderConfig(height=h, width=w, chroma_format=ColourFormat.CF422,
                        kernel=kernel, wavelet_depth=depth,
                        y_size=y_size, x_size=x_size, mode=Mode.HQ_CBR,
                        luma_depth=bits, chroma_depth=bits,
                        frame_rate=FrameRate.FR50,
                        compressed_bytes=829440, slice_scalar=2)
    enc = Encoder(cfg)
    res = enc.encode_picture(pic)
    buf, packed = enc._put_planes(pic)
    budgets = jnp.asarray(enc.slice_budgets.ravel())

    def encstep(prev):
        dep = (jnp.int32(0) if prev is None
               else (prev.ravel()[-1] & 1).astype(jnp.int32))
        r = enc._analyse(buf + dep.astype(buf.dtype), budgets,
                         packed10=packed)
        return device_pack.pack_hq_payload(
            r["qy"], r["qu"], r["qv"], r["q_indices"], budgets,
            prefix=cfg.slice_prefix, scalar=cfg.slice_scalar,
            w32=enc._w32, cap_bytes=enc._cap, cbr=True)

    ems = chain_ms(encstep, n_lo=4, n_hi=16, label=f"{tag} encode step")
    tail[f"device_cbr_encode_step_{tag}_ms"] = round(ems, 2)

    geo = enc.geo
    pl = np.frombuffer(res.payload, np.uint8)
    qs, _d, cb, _e = scan_hq_slice_offsets(pl, geo.n_slices,
                                           cfg.slice_prefix,
                                           cfg.slice_scalar)
    Ly = geo.luma_slice[0] * geo.luma_slice[1]
    Lc = geo.chroma_slice[0] * geo.chroma_slice[1]
    wc = tuple(device_unpack.window_words(
        _bucket_bytes(int(cb[c].max())), (Ly, Lc, Lc)[c]) for c in range(3))
    pfn = _payload_synthesis_fn(
        cfg.kernel, depth, (geo.y_slices, geo.x_slices, *geo.luma_slice,
                            *geo.chroma_slice), (h, w, h, w // 2),
        bits, True, cfg.slice_prefix, wc)
    pad = np.zeros(_bucket((len(pl) + 3) // 4 * 4 + 8), np.uint8)
    pad[:len(pl)] = pl
    pay = jnp.asarray(pad)
    cl = jnp.asarray(cb, jnp.int32)
    qi = jnp.asarray(np.asarray(qs), jnp.int32)
    qmb = jnp.asarray(enc.qmatrix.astype(np.int32))

    def decstep(prev):
        dep = (jnp.uint8(0) if prev is None
               else (jax.tree_util.tree_leaves(prev)[0].ravel()[0]
                     & 1).astype(jnp.uint8))
        return pfn(pay.at[-1].set(dep), cl, jnp.int32(0), qi, qmb)

    dms = chain_ms(decstep, n_lo=4, n_hi=16, label=f"{tag} decode step")
    tail[f"device_decode_step_{tag}_ms"] = round(dms, 2)


def main() -> int:
    from vc2tpu.core.config import (ColourFormat, EncoderConfig, FrameRate,
                                    Mode, Profile, WaveletKernel)
    from vc2tpu.core.picture import Picture
    from vc2tpu.pipeline.encoder import Encoder
    import jax
    import jax.numpy as jnp

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench: needs an NVIDIA GPU; JAX found platform "
                         f"{devs[0].platform!r} ({devs[0].device_kind})")
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    tail = {"device": device}
    link_probe(tail)
    cpu_probe(tail)
    h, w, bits = 1080, 1920, 10
    cfg = EncoderConfig(height=h, width=w, chroma_format=ColourFormat.CF422,
                        kernel=WaveletKernel.LeGall, wavelet_depth=2,
                        y_size=2, x_size=2, mode=Mode.HQ_ConstQ,
                        luma_depth=bits, chroma_depth=bits,
                        frame_rate=FrameRate.FR50, q_index=40)
    frames = synth_frames(N_FRAMES, h, w, bits)
    offset = 1 << (bits - 1)
    pics = [Picture(y.astype(np.int32) - offset, c1 - offset, c2 - offset,
                    ColourFormat.CF422) for (y, c1, c2) in frames]

    enc = Encoder(cfg)
    # warm-up compiles (second call absorbs the adaptive fetch-cap resize),
    # then drain the one-per-stream route probe (device-timed, host-timed,
    # commit) so the timed window measures the committed steady-state route
    enc.encode_picture(pics[0])
    enc.encode_picture(pics[0])
    for _ in range(4):
        enc.encode_picture_async(pics[0])()

    enc_fps = encode_fps(enc, pics, runs=3, tail=tail,
                         key="constq_encode_1080p_fps")
    encoded = [hd() for hd in [enc.encode_picture_async(p) for p in pics]]
    tail["constq_encode_1080p_fps"] = round(enc_fps, 3)

    stream = build_stream(cfg, enc.geo, encoded, h, w, bits,
                          Profile.PROFILE_HQ, FrameRate.FR50)
    log(f"stream {len(stream)} bytes, {len(pics)} frames, encode "
        f"{enc_fps:.2f} fps (ref {BASELINES['constq_encode_1080p_fps']}, "
        f"{enc_fps / BASELINES['constq_encode_1080p_fps']:.1f}x)")

    # headline: auto-routed decode, median of 5
    dec_fps = decode_fps(stream, len(pics), runs=5, label="decode[auto]",
                         tail=tail, key="hq_decode_1080p_fps")
    tail["hq_decode_1080p_fps"] = round(dec_fps, 3)
    # the device route itself, on the record
    try:
        dev_fps = decode_fps(stream, len(pics), route="device", runs=3,
                             label="decode[device]", tail=tail,
                             key="hq_decode_1080p_device_fps")
        tail["hq_decode_1080p_device_fps"] = round(dev_fps, 3)
    except Exception as exc:
        log(f"device-route decode skipped ({exc})")

    # secondary: CBR encode (rate-control dominated path) + CBR decode
    cbr_cfg = EncoderConfig(height=h, width=w, chroma_format=ColourFormat.CF422,
                            kernel=WaveletKernel.LeGall, wavelet_depth=2,
                            y_size=2, x_size=2, mode=Mode.HQ_CBR,
                            luma_depth=bits, chroma_depth=bits,
                            frame_rate=FrameRate.FR50,
                            compressed_bytes=829440, slice_scalar=2)
    cbr = Encoder(cbr_cfg)
    cbr.encode_picture(pics[0])
    cbr_fps = encode_fps(cbr, pics[:8], runs=3, tail=tail,
                         key="cbr_encode_1080p_fps")
    cbr_encoded = [r() for r in [cbr.encode_picture_async(p)
                                 for p in pics[:8]]]
    tail["cbr_encode_1080p_fps"] = round(cbr_fps, 3)
    log(f"CBR encode {cbr_fps:.2f} fps (ref "
        f"{BASELINES['cbr_encode_1080p_fps']}, "
        f"{cbr_fps / BASELINES['cbr_encode_1080p_fps']:.0f}x)   decode "
        f"{dec_fps:.2f} fps (ref {BASELINES['hq_decode_1080p_fps']}, "
        f"{dec_fps / BASELINES['hq_decode_1080p_fps']:.1f}x)")
    try:
        cbr_stream = build_stream(cbr_cfg, cbr.geo, cbr_encoded, h, w, bits,
                                  Profile.PROFILE_HQ, FrameRate.FR50)
        tail["cbr_decode_1080p_fps"] = round(
            decode_fps(cbr_stream, 8, runs=3, label="CBR decode",
                       tail=tail, key="cbr_decode_1080p_fps"), 3)
    except Exception as exc:
        log(f"CBR decode skipped ({exc})")

    # secondary: LD profile encode + decode (obsolete profile; host-routed)
    try:
        from vc2tpu.pipeline.ld import LDEncoder

        ld_cfg = EncoderConfig(height=h, width=w,
                               chroma_format=ColourFormat.CF422,
                               kernel=WaveletKernel.LeGall, wavelet_depth=2,
                               y_size=2, x_size=2, mode=Mode.LD,
                               luma_depth=bits, chroma_depth=bits,
                               frame_rate=FrameRate.FR50,
                               compressed_bytes=829440)
        ld = LDEncoder(ld_cfg)
        ld.encode_picture(pics[0])
        ld_times = []
        for _ in range(3):
            t0 = time.perf_counter()
            ld_encoded = [ld.encode_picture(p) for p in pics[:6]]
            ld_times.append(6 / (time.perf_counter() - t0))
        ld_fps = float(np.median(ld_times))
        tail["ld_encode_1080p_fps_runs"] = [round(r, 2)
                                            for r in sorted(ld_times)]
        tail["ld_encode_1080p_fps"] = round(ld_fps, 3)
        log(f"LD encode {ld_fps:.2f} fps (ref "
            f"{BASELINES['ld_encode_1080p_fps']}, "
            f"{ld_fps / BASELINES['ld_encode_1080p_fps']:.1f}x, "
            f"route={ld._route})")
        ld_stream = build_stream(ld_cfg, ld.geo, ld_encoded, h, w, bits,
                                 Profile.PROFILE_LD, FrameRate.FR50)
        tail["ld_decode_1080p_fps"] = round(
            decode_fps(ld_stream, 6, runs=3, label="LD decode",
                       tail=tail, key="ld_decode_1080p_fps"), 3)
    except Exception as exc:
        log(f"LD encode/decode skipped ({exc})")

    # secondary: 4K CBR encode + decode (BASELINE.json config #4 single-chip)
    try:
        k4 = EncoderConfig(height=2160, width=3840,
                           chroma_format=ColourFormat.CF422,
                           kernel=WaveletKernel.LeGall, wavelet_depth=2,
                           y_size=2, x_size=2, mode=Mode.HQ_CBR,
                           luma_depth=bits, chroma_depth=bits,
                           frame_rate=FrameRate.FR50,
                           compressed_bytes=4 * 829440, slice_scalar=2)
        enc4 = Encoder(k4)
        f4 = synth_frames(3, 2160, 3840, bits, seed=11)
        p4 = [Picture(y - offset, c1 - offset, c2 - offset, ColourFormat.CF422)
              for (y, c1, c2) in f4]
        enc4.encode_picture(p4[0])
        fps4 = encode_fps(enc4, p4, runs=3, tail=tail,
                          key="cbr_encode_4k_fps")
        enc4_res = [r() for r in [enc4.encode_picture_async(p) for p in p4]]
        tail["cbr_encode_4k_fps"] = round(fps4, 3)
        log(f"4K CBR encode {fps4:.2f} fps "
            f"(ref {BASELINES['cbr_encode_4k_fps']}, "
            f"{fps4 / BASELINES['cbr_encode_4k_fps']:.1f}x)")
        s4 = build_stream(k4, enc4.geo, enc4_res, 2160, 3840, bits,
                          Profile.PROFILE_HQ, FrameRate.FR50)
        tail["cbr_decode_4k_fps"] = round(
            decode_fps(s4, 3, runs=5, label="4K decode",
                       tail=tail, key="cbr_decode_4k_fps"), 3)
    except Exception as exc:                      # secondary must not kill bench
        log(f"4K CBR encode/decode skipped ({exc})")

    # device-compute-only chains (link excluded): what the chip itself does
    try:
        budgets_z = jnp.zeros((enc.geo.n_slices,), jnp.int32)
        budgets_c = jnp.asarray(cbr.slice_budgets.ravel())
        buf0, packed10 = enc._put_planes(pics[0])

        def constq_call(prev):
            dep = jnp.int32(0) if prev is None else (prev["qy"][0, 0] & 1)
            return enc._analyse(buf0 + dep.astype(buf0.dtype),
                                budgets_z, packed10=packed10)

        tail["device_constq_analyse_ms"] = round(
            chain_ms(constq_call, label="ConstQ analyse"), 2)

        def cbr_call(prev):
            dep = jnp.int32(0) if prev is None else (prev["qy"][0, 0] & 1)
            return cbr._analyse(buf0 + dep.astype(buf0.dtype),
                                budgets_c, packed10=packed10)

        tail["device_cbr_analyse_ms"] = round(
            chain_ms(cbr_call, label="CBR analyse"), 2)
        tail["device_cbr_search_ms"] = round(max(
            tail["device_cbr_analyse_ms"]
            - tail["device_constq_analyse_ms"], 0.0), 2)

        # full on-chip encode step (analyse + entropy pack): the fps the
        # chip itself sustains for CBR encode, transfers excluded
        from vc2tpu.vlc import device_pack

        ccfg = cbr.cfg

        def encstep_call(prev):
            dep = (jnp.int32(0) if prev is None
                   else (prev.ravel()[-1] & 1).astype(jnp.int32))
            r = cbr._analyse(buf0 + dep.astype(buf0.dtype),
                             budgets_c, packed10=packed10)
            return device_pack.pack_hq_payload(
                r["qy"], r["qu"], r["qv"], r["q_indices"], budgets_c,
                prefix=ccfg.slice_prefix, scalar=ccfg.slice_scalar,
                w32=cbr._w32, cap_bytes=cbr._cap, cbr=True)

        step_ms = chain_ms(encstep_call, label="CBR encode step")
        tail["device_cbr_encode_step_ms"] = round(step_ms, 2)
        if step_ms > 0:
            tail["device_cbr_encode_fps_per_chip"] = round(1000.0 / step_ms, 1)

        # full on-chip LD encode step (DWT + wavefront rate control +
        # quantise + bit-granular entropy pack; rdo/ld.py + pack_ld_core):
        # the LD twin of the CBR step — the reference's LD probe ladder
        # (EncodeStream.cpp:195-245) was the last host-only hot loop
        try:
            if ld._dev_consts is None:
                ld._dev_consts = (jnp.asarray(ld._avail_np),
                                  jnp.asarray(ld.slice_budgets.ravel()),
                                  jnp.asarray(ld._len_bits_np))
            availL, sizesL, lenbL = ld._dev_consts

            def ldstep_call(prev):
                dep = (jnp.uint32(0) if prev is None
                       else (prev.ravel()[-1] & 1)).astype(buf0.dtype)
                return ld._analyse_dev(buf0 + dep, availL, sizesL, lenbL,
                                       packed10=packed10, keep_planes=False)

            ld_ms = chain_ms(ldstep_call, n_lo=4, n_hi=16,
                             label="LD encode step")
            tail["device_ld_encode_step_ms"] = round(ld_ms, 2)
            if ld_ms > 0:
                tail["device_ld_encode_fps_per_chip"] = round(
                    1000.0 / ld_ms, 1)
        except Exception as exc:
            log(f"LD device chain skipped ({exc})")

        # same, at 4K (BASELINE config #4): scaling of the on-chip step
        try:
            buf4, packed4 = enc4._put_planes(p4[0])
            budgets4 = jnp.asarray(enc4.slice_budgets.ravel())
            cfg4 = enc4.cfg

            def encstep4_call(prev):
                dep = (jnp.int32(0) if prev is None
                       else (prev.ravel()[-1] & 1).astype(jnp.int32))
                r = enc4._analyse(buf4 + dep.astype(buf4.dtype),
                                  budgets4, packed10=packed4)
                return device_pack.pack_hq_payload(
                    r["qy"], r["qu"], r["qv"], r["q_indices"], budgets4,
                    prefix=cfg4.slice_prefix, scalar=cfg4.slice_scalar,
                    w32=enc4._w32, cap_bytes=enc4._cap, cbr=True)

            ms4 = chain_ms(encstep4_call, n_lo=4, n_hi=16,
                           label="4K CBR encode step")
            tail["device_cbr_encode_step_4k_ms"] = round(ms4, 2)
            if ms4 > 0:
                tail["device_cbr_encode_4k_fps_per_chip"] = round(
                    1000.0 / ms4, 1)
        except Exception as exc:
            log(f"4K device chain skipped ({exc})")

        # same, at 8K (BASELINE.json config #5's per-chip denominator, the
        # single-device step that row-band sharding divides). One retry
        # around the long 8K compile
        for _attempt in (1, 2):
          try:
            k8 = EncoderConfig(
                height=4320, width=7680, chroma_format=ColourFormat.CF422,
                kernel=WaveletKernel.LeGall, wavelet_depth=2,
                y_size=2, x_size=2, mode=Mode.HQ_CBR,
                luma_depth=bits, chroma_depth=bits,
                frame_rate=FrameRate.FR50,
                compressed_bytes=16 * 829440, slice_scalar=2)
            enc8 = Encoder(k8)
            f8 = synth_frames(1, 4320, 7680, bits, seed=13)
            p8 = Picture(f8[0][0].astype(np.int32) - offset,
                         f8[0][1] - offset, f8[0][2] - offset,
                         ColourFormat.CF422)
            enc8_res0 = enc8.encode_picture(p8)
            buf8, packed8 = enc8._put_planes(p8)
            budgets8 = jnp.asarray(enc8.slice_budgets.ravel())
            cfg8 = enc8.cfg

            def encstep8_call(prev):
                dep = (jnp.int32(0) if prev is None
                       else (prev.ravel()[-1] & 1).astype(jnp.int32))
                r = enc8._analyse(buf8 + dep.astype(buf8.dtype),
                                  budgets8, packed10=packed8)
                return device_pack.pack_hq_payload(
                    r["qy"], r["qu"], r["qv"], r["q_indices"], budgets8,
                    prefix=cfg8.slice_prefix, scalar=cfg8.slice_scalar,
                    w32=enc8._w32, cap_bytes=enc8._cap, cbr=True)

            ms8 = chain_ms(encstep8_call, n_lo=2, n_hi=6,
                           label="8K CBR encode step")
            tail["device_cbr_encode_step_8k_ms"] = round(ms8, 2)
            if ms8 > 0:
                tail["device_cbr_encode_8k_fps_per_chip"] = round(
                    1000.0 / ms8, 1)
            # keep what the 8K decode chain below needs, free the rest
            pl8_np = np.frombuffer(enc8_res0.payload, np.uint8)
            geo8 = enc8.geo
            qm8_np = enc8.qmatrix.astype(np.int32)
            del enc8, enc8_res0, buf8, packed8, p8, f8
            break
          except Exception as exc:
            log(f"8K device chain attempt {_attempt} failed ({exc})")

        # decode synthesis tail: dequant + IDWT + clip + format, on device
        from vc2tpu.pipeline.decoder import _synthesis_bytes_fn
        from vc2tpu.slices.hq import decode_hq_slices

        geo = enc.geo
        Ly = geo.luma_slice[0] * geo.luma_slice[1]
        Lc = geo.chroma_slice[0] * geo.chroma_slice[1]
        data = decode_hq_slices(np.frombuffer(encoded[0].payload, np.uint8),
                                geo.n_slices, cfg.slice_prefix,
                                cfg.slice_scalar, (Ly, Lc, Lc))
        combined = data.combined
        if combined is None:
            combined = np.concatenate([np.asarray(a).ravel()
                                       for a in data.lanes]).astype(np.int32)
        comb = jnp.asarray(np.asarray(combined))
        qi = jnp.asarray(np.asarray(data.q_indices), jnp.int32)
        qmb = jnp.asarray(enc.qmatrix.astype(np.int32))
        geo_key = (geo.y_slices, geo.x_slices, *geo.luma_slice,
                   *geo.chroma_slice)
        out_key = (h, w, h, w // 2)
        sfn = _synthesis_bytes_fn(cfg.kernel, cfg.wavelet_depth, geo_key,
                                  out_key, bits, True)

        def synth_call(prev):
            dep = (jnp.uint32(0) if prev is None
                   else (jax.tree_util.tree_leaves(prev)[0].ravel()[0] & 1))
            return sfn(comb + dep.astype(comb.dtype), qi, qmb)

        tail["device_decode_synth_ms"] = round(
            chain_ms(synth_call, label="decode synth"), 2)

        # FULL on-chip decode step (on-device entropy unpack + dequant +
        # IDWT + output format, vlc/device_unpack.py): payload bytes in,
        # formatted words out — the decode analogue of the encode-step
        # fps/chip metric. The loop dependency lands in a pad byte beyond
        # the last slice (bound-masked, so the decode is unaffected but the
        # unpack cannot be hoisted out of the fori_loop).
        from vc2tpu.pipeline.decoder import (_bucket, _bucket_bytes,
                                             _payload_synthesis_fn)
        from vc2tpu.slices.hq import scan_hq_slice_offsets
        from vc2tpu.vlc import device_unpack

        pl0 = np.frombuffer(encoded[0].payload, np.uint8)
        _qs, _ds, cbytes, _end = scan_hq_slice_offsets(
            pl0, geo.n_slices, cfg.slice_prefix, cfg.slice_scalar)
        word_counts = tuple(
            device_unpack.window_words(
                _bucket_bytes(int(cbytes[c].max())), (Ly, Lc, Lc)[c])
            for c in range(3))
        pfn = _payload_synthesis_fn(cfg.kernel, cfg.wavelet_depth, geo_key,
                                    out_key, bits, True, cfg.slice_prefix,
                                    word_counts)
        padded = np.zeros(_bucket((len(pl0) + 3) // 4 * 4 + 8), np.uint8)
        padded[:len(pl0)] = pl0
        pay_dev = jnp.asarray(padded)
        clens_dev = jnp.asarray(cbytes, jnp.int32)

        def decstep_call(prev):
            dep = (jnp.uint8(0) if prev is None
                   else (jax.tree_util.tree_leaves(prev)[0].ravel()[0] & 1
                         ).astype(jnp.uint8))
            return pfn(pay_dev.at[-1].set(dep), clens_dev, jnp.int32(0),
                       qi, qmb)

        dec_ms = chain_ms(decstep_call, n_lo=4, n_hi=16,
                          label="full decode step")
        tail["device_decode_step_ms"] = round(dec_ms, 2)
        if dec_ms > 0:
            tail["device_hq_decode_fps_per_chip"] = round(1000.0 / dec_ms, 1)

        # same, at 4K: the decode twin of device_cbr_encode_step_4k_ms
        try:
            pl4 = np.frombuffer(enc4_res[0].payload, np.uint8)
            q4s, _d4, cb4, _e4 = scan_hq_slice_offsets(
                pl4, enc4.geo.n_slices, k4.slice_prefix, k4.slice_scalar)
            geo4 = enc4.geo
            Ly4 = geo4.luma_slice[0] * geo4.luma_slice[1]
            Lc4 = geo4.chroma_slice[0] * geo4.chroma_slice[1]
            wc4 = tuple(
                device_unpack.window_words(
                    _bucket_bytes(int(cb4[c].max())), (Ly4, Lc4, Lc4)[c])
                for c in range(3))
            pfn4 = _payload_synthesis_fn(
                k4.kernel, k4.wavelet_depth,
                (geo4.y_slices, geo4.x_slices, *geo4.luma_slice,
                 *geo4.chroma_slice), (2160, 3840, 2160, 3840 // 2),
                bits, True, k4.slice_prefix, wc4)
            pad4 = np.zeros(_bucket((len(pl4) + 3) // 4 * 4 + 8), np.uint8)
            pad4[:len(pl4)] = pl4
            pay4 = jnp.asarray(pad4)
            cl4 = jnp.asarray(cb4, jnp.int32)
            qi4 = jnp.asarray(np.asarray(q4s), jnp.int32)
            qmb4 = jnp.asarray(enc4.qmatrix.astype(np.int32))

            def decstep4_call(prev):
                dep = (jnp.uint8(0) if prev is None
                       else (jax.tree_util.tree_leaves(prev)[0].ravel()[0]
                             & 1).astype(jnp.uint8))
                return pfn4(pay4.at[-1].set(dep), cl4, jnp.int32(0),
                            qi4, qmb4)

            dec4_ms = chain_ms(decstep4_call, n_lo=2, n_hi=8,
                               label="4K full decode step")
            tail["device_decode_step_4k_ms"] = round(dec4_ms, 2)
            if dec4_ms > 0:
                tail["device_hq_decode_4k_fps_per_chip"] = round(
                    1000.0 / dec4_ms, 1)
        except Exception as exc:
            log(f"4K decode chain skipped ({exc})")

        # same, at 8K (BASELINE config #5): the decode twin of
        # device_cbr_encode_step_8k_ms (same one-retry rule)
        for _attempt in (1, 2):
          try:
            q8s, _d8, cb8, _e8 = scan_hq_slice_offsets(
                pl8_np, geo8.n_slices, k8.slice_prefix, k8.slice_scalar)
            Ly8 = geo8.luma_slice[0] * geo8.luma_slice[1]
            Lc8 = geo8.chroma_slice[0] * geo8.chroma_slice[1]
            wc8 = tuple(
                device_unpack.window_words(
                    _bucket_bytes(int(cb8[c].max())), (Ly8, Lc8, Lc8)[c])
                for c in range(3))
            pfn8 = _payload_synthesis_fn(
                k8.kernel, k8.wavelet_depth,
                (geo8.y_slices, geo8.x_slices, *geo8.luma_slice,
                 *geo8.chroma_slice), (4320, 7680, 4320, 7680 // 2),
                bits, True, k8.slice_prefix, wc8)
            pad8 = np.zeros(_bucket((len(pl8_np) + 3) // 4 * 4 + 8),
                            np.uint8)
            pad8[:len(pl8_np)] = pl8_np
            pay8 = jnp.asarray(pad8)
            cl8 = jnp.asarray(cb8, jnp.int32)
            qi8 = jnp.asarray(np.asarray(q8s), jnp.int32)
            qmb8 = jnp.asarray(qm8_np)

            def decstep8_call(prev):
                dep = (jnp.uint8(0) if prev is None
                       else (jax.tree_util.tree_leaves(prev)[0].ravel()[0]
                             & 1).astype(jnp.uint8))
                return pfn8(pay8.at[-1].set(dep), cl8, jnp.int32(0),
                            qi8, qmb8)

            dec8_ms = chain_ms(decstep8_call, n_lo=2, n_hi=6,
                               label="8K full decode step")
            tail["device_decode_step_8k_ms"] = round(dec8_ms, 2)
            if dec8_ms > 0:
                tail["device_hq_decode_8k_fps_per_chip"] = round(
                    1000.0 / dec8_ms, 1)
            del pay8, pfn8, pad8, pl8_np
            break
          except NameError as exc:
            log(f"8K decode chain skipped ({exc})")   # encode chain failed
            break
          except Exception as exc:
            log(f"8K decode chain attempt {_attempt} failed ({exc})")

        # on-chip kernel matrix: the chains above are
        # LeGall-depth-2-only; measure one encode + one decode step per
        # extra kernel family so the fps/chip story covers the 8-tap
        # Fidelity ladder and a depth-3 transform too
        for kern, kd, ky, kx, tag in (
                (WaveletKernel.DD137, 3, 1, 2, "dd137_d3"),
                (WaveletKernel.Fidelity, 2, 2, 2, "fidelity_d2")):
            try:
                _kernel_chain(kern, kd, ky, kx, pics[0], h, w, bits,
                              tail, tag)
            except Exception as exc:
                log(f"{tag} chain skipped ({exc})")
    except Exception as exc:
        log(f"device chains skipped ({exc})")

    link_probe(tail, suffix="_end")   # weather drift across the run
    cpu_probe(tail, suffix="_end")
    vs = {k: round(tail[k] / BASELINES[k], 2)
          for k in tail if BASELINES.get(k)}
    print("bench-tail: " + json.dumps({**tail, "vs_baseline": vs}),
          file=sys.stderr)
    print(json.dumps({"metric": "hq_decode_1080p_fps",
                      "value": round(dec_fps, 3), "unit": "frames/s",
                      "vs_baseline": round(dec_fps / 1.32, 3),
                      "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
