"""ctypes bridge to the native host codec (vc2host.cpp).

Compiles the shared object on first use if a compiler is available; callers
fall back to the NumPy implementations when ``native`` is None. Set
VC2TPU_NO_NATIVE=1 to force the NumPy paths (used by tests to cover both).

The library is built with ``-march=native``, so its file name carries a hash
of the source, the compiler flags and the host CPU: a library built on one
machine is never loaded on another, nor after the source changes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "vc2host.cpp")
_FLAGS = ("-O3", "-fwrapv", "-shared", "-fPIC", "-std=c++14")
_ARCH_FLAGS = (("-march=native",), ())     # tried in order


def _payload_u8(payload) -> np.ndarray:
    """Byte payloads must already BE bytes: the C entry points take a
    length in BYTES (= .size) and ascontiguousarray would silently
    value-cast a wider dtype (wrapping mod 256) into garbled decodes."""
    a = np.asarray(payload)
    if a.dtype != np.uint8:
        raise TypeError(f"payload must be uint8, got {a.dtype}")
    return np.ascontiguousarray(a)


class _Native:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        i64 = ctypes.c_int64
        lib.pack_codes.argtypes = [
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            i64, i64,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ]
        lib.unpack_streams.argtypes = [
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            i64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            i64, i64,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
        lib.unpack_streams_i16.argtypes = [
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            i64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            i64, i64,
            np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ]
        lib.unpack_streams_i16.restype = ctypes.c_int
        lib.fixedpack.argtypes = [
            np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS"),
            i64, i64,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            i64, ctypes.c_int,
        ]
        lib.fixedpack.restype = i64
        lib.scan_hq_offsets.argtypes = [
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            i64, i64, i64, i64, i64,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ]
        lib.scan_hq_offsets.restype = i64
        lib.unpack10_to_be16.argtypes = [
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            i64, i64,
            np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS"),
        ]
        lib.encode_lanes.argtypes = [
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            i64,
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        ]
        lib.component_bits_used.argtypes = [
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            i64, i64,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
        p32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.ld_encode.argtypes = [p32, p32, p32, i64, i64, i64, i64, i64, i64,
                                  i64, p32, p32, p32, i64, p32, i64, p32, p32,
                                  p32, p32, p32]
        lib.ld_encode.restype = ctypes.c_int
        lib.ld_dequantise_plane.argtypes = [p32, i64, i64, i64, i64, i64, p32,
                                            p32, p32]
        p16 = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
        pu8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.idwt_plane.argtypes = [p32, i64, i64, i64, p32, p32, i64, i64]
        lib.dwt_plane.argtypes = [p32, i64, i64, i64, p32, p32, i64, i64]
        p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.ld_pack.argtypes = [p32, p32, p32, p32, i64, i64, i64, p64,
                                np.ctypeslib.ndpointer(
                                    np.uint8, flags="C_CONTIGUOUS")]
        lib.ld_pack.restype = ctypes.c_int
        lib.hq_dequant_scatter.argtypes = [p16, i64, i64, p32, p32, p32,
                                           i64, i64, i64, i64, p32]
        lib.clip_format_out.argtypes = [p32, i64, i64, i64, i64, pu8]
        lib.hq_quant_gather.argtypes = [p32, i64, i64, p32, p32, p32,
                                        i64, i64, i64, i64, p32]
        lib.hq_pack_write.argtypes = [p32, p32, p32, p32, i64, i64, i64,
                                      i64, i64, p64, p64, p64, p64, pu8]
        lib.unpack_dequant_plane.argtypes = [pu8, i64, p64, p64, i64, i64,
                                             p32, p32, p32, i64, i64, i64,
                                             i64, p32]
        lib.ld_unpack_dequant.argtypes = [
            pu8, i64, i64, p32, i64, i64, i64,
            i64, p32, p32, p32, i64, i64, i64,
            i64, p32, p32, p32, i64, i64, i64,
            p32, p32, p32, p32, p32, p32, p32]
        lib.ld_ll_dequantise.argtypes = [p32, i64, i64, i64, i64, i64,
                                         i64, i64, p32, p32, p32, i64]
        lib.ld_ll_dequantise_grid.argtypes = [p32, i64, i64, i64, i64, i64,
                                              i64, i64, p32, p32, p32]

    def pack_codes(self, codes, nbits, offsets, n, total_bits, out):
        self._lib.pack_codes(
            np.ascontiguousarray(codes, np.uint64),
            np.ascontiguousarray(nbits, np.uint32),
            np.ascontiguousarray(offsets, np.int64),
            int(n), int(total_bits), out)

    def unpack_streams(self, payload, buflen, starts, bounds, S, n_lanes, out):
        self._lib.unpack_streams(
            _payload_u8(payload), int(buflen),
            np.ascontiguousarray(starts, np.int64),
            np.ascontiguousarray(bounds, np.int64),
            int(S), int(n_lanes), out)

    def unpack_streams_i16(self, payload, buflen, starts, bounds, S, n_lanes,
                           out, widths=None):
        if widths is None:
            widths = np.empty(int(S), np.uint8)
        return self._lib.unpack_streams_i16(
            _payload_u8(payload), int(buflen),
            np.ascontiguousarray(starts, np.int64),
            np.ascontiguousarray(bounds, np.int64),
            int(S), int(n_lanes), out, widths)

    def unpack10_to_be16(self, words, n_samples):
        out = np.empty(int(n_samples), np.uint16)
        self._lib.unpack10_to_be16(
            np.ascontiguousarray(words, np.uint32), words.size,
            int(n_samples), out)
        return out

    def fixedpack(self, lanes, S, n_lanes, widths, out, start_bit,
                  widths_in=False):
        return self._lib.fixedpack(np.ascontiguousarray(lanes, np.int16),
                                   int(S), int(n_lanes), widths, out,
                                   int(start_bit), int(widths_in))

    def scan_hq_offsets(self, payload, n, prefix, scalar, start, q, dstart,
                        cbytes):
        return self._lib.scan_hq_offsets(
            _payload_u8(payload), payload.size,
            int(n), int(prefix), int(scalar), int(start), q, dstart, cbytes)

    def encode_lanes(self, lanes, codes, nbits):
        flat = np.ascontiguousarray(lanes, np.int32).ravel()
        self._lib.encode_lanes(flat, flat.size, codes, nbits)

    def component_bits_used(self, lanes, S, n_lanes, out):
        self._lib.component_bits_used(
            np.ascontiguousarray(lanes, np.int32), int(S), int(n_lanes), out)

    def ld_encode(self, yp, up, vp, dims, slice_grid, ts, qm_block_y, qm_block_c,
                  perm_y, perm_c, slice_bytes, q_out, qy_out, qu_out, qv_out):
        (H, W, CH, CW) = dims
        (ys, xs) = slice_grid
        c = lambda a: np.ascontiguousarray(a, np.int32)
        return self._lib.ld_encode(
            c(yp), c(up), c(vp), H, W, CH, CW, ys, xs, int(ts),
            c(qm_block_y), c(qm_block_c), c(perm_y), perm_y.size,
            c(perm_c), perm_c.size, c(slice_bytes),
            q_out, qy_out, qu_out, qv_out)

    def ld_unpack_dequant(self, payload, start_byte, slice_bytes, ys, xs, ts,
                          W, qm_lane_y, off_plane_y, off_ll_y, Ly, sliceH,
                          sliceW, CW, qm_lane_c, off_plane_c, off_ll_c, Lc,
                          csliceH, csliceW, q_out, ty, tu, tv,
                          llqy, llqu, llqv):
        self._lib.ld_unpack_dequant(
            _payload_u8(payload), payload.size,
            int(start_byte), np.ascontiguousarray(slice_bytes, np.int32),
            int(ys), int(xs), int(ts),
            int(W), qm_lane_y, off_plane_y, off_ll_y, int(Ly),
            int(sliceH), int(sliceW),
            int(CW), qm_lane_c, off_plane_c, off_ll_c, int(Lc),
            int(csliceH), int(csliceW),
            q_out, ty, tu, tv, llqy, llqu, llqv)

    def ld_ll_dequantise(self, llq, ys, xs, ts, sliceH, sliceW, qm_block,
                         q_idx, plane):
        llh, llw = llq.shape
        H, W = plane.shape
        self._lib.ld_ll_dequantise(
            np.ascontiguousarray(llq, np.int32), llh, llw, int(ys), int(xs),
            int(ts), int(sliceH), int(sliceW),
            np.ascontiguousarray(qm_block, np.int32),
            np.ascontiguousarray(q_idx, np.int32), plane, W)

    def ld_ll_dequantise_grid(self, llq, ys, xs, ts, sliceH, sliceW,
                              qm_block, q_idx):
        llh, llw = llq.shape
        out = np.empty((llh, llw), np.int32)
        self._lib.ld_ll_dequantise_grid(
            np.ascontiguousarray(llq, np.int32), llh, llw, int(ys), int(xs),
            int(ts), int(sliceH), int(sliceW),
            np.ascontiguousarray(qm_block, np.int32),
            np.ascontiguousarray(q_idx, np.int32), out)
        return out

    def ld_dequantise_plane(self, qplane, H, W, ys, xs, ts, qm_block, q_idx, out):
        self._lib.ld_dequantise_plane(
            np.ascontiguousarray(qplane, np.int32), int(H), int(W), int(ys),
            int(xs), int(ts), np.ascontiguousarray(qm_block, np.int32),
            np.ascontiguousarray(q_idx, np.int32), out)

    def idwt_plane(self, plane, depth, meta, taps, shift):
        H, W = plane.shape
        self._lib.idwt_plane(plane, H, W, int(depth), meta, taps,
                             meta.size // 5, int(shift))

    def dwt_plane(self, plane, depth, meta, taps, shift):
        H, W = plane.shape
        self._lib.dwt_plane(plane, H, W, int(depth), meta, taps,
                            meta.size // 5, int(shift))

    def ld_pack(self, q_idx, ly, lu, lv, sizes, out):
        n, Ly = ly.shape
        Lc = lu.shape[1]
        return self._lib.ld_pack(
            np.ascontiguousarray(q_idx, np.int32),
            np.ascontiguousarray(ly, np.int32),
            np.ascontiguousarray(lu, np.int32),
            np.ascontiguousarray(lv, np.int32),
            n, Ly, Lc, np.ascontiguousarray(sizes, np.int64), out)

    def hq_dequant_scatter(self, lanes, q_idx, qm_lane, off_plane,
                           xs, sh, sw, plane):
        S, L = lanes.shape
        self._lib.hq_dequant_scatter(
            lanes, S, L, np.ascontiguousarray(q_idx, np.int32), qm_lane,
            off_plane, int(xs), int(sh), int(sw), plane.shape[1], plane)

    def clip_format_out(self, plane, out_h, out_w, bitdepth, out):
        self._lib.clip_format_out(plane, plane.shape[1], int(out_h),
                                  int(out_w), int(bitdepth), out)

    def hq_quant_gather(self, plane, q_idx, qm_lane, off_plane, xs, sh, sw,
                        lanes):
        S, L = lanes.shape
        self._lib.hq_quant_gather(
            plane, S, L, np.ascontiguousarray(q_idx, np.int32), qm_lane,
            off_plane, int(xs), int(sh), int(sw), plane.shape[1], lanes)

    def unpack_dequant_plane(self, payload, starts_bits, bounds_bits, L,
                             q_idx, qm_lane, off_plane, xs, sh, sw, plane):
        self._lib.unpack_dequant_plane(
            _payload_u8(payload), payload.size,
            np.ascontiguousarray(starts_bits, np.int64),
            np.ascontiguousarray(bounds_bits, np.int64),
            starts_bits.size, int(L),
            np.ascontiguousarray(q_idx, np.int32), qm_lane, off_plane,
            int(xs), int(sh), int(sw), plane.shape[1], plane)

    def hq_pack_write(self, q_idx, ly, lu, lv, prefix, scalar, yb, ub, vb,
                      starts, out):
        n, Ly = ly.shape
        Lc = lu.shape[1]
        c64 = lambda a: np.ascontiguousarray(a, np.int64)
        self._lib.hq_pack_write(
            np.ascontiguousarray(q_idx, np.int32),
            np.ascontiguousarray(ly, np.int32),
            np.ascontiguousarray(lu, np.int32),
            np.ascontiguousarray(lv, np.int32),
            n, Ly, Lc, int(prefix), int(scalar),
            c64(yb), c64(ub), c64(vb), c64(starts), out)


def _cpu_identity() -> str:
    """What ``-march=native`` resolves from: the CPU model and feature
    flags as the kernel reports them (first processor), else the machine
    name."""
    ident = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features", "CPU part"):
                    ident.append(line.strip())
                elif not line.strip() and len(ident) > 1:
                    break
    except OSError:
        ident.append(platform.processor())
    return "\n".join(ident)


def _so_path(cpu: str | None = None) -> str:
    """Library path keyed by source, flags and host CPU."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(repr((_FLAGS, _ARCH_FLAGS)).encode())
    h.update((_cpu_identity() if cpu is None else cpu).encode())
    return os.path.join(_HERE, f"libvc2host-{h.hexdigest()[:16]}.so")


def _build() -> str | None:
    if not os.path.exists(_SRC):
        return None
    so = _so_path()
    if os.path.exists(so):
        return so
    # compile to a per-process temp name and rename into place: concurrent
    # first-use builds (parallel pytest workers, CLI + test together) must
    # never dlopen a partially written .so
    tmp = f"{so}.{os.getpid()}.tmp"
    base = list(_FLAGS) + [_SRC, "-o", tmp]
    for cxx in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if not cxx:
            continue
        for extra in _ARCH_FLAGS:
            try:
                subprocess.run([cxx, *extra, *base], check=True,
                               capture_output=True)
                os.replace(tmp, so)
                return so
            except (OSError, subprocess.CalledProcessError):
                continue
    return None


native: _Native | None = None
if not os.environ.get("VC2TPU_NO_NATIVE"):
    try:
        _path = _build()
        if _path:
            native = _Native(ctypes.CDLL(_path))
    except Exception as exc:  # pragma: no cover
        print(f"vc2tpu: native host codec unavailable ({exc}); using NumPy",
              file=sys.stderr)
        native = None
