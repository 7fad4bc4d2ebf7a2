"""On-device HQ slice payload assembly (vectorised VLC entropy packing).

The reference serialises slices with a bit-serial stream writer
(/root/reference/src/Library/src/Slices.cpp:305-467 over src/VLC.cpp:120-257).
Here the ENTIRE slice payload — prefix bytes, qIndex, per-component length
bytes, bounded interleaved exp-Golomb data, byte alignment — is assembled on
the device in three fully-vectorised stages, so the only device->host transfer
of an encode step is the final compressed byte buffer:

1. per-coefficient signed exp-Golomb code words + bit lengths (the bit
   interleave is a classic mask-shift bit spread, no loops);
2. per-slice local assembly: every slice packs into a fixed-width row of
   32-bit words via a one-hot masked reduction over its coefficient lanes
   (XLA fuses the (slices, lanes, words) product into the reduction);
3. global assembly: each output byte gathers from (slice, local offset)
   found by a searchsorted over the per-slice start offsets.

Contributions into a word are bit-disjoint by construction, so integer adds
realise bitwise OR. Layout per slice (Slices.cpp:305-382): ``prefix`` zero
bytes, 1-byte qIndex, then per component {1-byte length/scalar, data,
byte-align}; CBR forces the third component to fill the slice budget.

Everything is int32/uint32; magnitudes above 2^15-ish would need >32-bit
codes and raise an overflow flag (host falls back to the exact host packer).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# flag bits returned in the header word
FLAG_CODE_OVERFLOW = 1   # a coefficient needs a >32-bit code
FLAG_SCALAR = 2          # component length byte > 255 ("scalar too small")
FLAG_CBR_FIT = 4         # CBR: y+u data exceeds the slice budget
FLAG_QINDEX = 8          # qIndex exceeds 8 bits
FLAG_W32 = 16            # a slice outgrew the w32 local row (host retries)
FLAG_VLEN = 32           # CBR: forced v length byte > 255 (distinct
                         # reference error, Slices.cpp:365)


def _spread16(x):
    """Interleave zeros between the low 16 bits: bit j -> bit 2j."""
    x = (x | (x << 8)) & jnp.uint32(0x00FF00FF)
    x = (x | (x << 4)) & jnp.uint32(0x0F0F0F0F)
    x = (x | (x << 2)) & jnp.uint32(0x33333333)
    x = (x | (x << 1)) & jnp.uint32(0x55555555)
    return x


def signed_codes(v):
    """Interleaved signed exp-Golomb code for each int32 element
    (reference VLC.cpp:21-52,68-76): (code uint32, nbits int32, overflow).

    Code bit string MSB-first: [0 u_{k-2} 0 u_{k-3} .. 0 u_0 1 s] where
    u = |v|+1 (k bits) and s the sign; zero encodes as the single bit 1.
    """
    v = v.astype(jnp.int32)
    m = jnp.abs(v)
    u = (m + 1).astype(jnp.uint32)
    # k = bit length of u, exact integer arithmetic (u <= 2^16 handled)
    k = jnp.ones(u.shape, jnp.int32)
    for j in range(1, 17):
        k = k + (u >= jnp.uint32(1 << j)).astype(jnp.int32)
    overflow = jnp.any(u >= jnp.uint32(1 << 16))
    t = u - (jnp.uint32(1) << (k - 1).astype(jnp.uint32))   # low k-1 bits
    body = (_spread16(t) << 1) | jnp.uint32(1)              # 2k-1 bits
    code = jnp.where(m > 0,
                     (body << 1) | (v < 0).astype(jnp.uint32),
                     jnp.uint32(1))
    nbits = jnp.where(m > 0, 2 * k, 1)
    return code, nbits, overflow


def bits_used(values, nbits):
    """Per-stream bit count with the trailing-zero truncation rule
    (reference Slices.cpp:97-113): gross bits up to the last non-zero.
    Every trailing zero is a 1-bit code, so this is total bits minus the
    trailing-zero run — a sum and a max instead of a cumsum."""
    L = values.shape[-1]
    idx = jnp.arange(L, dtype=jnp.int32)
    last_nz = jnp.max(jnp.where(values != 0, idx, -1), axis=-1)
    total = jnp.sum(nbits, axis=-1, dtype=jnp.int32)
    return total - (L - 1 - last_nz)


def _component(code, nb, dstart_bytes, comp_bytes):
    """Clip precomputed codes to the bounded region and attach absolute
    (local) bit offsets. Returns (code, keep_bits, off_bits)."""
    cum_ex = jnp.cumsum(nb, axis=1) - nb
    bound = (comp_bytes * 8)[:, None]
    keep = jnp.clip(bound - cum_ex, 0, nb)
    drop = (nb - keep).astype(jnp.uint32)
    code = jnp.where(keep > 0, code >> drop, jnp.uint32(0))
    off = dstart_bytes[:, None] * 8 + cum_ex
    return code, keep, off


def _parts(code, keep, off_bits):
    """Split each clipped code into its <=2 contributions to 32-bit words.
    Returns (w0, p0, p1): word index of the first word and the two
    big-endian word contributions (p1 goes to word w0+1)."""
    w0 = off_bits >> 5
    sh = off_bits & 31
    end = sh + keep
    fits = end <= 32
    s_lo = jnp.clip(32 - end, 0, 31).astype(jnp.uint32)
    s_hi = jnp.clip(end - 32, 0, 31).astype(jnp.uint32)
    p0 = jnp.where(fits, code << s_lo, code >> s_hi)
    s_sp = jnp.clip(64 - end, 0, 31).astype(jnp.uint32)
    p1 = jnp.where(fits, jnp.uint32(0), code << s_sp)
    live = keep > 0
    zero = jnp.uint32(0)
    return w0, jnp.where(live, p0, zero), jnp.where(live, p1, zero)


def _accumulate(local, w0, p0, p1, w32: int):
    """local[n, w] += sum_l p0 where w0==w  (+ p1 at w0+1), as a one-hot
    masked reduction that XLA fuses — no scatter."""
    w_axis = jnp.arange(w32, dtype=jnp.int32)
    hit0 = (w0[:, :, None] == w_axis).astype(jnp.uint32)
    hit1 = ((w0 + 1)[:, :, None] == w_axis).astype(jnp.uint32)
    # dtype=uint32: a plain sum of uint32 promotes to uint64 under x64 and
    # the whole downstream assembly (shifts, scatter) silently pays 2x width
    local = local + jnp.sum(p0[:, :, None] * hit0, axis=1, dtype=jnp.uint32)
    local = local + jnp.sum(p1[:, :, None] * hit1, axis=1, dtype=jnp.uint32)
    return local


def pack_hq_core(qy, qu, qv, q_idx, slice_sizes, *, prefix: int,
                 scalar: int, w32: int, cap_bytes: int, cbr: bool):
    """Assemble the full HQ slice payload on device. Trace-level core — call
    pack_hq_payload for the jitted single-chip entry, or call this directly
    inside shard_map (the sharded encode step packs each shard's slice run
    locally; per-shard payloads are contiguous by construction).

    qy/qu/qv: (N, L_comp) quantised lanes (any int dtype); q_idx: (N,);
    slice_sizes: (N,) CBR byte budgets (ignored unless cbr).
    w32: static words per slice row (>= ceil(max slice bytes / 4)).
    cap_bytes: static output payload capacity (CBR: the exact total).

    Returns one uint8 buffer: [flags u32 | q_idx i32*N | totals i32*N |
    payload bytes (cap_bytes)]. Host slices payload[:totals.sum()].
    """
    n = qy.shape[0]
    qy = qy.astype(jnp.int32)
    qu = qu.astype(jnp.int32)
    qv = qv.astype(jnp.int32)
    flags = jnp.uint32(0)

    comp_codes = []
    comp_scaled = []
    for vals in (qy, qu, qv):
        code, nb, ovf = signed_codes(vals)
        flags = flags | jnp.where(ovf, jnp.uint32(FLAG_CODE_OVERFLOW),
                                  jnp.uint32(0))
        used = bits_used(vals, nb)
        scaled = ((used + 7) // 8 + scalar - 1) // scalar
        comp_scaled.append(scaled)
        comp_codes.append((code, nb))
    flags = flags | jnp.where(
        jnp.any(jnp.stack([jnp.max(s) for s in comp_scaled[:2]]) > 255),
        jnp.uint32(FLAG_SCALAR), jnp.uint32(0))
    yb = comp_scaled[0] * scalar
    ub = comp_scaled[1] * scalar
    if cbr:
        sizes = slice_sizes.astype(jnp.int32)
        vb = sizes - 4 - yb - ub
        need = comp_scaled[2] * scalar
        flags = flags | jnp.where(jnp.any(vb < need),
                                  jnp.uint32(FLAG_CBR_FIT), jnp.uint32(0))
        flags = flags | jnp.where(jnp.any(vb // scalar > 255),
                                  jnp.uint32(FLAG_VLEN), jnp.uint32(0))
    else:
        vb = comp_scaled[2] * scalar
        flags = flags | jnp.where(jnp.any(comp_scaled[2] > 255),
                                  jnp.uint32(FLAG_SCALAR), jnp.uint32(0))
    flags = flags | jnp.where(jnp.any(q_idx > 255), jnp.uint32(FLAG_QINDEX),
                              jnp.uint32(0))

    totals = prefix + 4 + yb + ub + vb
    flags = flags | jnp.where(jnp.max(totals) > 4 * w32,
                              jnp.uint32(FLAG_W32), jnp.uint32(0))
    starts = jnp.cumsum(totals) - totals

    # local per-slice assembly -------------------------------------------
    local = jnp.zeros((n, w32), jnp.uint32)
    dstarts = (prefix + 2 + jnp.zeros_like(yb),
               prefix + 3 + yb,
               prefix + 4 + yb + ub)
    cbytes = (yb, ub, vb)
    for c in range(3):
        code, keep, off = _component(*comp_codes[c], dstarts[c], cbytes[c])
        w0, p0, p1 = _parts(code, keep, off)
        local = _accumulate(local, w0, p0, p1, w32)

    # header bytes: qIndex + three length bytes
    hdr_off = jnp.stack([
        jnp.full((n,), prefix, jnp.int32),
        jnp.full((n,), prefix + 1, jnp.int32),
        prefix + 2 + yb,
        prefix + 3 + yb + ub,
    ], axis=1)                                            # (N, 4) byte offsets
    hdr_val = jnp.stack([
        q_idx.astype(jnp.uint32) & 0xFF,
        (yb // scalar).astype(jnp.uint32) & 0xFF,
        (ub // scalar).astype(jnp.uint32) & 0xFF,
        (vb // scalar).astype(jnp.uint32) & 0xFF,
    ], axis=1)
    hw = hdr_off >> 2
    hp = hdr_val << ((3 - (hdr_off & 3)).astype(jnp.uint32) * 8)
    local = _accumulate(local, hw, hp, jnp.zeros_like(hp), w32)

    # global assembly, in WORD space ---------------------------------------
    # Pre-shift each slice's local row to its global word alignment with
    # plain vector shifts, then scatter-add the rows at their global word
    # positions. Different slices' contributions to a shared boundary word
    # are bit-disjoint, so integer add realises OR (same invariant the
    # local accumulate relies on). On the TPU this codec was first built
    # for, this replaced a per-byte form (a slice-of-byte map over
    # cap_bytes lanes + one gathered word per OUTPUT BYTE) that took nearly
    # all of the pack's time, and beat a two-gather formulation (word->slice
    # map + OR of the <=2 contributors), which also needs the map scan.
    cap4 = (cap_bytes + 3) // 4
    basew = starts >> 2                              # first global word
    sh = ((starts & 3) * 8).astype(jnp.uint32)       # bit misalignment
    # out_rows[s, j] = slice s's bytes inside global word basew[s] + j
    lpad = jnp.pad(local, ((0, 0), (1, 0)))          # local[:, j-1]
    rpad = jnp.pad(local, ((0, 0), (0, 1)))          # local[:, j]
    shv = sh[:, None]
    out_rows = jnp.where(shv > 0,
                         (lpad << ((32 - shv) & 31)) | (rpad >> shv),
                         rpad)                        # (N, w32 + 1)
    dest = basew[:, None] + jnp.arange(w32 + 1, dtype=jnp.int32)[None, :]
    wordv = jnp.zeros((cap4,), jnp.uint32).at[dest.ravel()].add(
        out_rows.ravel(), mode="drop")
    # big-endian byte split (payload byte order within a word)
    payload = jnp.stack(
        [(wordv >> jnp.uint32(24 - 8 * b)).astype(jnp.uint8)
         for b in range(4)], axis=-1).reshape(-1)[:cap_bytes]
    # zero any bytes past the true total (VBR capacity padding)
    g = jnp.arange(cap_bytes, dtype=jnp.int32)
    total = starts[-1] + totals[-1]
    payload = jnp.where(g < total, payload, jnp.uint8(0))

    head = jnp.concatenate([
        jax.lax.bitcast_convert_type(flags[None], jnp.uint8).ravel(),
        jax.lax.bitcast_convert_type(q_idx.astype(jnp.int32),
                                     jnp.uint8).ravel(),
        jax.lax.bitcast_convert_type(totals, jnp.uint8).ravel(),
    ])
    return jnp.concatenate([head, payload])


pack_hq_payload = jax.jit(
    pack_hq_core, static_argnames=("prefix", "scalar", "w32", "cap_bytes",
                                   "cbr"))


def _component_bits(code, nb, dstart_bits, bound_bits):
    """Bit-granular twin of _component: clip each row's codes at the
    bounded region (start/length in BITS — the LD slice regions are not
    byte-aligned, reference Slices.cpp:195-303) and attach local offsets."""
    cum_ex = jnp.cumsum(nb, axis=1) - nb
    keep = jnp.clip(bound_bits[:, None] - cum_ex, 0, nb)
    drop = (nb - keep).astype(jnp.uint32)
    code = jnp.where(keep > 0, code >> drop, jnp.uint32(0))
    return code, keep, dstart_bits[:, None] + cum_ex


def _global_assemble(local, starts, w32: int, cap_bytes: int):
    """Word-space scatter-add global assembly (see pack_hq_core's inline
    rationale): pre-shift each slice's local word row to its global
    alignment, scatter-add rows at their global word positions (different
    slices' shares of a boundary word are bit-disjoint, add == OR), then
    split big-endian bytes. starts: (N,) global BYTE offsets."""
    basew = starts >> 2
    sh = ((starts & 3) * 8).astype(jnp.uint32)
    lpad = jnp.pad(local, ((0, 0), (1, 0)))
    rpad = jnp.pad(local, ((0, 0), (0, 1)))
    shv = sh[:, None]
    out_rows = jnp.where(shv > 0,
                         (lpad << ((32 - shv) & 31)) | (rpad >> shv),
                         rpad)
    dest = basew[:, None] + jnp.arange(w32 + 1, dtype=jnp.int32)[None, :]
    wordv = jnp.zeros(((cap_bytes + 3) // 4,), jnp.uint32).at[
        dest.ravel()].add(out_rows.ravel(), mode="drop")
    return jnp.stack(
        [(wordv >> jnp.uint32(24 - 8 * b)).astype(jnp.uint8)
         for b in range(4)], axis=-1).reshape(-1)[:cap_bytes]


FLAG_LD_FIT = 64         # LD: interleaved U,V data exceeds the slice's
                         # remaining bits (host raises, Slices.cpp:262-266)


def pack_ld_core(qy, qu, qv, q_idx, sizes, len_bits, *, w32: int,
                 cap_bytes: int):
    """Assemble a whole LD picture's slice payload on device.

    Wire format per slice (reference Slices.cpp:195-303): 7-bit qIndex, an
    intlog2(8*size-7)-bit luma-length field holding the truncated luma bit
    count, a bounded luma region of exactly that many bits, then the rest
    of the slice as a bounded interleaved-U,V region (u0 v0 u1 v1 ...,
    zero-filled to the slice end — unwritten bits stay 0 here, which IS the
    zero fill).

    qy/qu/qv: (N, L) quantised lanes (LL lanes predictively quantised by
    rdo/ld.ld_rate_control); q_idx: (N,); sizes: (N,) slice byte budgets;
    len_bits: (N,) static per-stream field widths intlog2(8*size-7).
    Returns uint8 [flags u32 | q i32*N | payload (cap_bytes)].
    """
    n = qy.shape[0]
    flags = jnp.uint32(0)
    sizes = sizes.astype(jnp.int32)
    len_bits = len_bits.astype(jnp.int32)

    code_y, nb_y, ovf_y = signed_codes(qy.astype(jnp.int32))
    code_u, nb_u, ovf_u = signed_codes(qu.astype(jnp.int32))
    code_v, nb_v, ovf_v = signed_codes(qv.astype(jnp.int32))
    flags = flags | jnp.where(ovf_y | ovf_u | ovf_v,
                              jnp.uint32(FLAG_CODE_OVERFLOW), jnp.uint32(0))

    y_used = bits_used(qy, nb_y)
    # interleaved chroma: u lane i sits at position 2i, v at 2i+1
    Lc = qu.shape[1]
    idx = jnp.arange(Lc, dtype=jnp.int32)
    pair = nb_u + nb_v
    gross_uv = jnp.sum(pair, axis=-1, dtype=jnp.int32)
    last_uv = jnp.maximum(
        jnp.max(jnp.where(qu != 0, 2 * idx, -1), axis=-1),
        jnp.max(jnp.where(qv != 0, 2 * idx + 1, -1), axis=-1))
    uv_used = jnp.where(last_uv >= 0,
                        gross_uv - (2 * Lc - 1 - last_uv), 0)
    uv_bits = 8 * sizes - 7 - len_bits - y_used
    flags = flags | jnp.where(jnp.any(uv_used > uv_bits),
                              jnp.uint32(FLAG_LD_FIT), jnp.uint32(0))

    local = jnp.zeros((n, w32), jnp.uint32)
    # headers: 7-bit qIndex at bit 0, luma length field at bit 7
    hdr_code = jnp.stack([q_idx.astype(jnp.uint32) & 0x7F,
                          y_used.astype(jnp.uint32)], axis=1)
    hdr_keep = jnp.stack([jnp.full((n,), 7, jnp.int32), len_bits], axis=1)
    hdr_off = jnp.stack([jnp.zeros((n,), jnp.int32),
                         jnp.full((n,), 7, jnp.int32)], axis=1)
    w0, p0, p1 = _parts(hdr_code, hdr_keep, hdr_off)
    local = _accumulate(local, w0, p0, p1, w32)
    # luma region, bounded at its own truncated count
    d_y = 7 + len_bits
    code, keep, off = _component_bits(code_y, nb_y, d_y, y_used)
    w0, p0, p1 = _parts(code, keep, off)
    local = _accumulate(local, w0, p0, p1, w32)
    # interleaved chroma region, bounded at the slice's remaining bits
    d_uv = d_y + y_used
    cum_uv = jnp.cumsum(pair, axis=1) - pair
    keep_u = jnp.clip(uv_bits[:, None] - cum_uv, 0, nb_u)
    cu = jnp.where(keep_u > 0, code_u >> (nb_u - keep_u).astype(jnp.uint32),
                   jnp.uint32(0))
    w0, p0, p1 = _parts(cu, keep_u, d_uv[:, None] + cum_uv)
    local = _accumulate(local, w0, p0, p1, w32)
    keep_v = jnp.clip(uv_bits[:, None] - cum_uv - nb_u, 0, nb_v)
    cv = jnp.where(keep_v > 0, code_v >> (nb_v - keep_v).astype(jnp.uint32),
                   jnp.uint32(0))
    w0, p0, p1 = _parts(cv, keep_v, d_uv[:, None] + cum_uv + nb_u)
    local = _accumulate(local, w0, p0, p1, w32)

    starts = jnp.cumsum(sizes) - sizes
    payload = _global_assemble(local, starts, w32, cap_bytes)
    head = jnp.concatenate([
        jax.lax.bitcast_convert_type(flags[None], jnp.uint8).ravel(),
        jax.lax.bitcast_convert_type(q_idx.astype(jnp.int32),
                                     jnp.uint8).ravel(),
    ])
    return jnp.concatenate([head, payload])


pack_ld_payload = jax.jit(pack_ld_core,
                          static_argnames=("w32", "cap_bytes"))


def unpack_ld_result(buf: np.ndarray, n: int):
    """Split the fetched LD buffer: (flags, q_idx, payload_bytes)."""
    flags = int(buf[:4].view(np.uint32)[0])
    q_idx = buf[4:4 + 4 * n].view(np.int32)
    return flags, q_idx, buf[4 + 4 * n:]


def head_bytes(n: int) -> int:
    """Size of the flags/q_idx/totals head preceding the payload bytes."""
    return 4 + 8 * n


def unpack_result(buf: np.ndarray, n: int):
    """Split the fetched buffer: (flags, q_idx, totals, payload_bytes)."""
    flags = int(buf[:4].view(np.uint32)[0])
    q_idx = buf[4:4 + 4 * n].view(np.int32)
    totals = buf[4 + 4 * n:4 + 8 * n].view(np.int32)
    payload = buf[4 + 8 * n:]
    return flags, q_idx, totals, payload
