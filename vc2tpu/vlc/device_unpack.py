"""On-device entropy unpack: payload bytes -> coefficient lanes, jitted.

Decodes the bounded interleaved exp-Golomb slice components of an HQ or LD
picture entirely on the accelerator, so the device decode route ships the
*compressed* payload (plus the per-slice component lengths from the host
chain scan) instead of host-unpacked coefficients. Wire semantics follow
the reference exactly (/root/reference/src/Library/src/VLC.cpp:54-94 codes,
:182-185 bounded reads return 1-bits past the region;
/root/reference/src/Library/src/Slices.cpp:384-467 slice layout).

Design (one tight gather, one short multi-code lane scan):

* The payload is assembled into big-endian uint32 words on device; each
  slice component gathers a window block of ``W`` words covering ONLY its
  lead alignment + bounded region (``window_words``). The bounded-read
  1-fill tail past the region is never gathered: every window bit at or
  past the bound ORs to 1 per scan step (the reference's rule, including
  codes that straddle the bound), so the tail is synthesised, not fetched.
* One ``lax.scan`` decodes ALL components' rows in lockstep; each step
  builds one 64-bit peek per row (one-hot multiply over the block words -
  no dynamic gather inside the scan) and decodes up to ``_K`` codes from
  it with register shifts: ``clz`` of the follow-bit mask gives the data-
  bit count, a log-step even-bit compress (inverse Morton spread) extracts
  the magnitude, and each accepted code one-hot-accumulates into its lane.
  A code is accepted only if it lies entirely inside the peek; a straddler
  defers to the next step, where it is the first code of a fresh window.
* Rows stop at their bound: lanes past the region's last code decode to 0
  under the 1-fill rule, and 0 is what unwritten lanes already hold, so
  the scan length is set by the REGION's bit budget, not the lane count -
  ``_scan_steps`` derives the exact static bound (see its docstring).

Codes with more than 31 data bits (|v| >= 2^31, impossible in conformant
streams and undefined in the reference's int arithmetic) are clamped.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

_FOLLOW = np.uint64(0xAAAAAAAAAAAAAAAA)
_C1 = np.uint64(0x5555555555555555)
_C2 = np.uint64(0x3333333333333333)
_C4 = np.uint64(0x0F0F0F0F0F0F0F0F)
_C8 = np.uint64(0x00FF00FF00FF00FF)
_C16 = np.uint64(0x0000FFFF0000FFFF)
_C32 = np.uint64(0x00000000FFFFFFFF)
_ALL64 = np.uint64(0xFFFFFFFFFFFFFFFF)

_K = 8      # codes decoded per 64-bit peek per scan step


def _compress_even(x):
    """Gather the even-position bits of x into the low bits (inverse of the
    Morton spread used by golomb._spread16)."""
    x = x & _C1
    x = (x | (x >> jnp.uint64(1))) & _C2
    x = (x | (x >> jnp.uint64(2))) & _C4
    x = (x | (x >> jnp.uint64(4))) & _C8
    x = (x | (x >> jnp.uint64(8))) & _C16
    x = (x | (x >> jnp.uint64(16))) & _C32
    return x


def window_words(n_bytes_max: int, n_lanes: int) -> int:
    """Gathered window size (uint32 words) for byte-aligned regions: the
    lead alignment (<= 3 bytes) plus the bounded region. Nothing past the
    bound is fetched - the 1-fill tail is synthesised per scan step."""
    del n_lanes                     # tail is virtual; kept for API parity
    return (3 + n_bytes_max + 3) // 4


def window_words_bits(n_bits_max: int, n_lanes: int) -> int:
    """Gathered window size (uint32 words) for BIT-granular regions (LD):
    31 lead-alignment bits plus the bounded region; the tail is virtual."""
    del n_lanes
    return (31 + n_bits_max + 31) // 32


def block_bytes_estimate(n_slices: int, comp_word_counts) -> int:
    """Device memory the per-slice window blocks will take. The block is
    sized by the LARGEST component region, so a heavily skewed stream (one
    huge slice among thousands of tiny ones) can inflate it far past the
    payload size — callers fall back to the host unpack above a cap."""
    return 4 * n_slices * int(sum(comp_word_counts))


def _scan_steps(n_words: int, n_lanes: int) -> int:
    """Exact static upper bound on the scan steps needed to decode every
    in-region code of a row whose gathered window is ``n_words`` words.

    Every live step decodes >= 1 code (the first code of a fresh window
    always fits: its length is at most 64 after the corrupt-code clamp).
    Steps that decode the full ``_K`` codes number at most ceil(L/_K).
    A "slow" step t (fewer than _K codes, row not finished) was stopped by
    a code that did not fit the peek; that blocker is consumed at step t+1,
    so consumed(t) + consumed(t+1) > 64 bits. Each row consumes fewer than
    32*n_words + 64 bits total (the region plus one straddling/clamped
    code - consumption stops at the bound), so slow steps number at most
    (32*n_words + 64)/32 = n_words + 2. The lane count is itself always
    sufficient (one code per live step minimum)."""
    return min(n_lanes, -(-n_lanes // _K) + n_words + 2 + 3)


def _decode_scan_raw(block, pos0, bound, lane_lim, length: int):
    """Decode bounded interleaved exp-Golomb code rows in lockstep.

    block: uint32 [N, W] gathered data words (row-relative; padding past a
    row's real span may hold anything - every bit at or past ``bound`` is
    OR-filled to 1 before decoding, the reference's bounded-read rule).
    pos0: int32 [N] block-relative start bit of each row's region.
    bound: int32 [N] block-relative end bit (pos0 + region length).
    lane_lim: int32 [N] per-row code count.

    Returns (vals [S, N, _K] int32, nd0 [S, N] int32): acceptance within a
    step is prefix-monotone (a rejected slot's successors recompute the
    same rejected state), so a step's accepted values are DENSE in slot
    order starting at lane nd0 - the scan carries only (pos, lanes-done)
    and lane placement happens post-scan in one parallel pass (_place).
    An in-scan dense [N, out_w] accumulator was several times slower on the
    TPU this codec was first built for: its K one-hot updates rewrite the
    whole accumulator every step (memory-bound).
    """
    n_words = block.shape[1]
    u64 = lambda a: a.astype(jnp.uint64)

    def step(carry, _):
        pos, nd = carry
        widx = pos >> 5
        sh = u64(pos & 31)
        w0 = jnp.zeros_like(pos).astype(jnp.uint32)
        w1 = jnp.zeros_like(w0)
        w2 = jnp.zeros_like(w0)
        eq1 = eq2 = None
        for k in range(n_words):
            bk = block[:, k]
            eq = (widx == k).astype(jnp.uint32)     # one compare, reused
            w0 = w0 + bk * eq
            if eq1 is not None:
                w1 = w1 + bk * eq1
            if eq2 is not None:
                w2 = w2 + bk * eq2
            eq1, eq2 = eq, eq1
        win = (u64(w0) << (jnp.uint64(32) + sh)) | (u64(w1) << sh)
        t2 = u64(w2) >> (jnp.uint64(32) - jnp.maximum(sh, jnp.uint64(1)))
        win = win | jnp.where(sh > 0, t2, jnp.uint64(0))
        # bounded 1-fill: window bits at or past the bound read as 1
        ok = u64(jnp.clip(bound - pos, 0, 64))
        fill = jnp.where(ok >= 64, jnp.uint64(0),
                         _ALL64 >> jnp.minimum(ok, jnp.uint64(63)))
        win = win | fill

        off = jnp.zeros_like(pos)
        nd0 = nd
        vals = []
        for _j in range(_K):
            # off can reach exactly 64 (one clamped full-width code);
            # shift-by-width is implementation-defined, and &63 keeps the
            # value deterministic - the fits test rejects that path anyway
            wj = win << u64(off & 63)
            # first 1 follow bit (even code position) ends the magnitude
            p = jnp.minimum(lax.clz(wj & _FOLLOW).astype(jnp.int32), 62)
            ndata = u64(p >> 1)
            pe = jnp.maximum(p, 2)
            x = wj >> u64(64 - pe)                  # code bits 0..p-1
            mag = ((jnp.uint64(1) << ndata)
                   | _compress_even(x)) - jnp.uint64(1)
            sign = (wj >> u64(62 - p)) & jnp.uint64(1)
            mag_i = mag.astype(jnp.int64)
            val = jnp.where(p == 0, 0,
                            jnp.where(sign > 0, -mag_i,
                                      mag_i)).astype(jnp.int32)
            ln = jnp.where(p == 0, 1, p + 2)
            # accept only codes that start in-region and lie entirely
            # inside this peek; a straddler is the next step's first code
            okj = ((pos + off < bound) & (off + ln <= 64) & (nd < lane_lim))
            vals.append(jnp.where(okj, val, 0))
            off = jnp.where(okj, off + ln, off)
            nd = nd + okj.astype(jnp.int32)
        return (pos + off, nd), (jnp.stack(vals, 1), nd0)

    # carry initialisers derive from pos0 so they inherit its mesh-varying
    # type under shard_map (fresh jnp.zeros would be unvarying and fail
    # the scan's carry type check on the sharded decode route)
    init = (pos0.astype(jnp.int32), jnp.zeros_like(pos0, dtype=jnp.int32))
    _, (vals, nd0) = lax.scan(step, init, None, length=length)
    return vals, nd0


def _place(vals, nd0, rows, out_w: int):
    """Lane placement of a row range of the scan's dense step blocks: step
    s of row n holds values for lanes [nd0[s,n], nd0[s,n]+K) (zeros in the
    unaccepted tail slots), so out[n, l] = sum over s of
    vals[s, n, l - nd0[s, n]] - one scatter-add, no sequential state. Two
    steps of a row overlap only where the earlier one holds its zero tail,
    so the integer adds place each value exactly once. Lanes no step wrote
    (the 1-fill tail past a region's last code) stay 0, their decoded
    value.

    The scatter replaced a fully unrolled sum of S*K masked terms, whose
    compile time grew with S*K: with it, the first device decode of each
    small golden geometry took 24-68 s on an H100, compile included, and
    the depth-4 golden case's decode took 99 s on XLA:CPU (7 s with the
    scatter)."""
    v = vals[:, rows]
    b = nd0[:, rows]
    n = v.shape[1]
    lane = b[:, :, None] + jnp.arange(_K, dtype=jnp.int32)      # (S, n, K)
    row = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :, None],
                           lane.shape)
    return jnp.zeros((n, out_w), jnp.int32).at[row, lane].add(
        v, mode="drop")


def _decode_scan(block, pos0, bound, lane_lim, out_w: int, length: int):
    """Single-group decode: scan + placement over all rows."""
    vals, nd0 = _decode_scan_raw(block, pos0, bound, lane_lim, length)
    return _place(vals, nd0, slice(None), out_w)


def unpack_component(words, dstart, clen, n_lanes: int, n_words: int):
    """Decode ``n_lanes`` signed codes per slice from bounded regions.

    words: uint32 [P] big-endian-assembled payload words.
    dstart: int32 [N] absolute byte offset of each region.
    clen: int32 [N] region length in bytes (bound).
    Returns int32 [N, n_lanes] in lane order.
    """
    base = dstart >> 2
    j = jnp.arange(n_words, dtype=jnp.int32)
    block = words[base[:, None] + j[None, :]]           # (N, W) gather
    pos0 = ((dstart & 3) * 8).astype(jnp.int32)
    bound = pos0 + 8 * clen.astype(jnp.int32)
    lim = jnp.full_like(pos0, n_lanes)
    return _decode_scan(block, pos0, bound, lim, n_lanes,
                        _scan_steps(n_words, n_lanes))


def unpack_component_bits(words, dstart_bits, blen_bits, n_lanes: int,
                          n_words: int):
    """Decode ``n_lanes`` signed codes per stream from BIT-granular bounded
    regions — the LD slice layout, whose luma/chroma regions start mid-byte
    (after the 7-bit qIndex + length field) and bound in bits
    (reference LDSliceIO, Slices.cpp:195-303).

    words: uint32 [P] big-endian-assembled payload words. The caller must
    pad the payload tail with 0xFF (in-bound reads past the true payload
    end are 1-bits, the reference's at-EOF rule).
    dstart_bits: int32 [N] absolute bit offset of each region.
    blen_bits: int32 [N] region length in bits (bound, >= 0).
    Returns int32 [N, n_lanes] in code order.
    """
    base = dstart_bits >> 5
    lead = (dstart_bits & 31).astype(jnp.int32)
    j = jnp.arange(n_words, dtype=jnp.int32)
    block = words[base[:, None] + j[None, :]]           # (N, W) gather
    bound = lead + blen_bits.astype(jnp.int32)
    lim = jnp.full_like(lead, n_lanes)
    return _decode_scan(block, lead, bound, lim, n_lanes,
                        _scan_steps(n_words, n_lanes))


def unpack_ld_lanes(payload_u8, s_bits, len_bits, y_bits, uv_bits,
                    lane_counts: tuple[int, int],
                    word_counts: tuple[int, int]):
    """Jit-composable device unpack of an LD picture's slice payload.

    payload_u8: uint8 [P4] (P4 % 4 == 0, 0xFF-padded past the true end).
    s_bits/len_bits/y_bits/uv_bits: int32 [N] from the host header scan
    (slices/ld.ld_header_fields). lane_counts: (Ly, Lc).
    Both regions decode in ONE merged lane scan (rows stacked, per-row
    window width/lane limits). Returns (qy [N, Ly], quv [N, 2*Lc] with u,v
    interleaved per coefficient, exactly the wire order — Slices.cpp:71-95).
    """
    words = assemble_words(payload_u8)
    Ly, Lc = lane_counts
    Wy, Wc = word_counts
    n = s_bits.shape[0]
    d_y = (s_bits + 7 + len_bits).astype(jnp.int32)
    d_c = (d_y + y_bits).astype(jnp.int32)
    dall = jnp.concatenate([d_y, d_c])
    blen = jnp.concatenate([y_bits, uv_bits]).astype(jnp.int32)
    block = _gather_blocks(words, [(d_y >> 5, Wy), (d_c >> 5, Wc)])
    lead = (dall & 31).astype(jnp.int32)
    lim = jnp.concatenate([jnp.full((n,), Ly, jnp.int32),
                           jnp.full((n,), 2 * Lc, jnp.int32)])
    steps = max(_scan_steps(Wy, Ly), _scan_steps(Wc, 2 * Lc))
    vals, nd0 = _decode_scan_raw(block, lead, lead + blen, lim, steps)
    return (_place(vals, nd0, slice(0, n), Ly),
            _place(vals, nd0, slice(n, 2 * n), 2 * Lc))


def assemble_words(payload_u8):
    """Big-endian uint32 words from a byte payload (length multiple of 4)."""
    r = payload_u8.reshape(-1, 4).astype(jnp.uint32)
    return (r[:, 0] << 24) | (r[:, 1] << 16) | (r[:, 2] << 8) | r[:, 3]


def hq_component_offsets(clens, prefix: int, start):
    """Per-component data byte offsets from the slice chain structure
    (Slices.cpp:384-467: prefix zeros, 1B qIndex, then per component
    {1B length, data}). clens: int32 [3, N]."""
    totals = prefix + 4 + clens[0] + clens[1] + clens[2]
    sstart = start + jnp.cumsum(totals) - totals
    d0 = sstart + prefix + 2
    d1 = d0 + clens[0] + 1
    d2 = d1 + clens[1] + 1
    return d0, d1, d2


def _gather_blocks(words, groups):
    """Stack per-group window gathers into one (N_total, W_max) block:
    each group gathers only ITS width (tight fetch) and zero-pads to the
    common width — the pad is never decoded (the 1-fill bound covers every
    bit at or past a row's region end)."""
    w_max = max(w for _, w in groups)
    blocks = []
    for base, w in groups:
        j = jnp.arange(w, dtype=jnp.int32)
        b = words[base[:, None] + j[None, :]]
        if w < w_max:
            b = jnp.pad(b, ((0, 0), (0, w_max - w)))
        blocks.append(b)
    return jnp.concatenate(blocks)


def unpack_hq_lanes(payload_u8, clens, start, prefix: int,
                    lane_counts: tuple[int, int, int],
                    word_counts: tuple[int, int, int]):
    """Jit-composable device unpack of a whole HQ picture's slice payload.

    payload_u8: uint8 [P4] (P4 % 4 == 0, zero/any padded).
    clens: int32 [3, N] component byte lengths (from the host chain scan).
    start: int32 scalar, byte offset of the first slice.
    All three components decode in ONE merged lane scan (luma rows stacked
    over the chroma pair's, per-row window width and lane limits), so the
    whole picture costs a single short sequential scan.
    Returns (qy, qu, qv) int32 lane arrays.
    """
    words = assemble_words(payload_u8)
    d0, d1, d2 = hq_component_offsets(clens, prefix, start)
    Ly, Lc, _ = lane_counts
    Wy = word_counts[0]
    Wc = max(word_counts[1], word_counts[2])
    n = d0.shape[0]
    dc = jnp.concatenate([d1, d2])
    block = _gather_blocks(words, [(d0 >> 2, Wy), (dc >> 2, Wc)])
    dall = jnp.concatenate([d0, dc])
    call = jnp.concatenate([clens[0], clens[1], clens[2]]).astype(jnp.int32)
    pos0 = ((dall & 3) * 8).astype(jnp.int32)
    lim = jnp.concatenate([jnp.full((n,), Ly, jnp.int32),
                           jnp.full((2 * n,), Lc, jnp.int32)])
    steps = max(_scan_steps(Wy, Ly), _scan_steps(Wc, Lc))
    vals, nd0 = _decode_scan_raw(block, pos0, pos0 + 8 * call, lim, steps)
    return (_place(vals, nd0, slice(0, n), Ly),
            _place(vals, nd0, slice(n, 2 * n), Lc),
            _place(vals, nd0, slice(2 * n, 3 * n), Lc))


def unpack_chroma_pair(words, d1, d2, clen1, clen2, n_lanes: int,
                       n_words: int):
    """Decode the two chroma components in ONE lane scan by stacking their
    regions along the slice axis (same lane count; one scan dispatch, twice
    the vector width). Returns (qu, qv)."""
    n = d1.shape[0]
    dstart = jnp.concatenate([d1, d2])
    clen = jnp.concatenate([clen1, clen2])
    both = unpack_component(words, dstart, clen, n_lanes, n_words)
    return both[:n], both[n:]
