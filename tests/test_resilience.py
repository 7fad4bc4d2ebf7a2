"""Stream resilience: corrupt pictures are skipped, decode continues
(reference DecodeStream.cpp:515-518 + dataunitio::synchronise)."""

import io
import pathlib

from vc2tpu.cli.decode_stream import Decoder

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


def _parse_infos(stream: bytes):
    idx = []
    p = stream.find(b"BBCD")
    while p != -1:
        idx.append(p)
        p = stream.find(b"BBCD", p + 4)
    return idx


def test_corrupt_picture_is_skipped(capsys):
    stream = bytearray((GOLDEN / "constq_legall_d2.vc2").read_bytes())
    ref = (GOLDEN / "constq_legall_d2.dec.16p2").read_bytes()
    pics = [i for i in _parse_infos(bytes(stream)) if stream[i + 4] == 0xE8]
    assert len(pics) == 2
    # blow up a late slice-length byte so the second picture's chain overruns
    stream[pics[-1] + 13 + 1990] = 0xFF
    sink = io.BytesIO()
    dec = Decoder(sink=sink)
    assert dec.run(bytes(stream)) == 0
    frame_bytes = len(ref) // 2
    assert dec.frames_out == 1
    assert sink.getvalue()[:frame_bytes] == ref[:frame_bytes]


def test_garbage_prefix_resync():
    stream = (GOLDEN / "constq_legall_d2.vc2").read_bytes()
    ref = (GOLDEN / "constq_legall_d2.dec.16p2").read_bytes()
    sink = io.BytesIO()
    dec = Decoder(sink=sink)
    assert dec.run(b"\x00garbage\xff" * 3 + stream) == 0
    assert dec.frames_out == 2
    assert sink.getvalue() == ref


def test_corrupt_second_field_does_not_skew_pairing():
    """Losing one field must not pair every later field off-by-one: the
    buffered first field is dropped with the corrupt second one, and the
    following frames still decode bit-exact."""
    stream = bytearray((GOLDEN / "constq_interlaced.vc2").read_bytes())
    ref = (GOLDEN / "constq_interlaced.dec.16p2").read_bytes()
    pics = [i for i in _parse_infos(bytes(stream)) if stream[i + 4] == 0xE8]
    assert len(pics) >= 4 and len(pics) % 2 == 0
    n_frames = len(pics) // 2
    # corrupt the second field (picture 1) of frame 0
    stream[pics[1] + 13 + 40] = 0xFF
    stream[pics[1] + 13 + 41] = 0xFF
    sink = io.BytesIO()
    dec = Decoder(sink=sink)
    assert dec.run(bytes(stream)) == 0
    frame_bytes = len(ref) // n_frames
    assert dec.frames_out == n_frames - 1
    assert sink.getvalue() == ref[frame_bytes:]


def test_lost_first_field_does_not_skew_pairing():
    """Losing the FIRST field of a frame must not buffer the surviving
    second field as a first field (which would mispair every later frame):
    field parity is tracked from picture numbers and the orphan dropped."""
    s = (GOLDEN / "constq_interlaced.vc2").read_bytes()
    ref = (GOLDEN / "constq_interlaced.dec.16p2").read_bytes()
    pics = [i for i in _parse_infos(s) if s[i + 4] == 0xE8]
    assert len(pics) == 4             # 2 frames = fields 0,1 then 2,3
    eos = max(i for i in _parse_infos(s) if s[i + 4] == 0x10)
    # picture run repeated once (parse offsets are unit lengths, so whole
    # units concatenate consistently): fields 0,1,2,3,0,1,2,3 — then DROP
    # the first run's field 2 (transport loss of a first field)
    doubled = s[:eos] + s[pics[0]:eos] + s[eos:]
    lost = doubled[:pics[2]] + doubled[pics[3]:]
    sink = io.BytesIO()
    dec = Decoder(sink=sink)
    assert dec.run(lost) == 0
    fb = len(ref) // 2
    # field 3 of the damaged frame is dropped (odd parity, no first field);
    # the repeated run then decodes both frames bit-exact
    assert dec.frames_out == 3
    assert sink.getvalue() == ref[:fb] + ref


def test_fragment_zero_next_offset_grows_window():
    """A fragment data unit with next_parse_offset = 0 (legal) whose body
    exceeds the first window fill must grow-and-retry like the picture
    path, not be reported truncated."""
    stream = bytearray((GOLDEN / "cbr_fragmented.vc2").read_bytes())
    ref = (GOLDEN / "cbr_fragmented.dec.16p2").read_bytes()
    frags = [i for i in _parse_infos(bytes(stream)) if stream[i + 4] == 0xEC]
    assert frags
    for i in frags:                  # zero every fragment's next offset
        stream[i + 5:i + 9] = b"\x00\x00\x00\x00"
    sink = io.BytesIO()
    dec = Decoder(sink=sink)
    assert dec.run_stream(io.BytesIO(bytes(stream)), chunk_bytes=64) == 0
    assert sink.getvalue() == ref


def test_fragment_decode_failure_skips_without_retry(capsys):
    """A complete fragmented picture whose assembled payload fails to
    decode (inflated slice length -> chain overrun) is skipped with ONE
    failure report — deterministic decode errors must not grow-and-retry
    — and the stream continues to the next picture."""
    stream = bytearray((GOLDEN / "cbr_fragmented.vc2").read_bytes())
    frags = [i for i in _parse_infos(bytes(stream)) if stream[i + 4] == 0xEC]
    body_frags = [i for i in frags
                  if int.from_bytes(stream[i + 19:i + 21], "big") > 0]
    assert body_frags
    # first body fragment of picture 1: byte 25 is the first slice's
    # qIndex, byte 26 its luma length (prefix 0, scalar 1) — inflate it so
    # the assembled chain overruns the payload
    stream[body_frags[0] + 26] = 0xFF
    sink = io.BytesIO()
    dec = Decoder(sink=sink)
    assert dec.run_stream(io.BytesIO(bytes(stream)), chunk_bytes=64) == 0
    assert dec.frames_out == 1
    err = capsys.readouterr().err
    assert err.count("Failed to decode fragmented picture") == 1


def test_duplicate_fragment_span_does_not_complete_picture():
    """A retransmitted/duplicated slice span must not double-count
    slices_decoded: the picture stays incomplete (and is dropped at end
    of stream) instead of being assembled with a hole."""
    stream = bytearray((GOLDEN / "cbr_fragmented.vc2").read_bytes())
    frags = [i for i in _parse_infos(bytes(stream)) if stream[i + 4] == 0xEC]
    body_frags = [i for i in frags
                  if int.from_bytes(stream[i + 19:i + 21], "big") > 0]
    assert len(body_frags) >= 3
    # give the second body fragment the FIRST one's slice offset: same
    # reassembly key, so its span lands on top of the first's
    a, b = body_frags[0], body_frags[1]
    # both must belong to the same picture or the mutation is a no-op
    # (guards against fixture regeneration with different -F/-s)
    assert stream[a + 13:a + 17] == stream[b + 13:b + 17]
    stream[b + 21:b + 25] = stream[a + 21:a + 25]
    sink = io.BytesIO()
    dec = Decoder(sink=sink)
    assert dec.run_stream(io.BytesIO(bytes(stream)), chunk_bytes=64) == 0
    assert dec.frames_out == 1          # picture 2 only; picture 1 is short


def test_truncated_final_slice_is_rejected():
    """A final slice whose component data runs past the data-unit end must
    fail the picture (and be skipped), not silently mis-seek the reader."""
    from vc2tpu.slices.hq import scan_hq_slice_offsets
    import numpy as np
    import pytest

    # a 1-slice payload claiming 200 component bytes but holding only 10
    payload = np.frombuffer(
        bytes([30, 100, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10]), np.uint8)
    with pytest.raises(ValueError):
        scan_hq_slice_offsets(payload, 1, 0, 2, 0)


def test_streaming_input_bit_exact_and_bounded():
    """run_stream over a chunked file object produces the same bytes as the
    in-memory path, with the window bounded by one data unit (+ a chunk)."""
    import itertools

    stream = (GOLDEN / "cbr_legall_d2.vc2").read_bytes()
    ref_sink = io.BytesIO()
    dec = Decoder(sink=ref_sink)
    assert dec.run(stream) == 0

    class TrickleReader:
        """Feeds the stream in tiny chunks to stress window management."""

        def __init__(self, data, sizes):
            self.data = data
            self.pos = 0
            self.sizes = sizes

        def read(self, n):
            k = min(next(self.sizes), n, len(self.data) - self.pos)
            out = self.data[self.pos:self.pos + k]
            self.pos += k
            return out

    sink = io.BytesIO()
    dec2 = Decoder(sink=sink)
    trickle = TrickleReader(stream, itertools.cycle([7, 64, 1, 4096, 13]))
    assert dec2.run_stream(trickle, chunk_bytes=256) == 0
    assert sink.getvalue() == ref_sink.getvalue()
    assert dec2.frames_out == dec.frames_out

    # memory bound: a long stream (the two-picture sequence repeated 50x)
    # must never buffer more than ~one data unit + one chunk
    long_stream = stream[:-13] * 50 + stream[-13:]
    sink3 = io.BytesIO()
    dec3 = Decoder(sink=sink3)
    assert dec3.run_stream(io.BytesIO(long_stream), chunk_bytes=4096) == 0
    assert dec3.frames_out == 50 * dec.frames_out
    assert sink3.getvalue() == ref_sink.getvalue() * 50
    biggest_unit = max(
        int.from_bytes(stream[i + 5:i + 9], "big")
        for i in range(len(stream))
        if stream[i:i + 4] == b"BBCD")
    assert dec3.max_window <= biggest_unit + 3 * 4096


def test_streaming_zero_next_offset_still_decodes():
    """next_parse_offset = 0 is legal (the reference parses sequentially);
    the windowed reader must grow on demand and decode every frame, even
    when the zeroed unit is the LAST one (EOF mid-growth)."""
    stream = bytearray((GOLDEN / "constq_legall_d2.vc2").read_bytes())
    ref = (GOLDEN / "constq_legall_d2.dec.16p2").read_bytes()
    pics = [i for i in _parse_infos(bytes(stream)) if stream[i + 4] == 0xE8]
    for i in pics:                   # zero every picture's next offset
        stream[i + 5:i + 9] = b"\x00\x00\x00\x00"
    sink = io.BytesIO()
    dec = Decoder(sink=sink)
    assert dec.run_stream(io.BytesIO(bytes(stream)), chunk_bytes=256) == 0
    assert sink.getvalue() == ref


def test_streaming_truncated_ld_is_skipped_not_garbage():
    """A truncated LD picture must fail (and be skipped), not silently
    decode the missing payload as zeros."""
    from vc2tpu._native.bridge import native

    if native is None:
        import pytest

        pytest.skip("LD profile requires the native host codec")
    stream = bytearray((GOLDEN / "ld_legall_d2.vc2").read_bytes())
    ref = (GOLDEN / "ld_legall_d2.dec.16p2").read_bytes()
    # cut the stream in the middle of the second LD picture's payload
    pics = [i for i in _parse_infos(bytes(stream)) if stream[i + 4] == 0xC8]
    assert len(pics) == 2
    cut = bytes(stream[:pics[1] + 200])
    sink = io.BytesIO()
    dec = Decoder(sink=sink)
    assert dec.run_stream(io.BytesIO(cut), chunk_bytes=128) == 0
    frame_bytes = len(ref) // 2
    assert dec.frames_out == 1
    assert sink.getvalue() == ref[:frame_bytes]


def test_streaming_huge_lying_next_offset_stays_bounded():
    """A corrupt next_parse_offset claiming a ~512 MB body must not balloon
    the rolling window; the body is skipped without buffering."""
    stream = (GOLDEN / "constq_legall_d2.vc2").read_bytes()
    # AUX unit claiming 1<<29 bytes, actual data only a few KB of padding,
    # then a valid stream
    aux = (b"BBCD" + bytes([0x20]) + (1 << 29).to_bytes(4, "big")
           + (0).to_bytes(4, "big"))
    corrupted = aux + b"\x00" * 8192 + stream
    dec = Decoder(sink=io.BytesIO())
    assert dec.run_stream(io.BytesIO(corrupted), chunk_bytes=4096) == 0
    assert dec.max_window < (8 << 20)


def test_streaming_resync_matches_inmemory():
    stream = bytearray((GOLDEN / "constq_legall_d2.vc2").read_bytes())
    pics = [i for i in _parse_infos(bytes(stream)) if stream[i + 4] == 0xE8]
    stream[pics[-1] + 13 + 1990] = 0xFF     # corrupt second picture
    corrupted = b"\x00garbage\xff" * 3 + bytes(stream)
    a, b = io.BytesIO(), io.BytesIO()
    d1 = Decoder(sink=a)
    assert d1.run(corrupted) == 0
    d2 = Decoder(sink=b)
    assert d2.run_stream(io.BytesIO(corrupted), chunk_bytes=512) == 0
    assert a.getvalue() == b.getvalue()
    assert d1.frames_out == d2.frames_out


def test_random_garbage_never_crashes():
    import numpy as np

    rng = np.random.default_rng(0)
    for n in (0, 13, 1000, 65536):
        dec = Decoder(sink=io.BytesIO())
        assert dec.run(rng.integers(0, 256, n, dtype=np.uint8).tobytes()) == 0


def test_random_corruption_never_crashes():
    import numpy as np

    rng = np.random.default_rng(1)
    stream = bytearray((GOLDEN / "cbr_legall_d2.vc2").read_bytes())
    for _trial in range(10):
        s = bytearray(stream)
        for _ in range(4):
            s[rng.integers(13, len(s))] = rng.integers(0, 256)
        dec = Decoder(sink=io.BytesIO())
        assert dec.run(bytes(s)) == 0


def test_random_corruption_never_crashes_device_route():
    """The on-chip entropy-unpack route must also survive arbitrary
    payload corruption (garbage decodes deterministically, chain-scan
    failures skip the picture)."""
    import numpy as np

    rng = np.random.default_rng(2)
    stream = bytearray((GOLDEN / "cbr_legall_d2.vc2").read_bytes())
    for _trial in range(5):
        s = bytearray(stream)
        for _ in range(4):
            s[rng.integers(13, len(s))] = rng.integers(0, 256)
        dec = Decoder(sink=io.BytesIO(), route="device")
        assert dec.run(bytes(s)) == 0


def test_auto_route_borderline_takes_second_sample(monkeypatch):
    """A borderline first host-synth reading (within 3x of the fetch probe)
    must NOT commit the route: the probe is a min-of-2 warm measurement and
    one cold host frame could lock a stream onto the slower route.
    The decoder takes a second sample and commits on the min."""
    import io

    from vc2tpu.pipeline import host_synth

    if not host_synth.available():
        import pytest

        pytest.skip("needs the native host codec")
    stream = (GOLDEN / "constq_legall_d2.vc2").read_bytes()
    want = (GOLDEN / "constq_legall_d2.dec.16p2").read_bytes()

    committed_after = []

    def fake_probe(self, nbytes):
        # slightly ABOVE the current host synth best: host should win, but
        # not by the decisive 3x margin on the first frame
        return min(self._host_probe_ts) * 1.5

    monkeypatch.setattr(Decoder, "_probe_link_seconds", fake_probe)
    orig = Decoder._auto_route

    def spy(self, host_fn, out_bytes):
        res = orig(self, host_fn, out_bytes)
        committed_after.append((len(self._host_probe_ts), self._route))
        return res

    monkeypatch.setattr(Decoder, "_auto_route", spy)
    sink = io.BytesIO()
    dec = Decoder(sink=sink)
    assert dec.run(stream) == 0
    assert sink.getvalue() == want              # bit-exact either way
    # first call must NOT have committed; the second must commit to host
    assert committed_after[0] == (1, None)
    assert committed_after[1][1] == "host"
