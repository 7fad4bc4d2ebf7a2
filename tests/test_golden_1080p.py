"""Production-size (1080p) byte-parity against the reference binaries.

The committed golden fixtures are <=64x32 frames; this module exercises a
full 1920x1080 4:2:2 10-bit frame through both CLIs against the compiled
reference (the bucket/retry and capacity logic is otherwise exercised only
at toy sizes). Runs live — needs /tmp/refbuild/bin (see
scripts/build_reference.sh) — and takes minutes on one CPU core, so it is
gated behind VC2TPU_SLOW=1 like the 8K sharded test.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

REFBIN = os.environ.get("VC2_REF_BIN", "/tmp/refbuild/bin")

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(not os.environ.get("VC2TPU_SLOW"),
                       reason="1080p parity runs minutes on one CPU core; "
                              "set VC2TPU_SLOW=1"),
    pytest.mark.skipif(not os.path.exists(os.path.join(REFBIN, "EncodeStream")),
                       reason="reference binaries not built"),
]


def _make_1080p_input(path: str):
    """One 1080p 4:2:2 10-bit frame: sinusoid + noise + a saturated block
    and a flat gradient band (stresses high-magnitude coefficients)."""
    rng = np.random.default_rng(42)
    h, w = 1080, 1920
    with open(path, "wb") as f:
        for (hh, ww) in ((h, w), (h, w // 2), (h, w // 2)):
            yy, xx = np.mgrid[0:hh, 0:ww]
            base = 512 + 400 * np.sin(yy / 17.0) * np.cos(xx / 23.0)
            v = base.astype(np.int64) + rng.integers(-30, 30, (hh, ww))
            v[100:200, 100:300] = 1023            # saturated block
            v[300:400, :] = (np.arange(ww) * 1023 // ww)[None, :]  # gradient
            v = np.clip(v, 0, 1023).astype(np.uint16) << 6
            f.write(v.astype(">u2").tobytes())


ARGS = ["-x", "1920", "-y", "1080", "-f", "4:2:2", "-l", "10", "-n", "2",
        "-k", "LeGall", "-d", "2", "-u", "2", "-a", "2"]

MODES = [
    ("constq", ["-m", "HQ_ConstQ", "-q", "40"]),
    ("cbr", ["-m", "HQ_CBR", "-S", "2", "-s", "829440"]),
]


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("in") / "hd.16p2")
    _make_1080p_input(p)
    return p


@pytest.mark.parametrize("name,mode", MODES, ids=[m[0] for m in MODES])
def test_1080p_byte_parity(name, mode, src, tmp_path):
    ref_stream = str(tmp_path / "ref.vc2")
    my_stream = str(tmp_path / "my.vc2")
    subprocess.run([os.path.join(REFBIN, "EncodeStream")] + ARGS + mode
                   + [src, ref_stream], check=True, capture_output=True)

    from vc2tpu.cli import decode_stream, encode_stream

    args = encode_stream.build_parser().parse_args(
        ARGS + mode + [src, my_stream])
    assert encode_stream.run(args) == 0
    assert (open(my_stream, "rb").read()
            == open(ref_stream, "rb").read()), "1080p encode differs"

    ref_dec = str(tmp_path / "ref.16p2")
    subprocess.run([os.path.join(REFBIN, "DecodeStream"), ref_stream, ref_dec],
                   check=True, capture_output=True)
    sink = io.BytesIO()
    dec = decode_stream.Decoder(sink=sink)
    assert dec.run(open(ref_stream, "rb").read()) == 0
    assert sink.getvalue() == open(ref_dec, "rb").read(), "1080p decode differs"
