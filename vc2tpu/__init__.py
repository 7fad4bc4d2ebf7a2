"""vc2tpu — an SMPTE ST 2042-1 "VC-2" video codec framework in JAX.

A from-scratch re-design of the capabilities of bbc/vc2-reference for an
accelerator:

* the compute path (wavelet lifting transforms, dead-zone quantisation,
  rate-distortion search, exp-Golomb bit-length/bit-pattern generation,
  entropy pack and unpack) is pure-functional JAX batched over the
  picture's slice grid;
* the host path (bitstream bytes, stream syntax, file I/O) is NumPy plus a
  small C++ entropy packer/unpacker (``vc2tpu/_native``);
* multi-device scale-out shards the slice grid / frame batch over a
  ``jax.sharding.Mesh`` with halo-exchange collectives for the DWT
  (``vc2tpu/shard``).

Decoded output is bit-exact against the reference ``DecodeStream`` and
encoded streams are byte-identical to ``EncodeStream`` for matching
parameters (see tests/golden).
"""

import os as _os

import jax as _jax

# The codec is exact integer arithmetic; the CBR hill-climb compares 64-bit
# sums of squared errors (reference EncodeStream.cpp:107-120 accumulates in
# long long), so 64-bit types must be real. Hot arrays are explicitly int32.
_jax.config.update("jax_enable_x64", True)

# Persistent compile cache, so one geometry compiles once, not once per CLI
# invocation. JAX itself honours JAX_COMPILATION_CACHE_DIR; without it the
# cache is a fixed directory inside the checkout (listed in .gitignore) —
# the cache path is part of the cache key, so it must not move.
if not _os.environ.get("VC2TPU_NO_COMPILE_CACHE"):
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _cache = _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache")
        try:
            _os.makedirs(_cache, exist_ok=True)
            _jax.config.update("jax_compilation_cache_dir", _cache)
        except OSError:
            pass                  # read-only checkout: run uncached
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from vc2tpu.core.config import (  # noqa: F401
    WaveletKernel,
    ColourFormat,
    Profile,
    FrameRate,
    PixelAspectRatio,
    ColorSpec,
    EncoderConfig,
    DecoderConfig,
)

__version__ = "0.1.0"


def __getattr__(name):  # lazy top-level API (keeps bare import light)
    if name == "Encoder":
        from vc2tpu.pipeline.encoder import Encoder
        return Encoder
    if name == "LDEncoder":
        from vc2tpu.pipeline.ld import LDEncoder
        return LDEncoder
    if name == "Decoder":
        from vc2tpu.cli.decode_stream import Decoder
        return Decoder
    raise AttributeError(name)
