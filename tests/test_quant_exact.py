"""Exhaustive exactness of quant/scale vs the reference C semantics.

The implementations replace integer division with a float32-reciprocal
estimate + integer fix-up (quant) and shifts (scale); this sweep pins them
against a literal int32-wrapping model of Quantisation.cpp:69-95 over every
quantiser index and the full legal coefficient range envelope. Each check
runs eagerly and jitted: a compiled program may fuse and contract the float
arithmetic where op-by-op execution does not.

The checks are plain functions of ``make_sweep()`` so that chip_smoke.py can
run them on the card outside pytest.
"""

import jax
import numpy as np
import jax.numpy as jnp
import pytest

from vc2tpu.quant.quantiser import (ABS_QF_I32, QUANT_FACTORS_I32,
                                    QUANT_OFFSETS, RECIP_QF_F32, banded_aq,
                                    banded_lookup, pack_tables, quant,
                                    quant_banded, scale, scale_banded)


def _w32(x):
    x &= 0xFFFFFFFF
    return x - 2 ** 32 if x >= 2 ** 31 else x


def ref_quant(v, q):
    qf = int(QUANT_FACTORS_I32[q])
    neg = v < 0
    x = _w32(abs(v) << 2)
    r = abs(x) // abs(qf)
    r = -r if (x < 0) ^ (qf < 0) else r
    return -r if neg else r


def ref_scale(v, q):
    qf = int(QUANT_FACTORS_I32[q])
    qo = int(QUANT_OFFSETS[q])
    neg = v < 0
    p = _w32(abs(v) * qf)
    if p > 0:
        p = _w32(p + qo)
    p = _w32(p + 2)
    r = abs(p) // 4
    r = -r if p < 0 else r
    return -r if neg else r


def make_sweep():
    rng = np.random.default_rng(1)
    # full exactness domain: everything up to |v| < 2^29 (where the
    # reference's own |v|<<2 stays in int), incl. the high-magnitude band
    # real transforms reach (~2^23, lifting.coefficient_bound) and every
    # power-of-two neighbourhood where float32 rounding flips
    pows = (1 << np.arange(20, 29)).astype(np.int64)
    edges = np.concatenate([pows + d for d in (-2, -1, 0, 1, 2)])
    vals = np.concatenate([
        rng.integers(-(1 << 21), 1 << 21, 3000),
        rng.integers(-(1 << 23), 1 << 23, 2000),
        rng.integers(-(1 << 29) + 1, (1 << 29) - 1, 2000),
        np.arange(-64, 65),
        edges, -edges,
        np.array([(1 << 21) - 1, -(1 << 21) + 1, 1 << 20, -(1 << 20),
                  (1 << 29) - 1, -(1 << 29) + 1, 5_100_000, -5_100_000,
                  7_300_000, -7_300_000]),
    ]).astype(np.int32)
    qs = np.arange(0, 120, dtype=np.int32)
    V = jnp.asarray(np.tile(vals, (len(qs), 1)))
    Q = jnp.asarray(np.repeat(qs, len(vals)).reshape(len(qs), len(vals)))
    return vals, qs, V, Q


@pytest.fixture(scope="module")
def sweep():
    return make_sweep()


def test_quant_exact(sweep):
    vals, qs, V, Q = sweep
    exp = np.array([[ref_quant(int(v), int(q)) for v in vals] for q in qs])
    for fn in (quant, jax.jit(quant)):
        assert np.array_equal(np.asarray(fn(V, Q)), exp)


def test_scale_exact(sweep):
    vals, qs, V, Q = sweep
    exp = np.array([[ref_scale(int(v), int(q)) for v in vals] for q in qs])
    for fn in (scale, jax.jit(scale)):
        assert np.array_equal(np.asarray(fn(V, Q)), exp)


def test_banded_lookup_exact():
    """The one-hot matmul table lookup must equal the gather it replaces for
    every q (including out-of-domain values, which clamp like banded_aq)
    and a quant matrix reaching the spec's maximum default entry (30)."""
    rng = np.random.default_rng(11)
    qm = jnp.asarray(np.array([0, 3, 5, 5, 7, 30, 11], np.int32))
    q = jnp.asarray(np.concatenate([
        np.arange(-4, 260), rng.integers(0, 127, 400)]).astype(np.int32))
    tables = (ABS_QF_I32, RECIP_QF_F32, QUANT_FACTORS_I32, QUANT_OFFSETS)
    planes = pack_tables(*tables)
    aq = np.asarray(banded_aq(q, qm))
    for fn in (banded_lookup, jax.jit(banded_lookup)):
        got = np.asarray(fn(q, qm, planes))
        for i, t in enumerate(tables):
            want = np.ascontiguousarray(t).view(np.uint32)[aq]
            assert np.array_equal(got[..., i].astype(np.int64) & 0xFFFFFFFF,
                                  want.astype(np.int64)), \
                f"table {i} diverges"


def test_mxu_route_parity(sweep, monkeypatch):
    """quant_banded/scale_banded bit-identical on the matmul-lookup and
    gather routes (the accelerator default vs the CPU route)."""
    vals, qs, V, Q = sweep
    n = V.shape[1]
    sizes = (n // 2, n - n // 2)
    qm = jnp.asarray(np.array([2, 9], np.int32))
    q_per_row = jnp.asarray(qs)
    out = {}
    for route in ("0", "1"):
        monkeypatch.setenv("VC2TPU_MXU_TABLES", route)
        out[route] = (np.asarray(quant_banded(V, q_per_row, qm, sizes)),
                      np.asarray(scale_banded(V, q_per_row, qm, sizes)))
    assert np.array_equal(out["0"][0], out["1"][0])
    assert np.array_equal(out["0"][1], out["1"][1])


def test_banded_matches_elementwise(sweep):
    vals, qs, V, Q = sweep
    # one band per lane group: qm zeros -> aq == q, sizes cover the lanes
    n = V.shape[1]
    sizes = (n // 2, n - n // 2)
    qm = jnp.zeros((2,), jnp.int32)
    q_per_row = jnp.asarray(qs)
    assert np.array_equal(np.asarray(quant_banded(V, q_per_row, qm, sizes)),
                          np.asarray(quant(V, Q)))
    assert np.array_equal(np.asarray(scale_banded(V, q_per_row, qm, sizes)),
                          np.asarray(scale(V, Q)))
