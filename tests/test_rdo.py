"""CBR rate-control exactness: the division-free trial sizing must equal
the real quantise+count sizing bit-for-bit at every q, and the batched
search must make exactly the decisions of the reference's per-slice binary
search (/root/reference/src/EncodeStream/EncodeStream.cpp:73-125)."""

import numpy as np
import jax.numpy as jnp
import pytest

from vc2tpu.rdo.cbr import (_magnitude_forms, _slice_bytes_at,
                            _slice_bytes_fast, cbr_quant_indices)
from vc2tpu.wavelet import matrices
from vc2tpu.core.config import WaveletKernel

BS_Y = (4, 4, 4, 4, 16, 16, 16)      # 2-level band sizes, 8x8 slice
BS_C = (1, 1, 1, 1, 4, 4, 4)


def _adversarial_lanes(rng, n, L, hi):
    """Zeros, +-1s, huge values, exact powers of two (the m+1 == 2^b edge
    the fast sizing settles with its shift-compare), and random mixes."""
    lanes = rng.integers(-hi, hi, (n, L)).astype(np.int32)
    lanes[:8] = 0
    lanes[8:16] = rng.integers(-1, 2, (8, L))
    lanes[16:20] = rng.integers(-2 ** 26, 2 ** 26, (4, L))
    pw = 2 ** rng.integers(0, 26, (4, L))
    lanes[20:24] = np.where(rng.random((4, L)) < 0.5, pw, pw - 1)
    lanes[24:28] = -lanes[20:24]
    return lanes


@pytest.mark.parametrize("scalar", [1, 2])
def test_fast_sizing_equals_quantised_sizing(scalar):
    rng = np.random.default_rng(42)
    qm = jnp.asarray(matrices.quant_matrix(WaveletKernel.LeGall, 2)
                     .astype(np.int32))
    n = 64
    ly = _adversarial_lanes(rng, n, sum(BS_Y), 2 ** 14)
    lu = _adversarial_lanes(rng, n, sum(BS_C), 2 ** 12)
    lv = _adversarial_lanes(rng, n, sum(BS_C), 2 ** 12)
    jy, ju, jv = jnp.asarray(ly), jnp.asarray(lu), jnp.asarray(lv)
    forms = (_magnitude_forms(jy), _magnitude_forms(ju),
             _magnitude_forms(jv))
    for q in range(128):
        qv = jnp.full((n,), q, dtype=jnp.int32)
        want = np.asarray(_slice_bytes_at(qv, jy, ju, jv, qm, BS_Y, BS_C,
                                          scalar))
        got = np.asarray(_slice_bytes_fast(qv, *forms, qm, BS_Y, BS_C,
                                           scalar))
        assert np.array_equal(got, want), f"sizing diverges at q={q}"


def _reference_search(size_table, available):
    """The reference quantIndicesCBR binary search (EncodeStream.cpp:85-106)
    over a precomputed (N, 128) size table."""
    n = size_table.shape[0]
    out = np.empty(n, np.int32)
    for i in range(n):
        trial, q, delta = 63, 127, 64
        while delta > 0:
            delta >>= 1
            if size_table[i, trial] <= available[i]:
                if trial < q:
                    q = trial
                trial -= delta
            else:
                trial += delta
        out[i] = q
    return out


def test_search_threshold_matches_reference():
    """With all-zero luma the hill climb never engages (SSE is 0 at every
    q), so cbr_quant_indices returns the reference search's q verbatim."""
    rng = np.random.default_rng(7)
    qm = matrices.quant_matrix(WaveletKernel.LeGall, 2).astype(np.int32)
    bs = (1, 1, 1, 1, 4, 4, 4)
    L = sum(bs)
    n = 64
    ly = np.zeros((n, L), np.int32)
    lu = rng.integers(-2 ** 16, 2 ** 16, (n, L)).astype(np.int32)
    lv = rng.integers(-2 ** 16, 2 ** 16, (n, L)).astype(np.int32)
    jy, ju, jv = jnp.asarray(ly), jnp.asarray(lu), jnp.asarray(lv)
    table = np.stack([
        np.asarray(_slice_bytes_at(jnp.full((n,), q, dtype=jnp.int32),
                                   jy, ju, jv, jnp.asarray(qm), bs, bs, 1))
        for q in range(128)], axis=1)
    budgets = np.concatenate([
        np.full(8, 4), rng.integers(5, int(table[:, 0].max()) + 16, n - 8),
    ]).astype(np.int32)
    want = _reference_search(table, budgets - 4)
    got = np.asarray(cbr_quant_indices(jy, ju, jv, jnp.asarray(qm),
                                       bs, bs, jnp.asarray(budgets), 1))
    assert np.array_equal(got, want)


def test_search_mxu_route_parity(monkeypatch):
    """The full CBR search (probes + climb) must decide identically on the
    matmul table-lookup route (the accelerator default) and the gather route
    (CPU)."""
    rng = np.random.default_rng(19)
    qm = matrices.quant_matrix(WaveletKernel.LeGall, 2).astype(np.int32)
    n = 72
    ly = _adversarial_lanes(rng, n, sum(BS_Y), 2 ** 14)
    lu = _adversarial_lanes(rng, n, sum(BS_C), 2 ** 12)
    lv = _adversarial_lanes(rng, n, sum(BS_C), 2 ** 12)
    jy, ju, jv = jnp.asarray(ly), jnp.asarray(lu), jnp.asarray(lv)
    budgets = jnp.asarray(rng.integers(5, 220, n).astype(np.int32))
    out = {}
    for route in ("0", "1"):
        monkeypatch.setenv("VC2TPU_MXU_TABLES", route)
        out[route] = np.asarray(cbr_quant_indices(
            jy, ju, jv, jnp.asarray(qm), BS_Y, BS_C, budgets, 2))
    assert np.array_equal(out["0"], out["1"])


def test_search_with_climb_bounds():
    """With live luma the climb only raises q above the reference search
    threshold, never lowers it below."""
    rng = np.random.default_rng(3)
    qm = matrices.quant_matrix(WaveletKernel.LeGall, 2).astype(np.int32)
    n = 72
    ly = _adversarial_lanes(rng, n, sum(BS_Y), 2 ** 14)
    lu = _adversarial_lanes(rng, n, sum(BS_C), 2 ** 12)
    lv = _adversarial_lanes(rng, n, sum(BS_C), 2 ** 12)
    jy, ju, jv = jnp.asarray(ly), jnp.asarray(lu), jnp.asarray(lv)
    table = np.stack([
        np.asarray(_slice_bytes_at(jnp.full((n,), q, dtype=jnp.int32),
                                   jy, ju, jv, jnp.asarray(qm), BS_Y, BS_C,
                                   2)) for q in range(128)], axis=1)
    budgets = np.concatenate([
        np.full(n // 4, 5),
        rng.integers(8, int(table[:, 0].max()) + 64, n - n // 4),
    ]).astype(np.int32)
    want = _reference_search(table, budgets - 4)
    got = np.asarray(cbr_quant_indices(jy, ju, jv, jnp.asarray(qm),
                                       BS_Y, BS_C, jnp.asarray(budgets), 2))
    assert (got >= want).all()
