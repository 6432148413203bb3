"""The port's ``ws_fused`` (K draws on one frozen logits buffer) against the
JAX package's ``ws_fused_steps`` in interpret mode, in both key layouts.

Tolerance: tokens equal except on rows that met a near tie on the port's
path (``ws_fused_ref(..., tie_tol=1e-5)``: the keep-vs-move scores or the
two best candidates within 1e-5), where the TPU kernel's tiled softmax sum
and the plain version's full-row sum may round differently. The tests also
pin the a = 0 freeze and the one reference fault they meet (R4 in
ROADMAP.md: the JAX noise is +inf on one element in 2**24)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.paths import WarmStartPath as JaxPath
from repro.kernels.ws_fused import ws_fused_steps as jax_ws_fused_steps
from repro.kernels.ws_step.kernel import gumbel_from_bits as jax_gumbel_from_bits
from repro.kernels.ws_step.kernel import threefry2x32 as jax_threefry2x32
from repro_torch import prng
from repro_torch.core.paths import WarmStartPath
from repro_torch.kernels import make_ws_fused_fn, ws_fused_steps
from repro_torch.kernels.ws_fused import fused_noise, ws_fused_ref
from repro_torch.kernels.ws_fused.ops import fused_inputs
from repro_torch.kernels.ws_step import ws_step

TIE_TOL = 1e-5


def _case(layout, k, b, n, v, seed):
    """numpy inputs and both packages' keys: single key per step, or per
    (step, request row) keys with an inactive row and one entering
    mid-block (h = 0 steps)."""
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((b, n, v))).astype(np.float32)
    x = rng.integers(0, v, (b, n)).astype(np.int32)
    if layout == "single":
        jk, tk = jax.random.split(jax.random.key(seed), k), prng.split(prng.key(seed), k)
        ts = (0.5 + np.arange(k) / 16).astype(np.float32)
        hs = np.full((k,), 1 / 16, np.float32)
        hs[-1] = 0.0
    else:
        jbase = jax.random.split(jax.random.key(seed), b)
        jk = jax.vmap(lambda i: jax.vmap(jax.random.fold_in)(jbase, jnp.full((b,), i)))(
            jnp.arange(k))
        tk = prng.fold_in(prng.split(prng.key(seed), b)[None], torch.arange(k)[:, None])
        ts = np.tile((0.5 + np.arange(k) / 16).astype(np.float32)[:, None], (1, b))
        hs = np.full((k, b), 1 / 16, np.float32)
        hs[:, 0] = 0.0
        hs[: k // 2, 1] = 0.0
    return logits, x, ts, hs, jk, tk


@pytest.mark.parametrize("layout", ["single", "rows"])
@pytest.mark.parametrize("k,v", [(1, 27), (2, 27), (3, 27), (4, 200)])
def test_ws_fused_matches_jax_interpret(layout, k, v):
    b, n = 3, 24
    logits, x, ts, hs, jk, tk = _case(layout, k, b, n, v, 10 * k + v)
    want = np.asarray(jax_ws_fused_steps(jk, jnp.asarray(logits), jnp.asarray(x),
                                         jnp.asarray(ts), jnp.asarray(hs), JaxPath(0.0),
                                         interpret=True))
    lt, xt = torch.from_numpy(logits), torch.from_numpy(x)
    got = ws_fused_steps(tk, lt, xt, torch.from_numpy(ts), torch.from_numpy(hs),
                         WarmStartPath(0.0))
    seeds, lg, xr, a, kg, ag = fused_inputs(tk, lt, xt, ts, hs, WarmStartPath(0.0))
    _, ties = ws_fused_ref(seeds, lg, xr, a, key_group=kg, a_group=ag, tie_tol=TIE_TOL)
    mismatch = (got.numpy() != want).reshape(-1)
    assert not (mismatch & ~ties.numpy()).any()
    if layout == "rows":
        np.testing.assert_array_equal(got[0].numpy(), x[0])      # h = 0 on every step


@pytest.mark.parametrize("layout", ["single", "rows"])
def test_fused_equals_composed_and_single_key_equals_ws_step(layout):
    k, b, n, v = 4, 2, 16, 27
    logits, x, ts, hs, _, tk = _case(layout, k, b, n, v, 5)
    lt, xt, path = torch.from_numpy(logits), torch.from_numpy(x), WarmStartPath(0.0)
    fused = ws_fused_steps(tk, lt, xt, ts, hs, path)
    composed = ws_fused_steps(tk, lt, xt, ts, hs, path, impl="composed")
    assert torch.equal(fused, composed)
    if layout == "single":
        cur = xt
        for j in range(k):
            cur = ws_step(tk[j], lt, cur, torch.tensor(ts[j]), torch.tensor(hs[j]), path)
        assert torch.equal(fused, cur)
    fn = make_ws_fused_fn(path)
    assert torch.equal(fn(tk, lt, xt, ts, hs), fused)


def test_ws_fused_validation_matches_jax():
    lt, xt = torch.zeros(2, 4, 5), torch.zeros(2, 4, dtype=torch.int32)
    path = WarmStartPath(0.0)
    keys2 = prng.split(prng.key(0), 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        ws_fused_steps(keys2, lt, xt, torch.zeros(3), torch.zeros(2), path)
    with pytest.raises(ValueError, match="require"):
        ws_fused_steps(torch.zeros(3, 2, 2, dtype=torch.int64), lt.reshape(8, 5),
                       xt.reshape(8), torch.zeros(3), torch.zeros(3), path)
    with pytest.raises(ValueError, match="per-row keys shape"):
        ws_fused_steps(torch.zeros(3, 4, 2, dtype=torch.int64), lt, xt, torch.zeros(3),
                       torch.zeros(3), path)
    with pytest.raises(ValueError, match="bad ts shape"):
        ws_fused_steps(keys2, lt, xt, torch.zeros(3, 4), torch.zeros(3, 4), path)
    with pytest.raises(ValueError, match="hw_prng"):
        ws_fused_steps(keys2, lt, xt, torch.zeros(3), torch.zeros(3), path, hw_prng=True)
    with pytest.raises(ValueError, match="impl"):
        ws_fused_steps(keys2, lt, xt, torch.zeros(3), torch.zeros(3), path, impl="tiled")
    assert ws_fused_steps(keys2[:0], lt, xt, torch.zeros(0), torch.zeros(0), path) is xt


# key words and counter (row 13, column 40081) whose threefry word 0 has
# bits >> 8 == 0xFFFFFF: (bits >> 8) + 0.5 rounds to 2**24 in float32
R4_KEY, R4_ROW, R4_COL = (1234199231, 716562018), 13, 40081


def test_reference_fault_r4_infinite_noise_is_clamped_in_the_port():
    k0, k1 = (jnp.uint32(w) for w in R4_KEY)
    bits, _ = jax_threefry2x32(k0, k1, jnp.uint32(R4_ROW), jnp.uint32(R4_COL))
    assert int(bits) >> 8 == 0xFFFFFF
    assert np.isposinf(np.asarray(jax_gumbel_from_bits(bits)))       # the reference fault
    seeds = torch.tensor([list(R4_KEY)], dtype=torch.int64)
    g = fused_noise(seeds, 16, R4_COL + 1, 16)
    assert torch.isfinite(g).all()
    assert float(g[R4_ROW, R4_COL]) == pytest.approx(16.6355, abs=1e-3)
    # elsewhere the port's noise is the JAX noise: the same bits, and the
    # two packages' logs within one ulp of max(|g|, 1)
    r = jnp.arange(16, dtype=jnp.uint32)[:, None]
    c = jnp.arange(R4_COL + 1, dtype=jnp.uint32)[None, :]
    jg = np.asarray(jax_gumbel_from_bits(jax_threefry2x32(k0, k1, r, c)[0]))
    finite = np.isfinite(jg)
    assert finite.sum() == jg.size - 1
    tg, jg = g.numpy()[finite], jg[finite]
    assert (np.abs(tg - jg) <= np.spacing(np.maximum(np.abs(jg), 1.0))).all()


def test_a_zero_freezes_rows_even_on_the_r4_element():
    """Row 13 of a request whose step key is R4_KEY meets the +inf element;
    at a = 0 the port keeps the row (the JAX reference moves it to column
    40081)."""
    v, n = R4_COL + 1, 16
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal((1, n, v))
                              .astype(np.float32))
    x = torch.zeros(1, n, dtype=torch.int32)
    keys = torch.tensor([[list(R4_KEY)]], dtype=torch.int64)          # (K=1, B=1, 2)
    got = ws_fused_steps(keys, logits, x, torch.full((1, 1), 0.5), torch.zeros(1, 1),
                         WarmStartPath(0.0))
    assert torch.equal(got, x)
