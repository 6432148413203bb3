"""The port's Mamba2 block (``repro_torch.models.ssm``) against the JAX
package's ``models/ssm.py`` at zamba2-2.7b's smoke widths (8 heads of 32,
state 16, chunk 32), on the same numpy-seeded inputs and JAX-initialised
weights (``dt_bias``, ``d_skip``, ``conv_b`` and ``out_norm`` moved off
their initial values): the causal conv with and without a carried state,
the chunked SSD scan with T a multiple of the chunk and padded, the block
without a cache, and a prefill followed by three decode steps, every
output and cache leaf within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _flatten
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import ssm as jax_ssm
from repro_torch.configs import get_smoke_config
from repro_torch.models import ssm

ARCH = "zamba2-2.7b"
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread for these smoke-size models: the suite runs in
    several worker processes at once, where torch's default of a thread a
    core makes each small op wait on the others' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs():
    return jax_get_smoke_config(ARCH), get_smoke_config(ARCH)


def _pair(seed=0):
    """JAX's Mamba2 params (biases and norm moved) and the port's block on them."""
    jcfg, cfg = _cfgs()
    p = jax_ssm.init_mamba2(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(seed)
    for name in ("dt_bias", "d_skip", "conv_b"):
        p[name] = p[name] + 0.1 * jnp.asarray(rng.standard_normal(p[name].shape), jnp.float32)
    p["out_norm"]["scale"] = 0.1 * jnp.asarray(rng.standard_normal(p["out_norm"]["scale"].shape),
                                               jnp.float32)
    block = ssm.Mamba2(cfg, torch.Generator().manual_seed(0), "cpu")
    block.load_state_dict({k.replace("|", "."): torch.from_numpy(np.array(v))
                           for k, v in _flatten(p).items()}, strict=True)
    return p, block


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("with_state", [False, True])
def test_conv1d_matches_jax(with_state):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 48)).astype(np.float32)
    w = rng.standard_normal((4, 48)).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    st = rng.standard_normal((2, 3, 48)).astype(np.float32) if with_state else None
    want_y, want_s = jax_ssm._conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                     state=None if st is None else jnp.asarray(st))
    got_y, got_s = ssm._conv1d(_t(x), _t(w), _t(b), state=None if st is None else _t(st))
    np.testing.assert_allclose(got_y.numpy(), _np(want_y), **TOL)
    np.testing.assert_array_equal(got_s.numpy(), _np(want_s))


def _ssd_inputs(t, seed):
    """The scan's inputs as the block makes them from x (B = 2, T tokens):
    xh = x * dt, a = exp(dt A), B and C, by JAX's own pieces."""
    jcfg, _ = _cfgs()
    p, _ = _pair(seed)
    d_inner, h, pd, n, _ = jax_ssm._dims(jcfg)
    x = np.random.default_rng(seed).standard_normal((2, t, jcfg.d_model)).astype(np.float32)
    z, xbc, dt_raw = jax_ssm._split_proj(jcfg, jnp.asarray(x) @ p["in_proj"]["w"])
    xbc, _ = jax_ssm._conv1d(xbc, p["conv_w"], p["conv_b"])
    dt = jax.nn.softplus(dt_raw + p["dt_bias"])
    a = jnp.exp(dt * -jnp.exp(p["a_log"]))
    xh = xbc[..., :d_inner].reshape(2, t, h, pd) * dt[..., None]
    return [np.asarray(v) for v in (xh, a, xbc[..., d_inner:d_inner + n],
                                    xbc[..., d_inner + n:])]


@pytest.mark.parametrize("t,pad", [(64, 0), (32, 0), (40, 24)])
def test_ssd_chunked_matches_jax(t, pad):
    """Chunk 32 (the smoke config's), 8 heads of 32, state 16, on the inputs
    the block makes (A = -1..-8: the cumulative log-decay spans the chunk);
    T = 40 padded to 64 as the block pads it (a = 1, zeros)."""
    chunk = 32
    xh, a, bm, cm = _ssd_inputs(t, seed=t)
    if pad:
        xh = np.pad(xh, ((0, 0), (0, pad), (0, 0), (0, 0)))
        a = np.pad(a, ((0, 0), (0, pad), (0, 0)), constant_values=1.0)
        bm, cm = (np.pad(m, ((0, 0), (0, pad), (0, 0))) for m in (bm, cm))
    b, tp, h, p = xh.shape
    want_y, want_s = jax.jit(jax_ssm.ssd_chunked, static_argnums=4)(
        jnp.asarray(xh), jnp.asarray(a), jnp.asarray(bm), jnp.asarray(cm), chunk)
    got_y, got_s = ssm.ssd_chunked(_t(xh), _t(a), _t(bm), _t(cm), chunk)
    assert got_y.shape == (b, tp, h, p) and got_s.shape == (b, h, bm.shape[-1], p)
    np.testing.assert_allclose(got_y.numpy(), _np(want_y), **TOL)
    np.testing.assert_allclose(got_s.numpy(), _np(want_s), **TOL)


@pytest.mark.parametrize("t", [64, 45])
def test_mamba2_forward_without_cache_matches_jax(t):
    """T = 64 (two whole chunks) and T = 45 (the last chunk padded with a = 1)."""
    jcfg, cfg = _cfgs()
    p, block = _pair()
    x = np.random.default_rng(2).standard_normal((2, t, cfg.d_model)).astype(np.float32)
    want, want_cache = jax.jit(lambda p, x: jax_ssm.mamba2_forward(p, x, jcfg))(p, jnp.asarray(x))
    with torch.no_grad():
        got, cache = block(_t(x))
    assert want_cache is None and cache is None
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_mamba2_prefill_then_decode_matches_jax():
    """A 37-token prefill (padded chunk; its final state and conv context
    into the cache) then three single-token steps: outputs and the cache's
    conv, ssm and pos leaves equal JAX's within 1e-5 after every call; the
    cache given is not written."""
    jcfg, cfg = _cfgs()
    p, block = _pair(seed=3)
    x = np.random.default_rng(4).standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    jcache = jax_ssm.init_mamba2_cache(jcfg, 2, jnp.float32)
    cache = ssm.init_mamba2_cache(cfg, 2, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: tuple(v.shape) for k, v in jcache.items()}
    fwd = jax.jit(lambda p, x, c: jax_ssm.mamba2_forward(p, x, jcfg, cache=c))
    for lo, hi in ((0, 37), (37, 38), (38, 39), (39, 40)):
        want, jcache = fwd(p, jnp.asarray(x[:, lo:hi]), jcache)
        before = {k: v.clone() for k, v in cache.items()}
        with torch.no_grad():
            got, new = block(_t(x[:, lo:hi]), cache)
        for k, v in before.items():
            assert torch.equal(cache[k], v), k
        cache = new
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(cache[k].numpy(), _np(jcache[k]), **TOL)
        assert int(cache["pos"]) == int(jcache["pos"]) == hi
