"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against the JAX
package's ``models/xlstm.py`` at xlstm-1.3b's smoke widths (d_model 128, 4
heads; mLSTM d_inner 256, sLSTM d_ff 170), on the same numpy-seeded inputs
and JAX-initialised weights (biases and norms moved off their initial
values): the parallel, chunkwise and recurrent mLSTM forms, the sLSTM scan,
and both blocks without a cache and through a prefill followed by three
decode steps, outputs and every cache leaf within 1e-5 (the mLSTM's
matrix memory relative to its size)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _flatten
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import xlstm as jax_xlstm
from repro_torch.configs import get_smoke_config
from repro_torch.models import xlstm

ARCH = "xlstm-1.3b"
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


def _cfgs(**kw):
    return jax_get_smoke_config(ARCH).replace(**kw), get_smoke_config(ARCH).replace(**kw)


def _pair(kind, seed=0, **kw):
    """JAX's ``kind`` params (conv bias and norm moved) and the port's block."""
    jcfg, cfg = _cfgs(**kw)
    init = {"mlstm": jax_xlstm.init_mlstm, "slstm": jax_xlstm.init_slstm}[kind]
    p = init(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(seed)
    for name in ("conv_b",) if kind == "mlstm" else ():
        p[name] = 0.1 * jnp.asarray(rng.standard_normal(p[name].shape), jnp.float32)
    p["out_norm"]["scale"] = 0.1 * jnp.asarray(rng.standard_normal(p["out_norm"]["scale"].shape),
                                               jnp.float32)
    block = {"mlstm": xlstm.MLSTM, "slstm": xlstm.SLSTM}[kind](
        cfg, torch.Generator().manual_seed(0), "cpu")
    block.load_state_dict({k.replace("|", "."): torch.from_numpy(np.array(v))
                           for k, v in _flatten(p).items()}, strict=True)
    return jcfg, p, block


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _mlstm_inputs(t, seed):
    """q, k, v and the raw gates as the mLSTM block makes them from x, by
    JAX's own pieces: (B = 2, T, 4 heads of 64)."""
    jcfg, p, _ = _pair("mlstm", seed)
    d_inner, h, dk = jax_xlstm._mdims(jcfg)
    x = np.random.default_rng(seed).standard_normal((2, t, jcfg.d_model)).astype(np.float32)
    up = jnp.asarray(x) @ p["up"]["w"]
    xm = up[..., :d_inner]
    xc, _ = jax_xlstm._causal_conv(xm, p["conv_w"], p["conv_b"])
    gates = (xm @ p["w_if"]["w"]).reshape(2, t, h, 2)
    return [np.asarray(v) for v in (
        jax_xlstm._headproj(p["wq"], xc, h, dk), jax_xlstm._headproj(p["wk"], xc, h, dk),
        jax_xlstm._headproj(p["wv"], xm, h, dk), gates[..., 0], gates[..., 1])]


def test_mlstm_parallel_matches_jax():
    ins = _mlstm_inputs(40, seed=1)
    want = jax.jit(jax_xlstm.mlstm_parallel)(*map(jnp.asarray, ins))
    _close(xlstm.mlstm_parallel(*map(_t, ins)), want)


@pytest.mark.parametrize("chunk", [16, 64])
def test_mlstm_chunked_matches_jax(chunk):
    ins = _mlstm_inputs(64, seed=2)
    want = jax.jit(jax_xlstm.mlstm_chunked, static_argnums=5)(*map(jnp.asarray, ins), chunk)
    got = xlstm.mlstm_chunked(*map(_t, ins), chunk)
    _close(got, want)
    # and the chunked form is the parallel one
    np.testing.assert_allclose(got.numpy(), xlstm.mlstm_parallel(*map(_t, ins)).numpy(),
                               atol=1e-4, rtol=1e-4)


def test_mlstm_step_matches_jax():
    """Eight steps from the empty state (m = -1e30): h and the (C, n, m)
    state after each within 1e-5."""
    q, k, v, i_raw, f_raw = _mlstm_inputs(8, seed=3)
    b, _, h, dk = q.shape
    jst = (jnp.zeros((b, h, dk, dk)), jnp.zeros((b, h, dk)), jnp.full((b, h), -1e30))
    st = tuple(_t(np.asarray(s, np.float32)) for s in jst)
    step = jax.jit(jax_xlstm.mlstm_step)
    for j in range(8):
        args = (q[:, j], k[:, j], v[:, j], i_raw[:, j], f_raw[:, j])
        want, jst = step(jst, *map(jnp.asarray, args))
        got, st = xlstm.mlstm_step(st, *map(_t, args))
        _close(got, want)
        for a, b_ in zip(st, jst):
            _close(a, b_)


def test_slstm_scan_matches_jax():
    jcfg, p, block = _pair("slstm", seed=4)
    x = np.random.default_rng(5).standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    want, wstate = jax.jit(lambda p, x: jax_xlstm.slstm_scan(p, x, jcfg))(p, jnp.asarray(x))
    with torch.no_grad():
        got, state = xlstm.slstm_scan(block, _t(x), block.cfg)
    _close(got, want)
    for a, b in zip(state, wstate):
        _close(a, b)


@pytest.mark.parametrize("kind,kw", [("mlstm", {}), ("mlstm", dict(attn_impl="chunked",
                                                                     attn_chunk=16)),
                                     ("slstm", {})])
def test_forward_without_cache_matches_jax(kind, kw):
    """37 tokens; the chunked mLSTM pads its last chunk (input gate -1e30)."""
    jcfg, p, block = _pair(kind, seed=6, **kw)
    fwd = {"mlstm": jax_xlstm.mlstm_forward, "slstm": jax_xlstm.slstm_forward}[kind]
    x = np.random.default_rng(7).standard_normal((2, 37, jcfg.d_model)).astype(np.float32)
    want, wcache = jax.jit(lambda p, x: fwd(p, x, jcfg))(p, jnp.asarray(x))
    with torch.no_grad():
        got, cache = block(_t(x))
    assert wcache is None and cache is None
    _close(got, want)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_prefill_then_decode_matches_jax(kind):
    """A 12-token prefill (the mLSTM's state built by scanning its step, as
    JAX does) then three single-token steps: outputs and every cache leaf
    within 1e-5 after each call; the states stay float32; the cache given
    is not written."""
    jcfg, p, block = _pair(kind, seed=8)
    fwd = {"mlstm": jax_xlstm.mlstm_forward, "slstm": jax_xlstm.slstm_forward}[kind]
    init = {"mlstm": (jax_xlstm.init_mlstm_cache, xlstm.init_mlstm_cache),
            "slstm": (jax_xlstm.init_slstm_cache, xlstm.init_slstm_cache)}[kind]
    jcache = init[0](jcfg, 2, jnp.float32)
    cache = init[1](block.cfg, 2, torch.float32, "cpu")
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in cache.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in jcache.items()}
    x = np.random.default_rng(9).standard_normal((2, 15, jcfg.d_model)).astype(np.float32)
    run = jax.jit(lambda p, x, c: fwd(p, x, jcfg, cache=c))
    for lo, hi in ((0, 12), (12, 13), (13, 14), (14, 15)):
        want, jcache = run(p, jnp.asarray(x[:, lo:hi]), jcache)
        before = {k: v.clone() for k, v in cache.items()}
        with torch.no_grad():
            got, new = block(_t(x[:, lo:hi]), cache)
        assert all(torch.equal(cache[k], v) for k, v in before.items())
        cache = new
        _close(got, want)
        for k, v in cache.items():
            if k == "pos":
                assert int(v) == int(jcache[k]) == hi
            else:
                assert v.dtype == torch.float32
                np.testing.assert_allclose(v.numpy(), np.asarray(jcache[k]), rtol=1e-5,
                                           atol=1e-5 * max(1.0, float(np.abs(jcache[k]).max())))
