"""The recurrent family's models in the port against the JAX package's, at
zamba2-2.7b's and xlstm-1.3b's smoke configs on converted weights (norm
scales and biases moved off their initial values): ``dfm_apply`` at atol =
rtol = 1e-4; the causal ``forward``, ``prefill`` and ``decode_step`` and
every cache leaf at 1e-5; ``ARDraftEngine`` (the plain decode path, prompt
prefilled by scan, as JAX's ``auto`` picks) equal to JAX's off near-ties;
repeated calls with one prompt equal to a fresh engine's and to the
cache-free oracle, where JAX's differ (reference fault R7, pinned here);
``WarmStartServer.serve`` tokens and NFE equal to JAX's; the training step
takes a finite step on the family."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _flatten
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.core.paths import WarmStartPath as JaxPath
from repro.drafting import ARDraftEngine as JaxEngine
from repro.drafting import TransformerDraftAdapter as JaxAdapter
from repro.models import build_model as jax_build_model
from repro.serving.engine import WarmStartServer as JaxWarmStartServer
from repro_torch import prng
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.convert import jax_params_to_torch
from repro_torch.core.paths import WarmStartPath
from repro_torch.drafting import (
    ARDraftEngine, TransformerDraftAdapter, oracle_generate_rows, row_gumbel,
)
from repro_torch.models import Model
from repro_torch.serving import WarmStartServer
from repro_torch.optim import build_optimizer
from repro_torch.training import TrainState
from repro_torch.training.train_step import make_loss_fn, make_train_step

ARCHS = ("zamba2-2.7b", "xlstm-1.3b")
V = 512                       # the smoke configs' vocabulary
TIE_TOL = 1e-5
SEQ, MAX_LEN = 8, 16          # the R7 reproduction's draft length and cache
FORWARD_TOL = {"zamba2-2.7b": 1e-5, "xlstm-1.3b": 2e-5}   # the causal forward's logits
STATE_TOL = {"zamba2-2.7b": 1e-5, "xlstm-1.3b": 5e-5}     # cache leaves, x max(1, max |leaf|)


@functools.lru_cache(maxsize=None)
def _pair(arch, seed=0):
    """(JAX model, its params, the port's model on the same weights)."""
    jm = jax_build_model(jax_get_smoke_config(arch))
    rng = np.random.default_rng(seed)

    def leaf(path, x):   # biases and norm parameters start at 0 / 1
        name = jax.tree_util.keystr(path)
        if name.endswith(("['b']", "['bias']", "['scale']", "['conv_b']", "['dt_bias']")):
            return x + 0.1 * jnp.asarray(rng.standard_normal(x.shape), jnp.float32)
        return x

    params = jax.tree_util.tree_map_with_path(leaf, jm.init(jax.random.key(seed)))
    model = Model(get_smoke_config(arch), device="cpu")
    model.load_state_dict(jax_params_to_torch(_flatten(params)), strict=True)
    return jm, params, model


@pytest.mark.parametrize("arch", ARCHS)
def test_dfm_apply_matches_jax(arch):
    """40 tokens: two SSD chunks (the second padded) for zamba2-2.7b, whose
    shared attention is bidirectional; the recurrent layers stay causal."""
    jm, params, model = _pair(arch)
    rng = np.random.default_rng(7)
    tok = rng.integers(0, V, (2, 40)).astype(np.int32)
    tt = rng.uniform(0.5, 1.0, 2).astype(np.float32)
    want = np.asarray(jax.jit(jm.dfm_apply)(params, jnp.asarray(tok), jnp.asarray(tt)))
    with torch.no_grad():
        got = model.dfm_apply(torch.from_numpy(tok), torch.from_numpy(tt)).numpy()
    assert got.shape == (2, 40, V)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_causal_forward_prefill_and_decode_step_match_jax(arch):
    """The causal forward over 24 tokens; a 12-token prefill then 4 decode
    steps through the cache: logits and every cache leaf (KV, conv, SSM,
    mLSTM/sLSTM states, in JAX's tree) within 1e-5, cursors exact. The
    xLSTM is held looser in two places, by what it was measured to need: its
    24-token forward at 2e-5 (the parallel mLSTM divides by max(|sum_s
    w_ts|, exp(-m_t)), a sum whose terms cancel, so the products' rounding,
    which differs by an ulp between XLA and torch, reaches 1.3e-5 on 2 of
    its 24576 logits) and its state leaves at 5e-5 of their largest value
    (the sLSTM's hid = sigmoid(o) c / n after 16 tokens through 7 mLSTM
    layers: 2.8e-5 on values up to 1.7)."""
    jm, params, model = _pair(arch)
    tok = np.random.default_rng(6).integers(0, V, (2, 24)).astype(np.int32)
    want = jax.jit(lambda p, t: jm.forward(p, {"tokens": t})[0])(params, jnp.asarray(tok))
    with torch.no_grad():
        got = model(torch.from_numpy(tok)).numpy()
    tol = FORWARD_TOL[arch]
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)

    jcache = jm.init_cache(2, 24, jnp.float32)
    cache = model.init_cache(2, 24, torch.float32)
    prefill = jax.jit(lambda p, t, c: jm.prefill(p, {"tokens": t}, c))
    want, jcache = prefill(params, jnp.asarray(tok[:, :12]), jcache)
    decode = jax.jit(jm.decode_step)
    with torch.no_grad():
        got, cache = model.prefill({"tokens": torch.from_numpy(tok[:, :12])}, cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        for i in range(12, 16):
            want, jcache = decode(params, jnp.asarray(tok[:, i:i + 1]), jcache, jnp.int32(i))
            got, cache = model.decode_step(torch.from_numpy(tok[:, i:i + 1]), cache, i)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    jl = jax.tree_util.tree_leaves_with_path(jcache)
    tl = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(lambda t: t.numpy(), cache))
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [jax.tree_util.keystr(p) for p, _ in tl]
    for (path, want), (_, got) in zip(jl, tl):
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype, jax.tree_util.keystr(path)
        tol = STATE_TOL[arch]
        np.testing.assert_allclose(got, want, rtol=tol,
                                   atol=tol * max(1.0, float(np.abs(want).max())))
        if jax.tree_util.keystr(path).endswith("['pos']"):
            assert (got == 16).all()


def _first_mismatches_are_near_ties(adapter, keys, prompt, want, got):
    """Rows where ``got`` differs from ``want``: at the first differing step,
    the port's two best scores (noise + logits) lie within TIE_TOL."""
    want, got = np.asarray(want), np.asarray(got)
    noise = row_gumbel(keys, want.shape[1], V, "cpu")
    for b in np.nonzero((want != got).any(axis=1))[0]:
        i = int(np.argmax(want[b] != got[b]))
        toks = torch.from_numpy(np.concatenate([prompt[b], want[b, :i]]).astype(np.int32))[None]
        cache = adapter.init_cache(1, toks.shape[1])
        for j in range(toks.shape[1]):
            logits, cache = adapter.decode_step(toks[:, j], cache, j)
        top2 = (noise[b, i] + logits[0]).topk(2).values
        assert float(top2[0] - top2[1]) <= TIE_TOL, f"row {b} step {i} is no near tie"


@functools.lru_cache(maxsize=None)
def _jax_draws(arch):
    """JAX's engine on the R7 reproduction: a call on split(key(7), 2), a
    second on split(key(8), 2) with the same (BOS) prompt, and a fresh
    engine's call on split(key(8), 2). Returns the three, JAX's stats."""
    jm, params, _ = _pair(arch)
    jeng = JaxEngine(JaxAdapter(model=jm), params, max_len=MAX_LEN)
    first = np.asarray(jeng.generate_rows(jax.random.split(jax.random.key(7), 2), SEQ))
    second = np.asarray(jeng.generate_rows(jax.random.split(jax.random.key(8), 2), SEQ))
    fresh = JaxEngine(JaxAdapter(model=jm), params, max_len=MAX_LEN)
    want = np.asarray(fresh.generate_rows(jax.random.split(jax.random.key(8), 2), SEQ))
    assert jeng.prefill_mode == "scan"
    return first, second, want, jeng.stats.as_dict()


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_engine_reuses_a_polluted_state(arch):
    """Reference fault R7, pinned: JAX's engine rewinds only the cursors of
    a reused prefix, so its second call decodes from the state its first
    call left and differs from a fresh engine's."""
    _, second, want, stats = _jax_draws(arch)
    assert stats["prefill_reuses"] == 1
    assert (second != want).any()


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_and_a_reused_prefix_equals_a_fresh_one(arch):
    """The port's engine takes the plain path with a scanned prefill, as
    JAX's ``auto`` does. Its first call equals JAX's; its second (the prefix
    reused) equals a fresh JAX engine's off near-ties and a fresh port
    engine's and the cache-free oracle's bitwise; so do a call after
    another prompt and the first prompt recomputed back."""
    _, _, model = _pair(arch)
    first_j, _, want_j, _ = _jax_draws(arch)
    adapter = TransformerDraftAdapter(model=model)
    assert adapter._decoder is None and not adapter.exact_batched_prefill
    eng = ARDraftEngine(adapter, max_len=MAX_LEN)
    assert eng.prefill_mode == "scan"
    bos = np.zeros((2, 1), np.int32)
    k7, k8 = prng.split(prng.key(7), 2), prng.split(prng.key(8), 2)
    _first_mismatches_are_near_ties(adapter, k7, bos, first_j, eng.generate_rows(k7, SEQ))
    second = eng.generate_rows(k8, SEQ)
    assert eng.stats.prefill_reuses == 1
    _first_mismatches_are_near_ties(adapter, k8, bos, want_j, second)
    fresh = ARDraftEngine(adapter, max_len=MAX_LEN).generate_rows(k8, SEQ)
    oracle = oracle_generate_rows(adapter, k8, SEQ, max_len=MAX_LEN)
    assert torch.equal(second, fresh) and torch.equal(second, oracle)
    other = torch.full((2, 1), 5, dtype=torch.int32)
    assert torch.equal(eng.generate_rows(k8, SEQ, prompt=other),
                       oracle_generate_rows(adapter, k8, SEQ, prompt=other, max_len=MAX_LEN))
    assert torch.equal(eng.generate_rows(k8, SEQ), fresh)
    assert eng.stats.as_dict()["prefill_computes"] == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_jax(arch):
    """The arch's smoke model as the flow backbone, 4 x 32, t0 = 0.8,
    cold_nfe = 16, a given draft: tokens, NFE and the report's counts equal
    JAX's server."""
    jm, params, model = _pair(arch)
    draft = np.random.default_rng(4).integers(0, V, (4, 32)).astype(np.int32)
    jserver = JaxWarmStartServer(
        flow_model=jm, flow_cfg=jm.cfg, flow_params=params, path=JaxPath(t0=0.8),
        draft_generate=lambda rng, num: jnp.asarray(draft), cold_nfe=16)
    server = WarmStartServer(
        flow_model=model, flow_cfg=model.cfg, path=WarmStartPath(t0=0.8),
        draft_generate=lambda rng, num: torch.from_numpy(draft.copy()), cold_nfe=16,
        device="cpu")
    x_j, rep_j = jserver.serve(jax.random.key(11), 4)
    x_t, rep_t = server.serve(prng.key(11), 4)
    np.testing.assert_array_equal(np.asarray(x_j), x_t.numpy())
    for k in ("nfe", "backbone_evals", "cold_nfe", "fused_block"):
        assert rep_t[k] == rep_j[k]
    assert rep_t["nfe"] == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_training_the_family_is_refused(arch):
    """The refusal this test pinned is lifted: ``make_loss_fn`` and
    ``make_train_step`` build for the recurrent family and take one finite
    AdamW step that moves the weights (the gradients against JAX's are
    ``test_torch_train_families``'s)."""
    model = Model(get_smoke_config(arch), device="cpu")
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, V, (2, 16)).astype(np.int32))
             for k in ("x_src", "x_tgt")}
    loss, _ = make_loss_fn(model, model.cfg, WarmStartPath(t0=0.8))(model, batch, prng.key(0))
    assert bool(torch.isfinite(loss))
    run = RunConfig(learning_rate=1e-3, warmup_steps=1, total_steps=1)
    opt = build_optimizer(run)
    before = [p.detach().clone() for p in model.parameters()]
    state, metrics = make_train_step(model, model.cfg, run, opt)(
        TrainState.create(model, opt), batch, prng.key(1))
    assert int(state.step) == 1
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    assert any(not torch.equal(b, p) for b, p in zip(before, model.parameters()))
