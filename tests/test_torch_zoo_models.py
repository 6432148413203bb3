"""The dense zoo's models in the port against the JAX package's, at the four
archs' smoke configs on converted weights (norm scales and biases moved off
their initial values, so that each is exercised): ``dfm_apply`` at atol =
rtol = 1e-4; the causal ``forward``, ``prefill`` and ``decode_step`` at
1e-5; ``ARDraftEngine`` tokens (the dense three through the draft kernels'
plain versions, gemma3-1b through the plain decode path, each as JAX's
``decode_impl="auto"`` picks) equal to JAX's off near-ties;
``WarmStartServer.serve`` tokens and NFE equal to JAX's; and gemma3's
sliding window, dual RoPE, qk-norm, post-norms and scaled embedding each
pinned by a case that fails when the port drops it."""

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
from repro_torch.convert import jax_params_to_torch
from repro_torch.core.paths import WarmStartPath
from repro_torch.drafting import ARDraftEngine, TransformerDraftAdapter, row_gumbel
from repro_torch.models import Model
from repro_torch.models import model as model_mod
from repro_torch.models.rope import rope_context
from repro_torch.serving import WarmStartServer

ZOO = ("starcoder2-3b", "minitron-4b", "command-r-plus-104b", "gemma3-1b")
V = 512                       # the smoke configs' vocabulary
TIE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread for these smoke-size models: the suite runs in
    several worker processes at once, where torch's default of a thread a
    core makes each small op wait on the others' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jitted(arch):
    """JAX's entry points for ``arch``'s smoke model, jitted once."""
    jm = jax_build_model(jax_get_smoke_config(arch))
    return {"dfm_apply": jax.jit(jm.dfm_apply),
            "forward": jax.jit(lambda p, t: jm.forward(p, {"tokens": t})[0]),
            "prefill": jax.jit(lambda p, t, c: jm.prefill(p, {"tokens": t}, c)),
            "decode_step": jax.jit(jm.decode_step)}


@functools.lru_cache(maxsize=None)
def _pair(arch, seed=0):
    """(JAX model, its params, the port's model on the same weights)."""
    jm = jax_build_model(jax_get_smoke_config(arch))
    rng = np.random.default_rng(seed)

    def leaf(path, x):   # biases and norm parameters start at 0 / 1
        if jax.tree_util.keystr(path).endswith(("['b']", "['bias']", "['scale']")):
            return x + 0.1 * jnp.asarray(rng.standard_normal(x.shape), jnp.float32)
        return x

    params = jax.tree_util.tree_map_with_path(leaf, jm.init(jax.random.key(seed)))
    model = Model(get_smoke_config(arch), device="cpu")
    model.load_state_dict(jax_params_to_torch(_flatten(params)), strict=True)
    return jm, params, model


def _dfm_inputs(b=2, s=40, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, (b, s)).astype(np.int32),
            rng.uniform(0.5, 1.0, b).astype(np.float32))


@pytest.mark.parametrize("arch", ZOO)
def test_dfm_apply_matches_jax(arch):
    """40 tokens: past gemma3's 16-token smoke window, so the local mask cuts."""
    _, params, model = _pair(arch)
    tok, tt = _dfm_inputs()
    want = np.asarray(_jitted(arch)["dfm_apply"](params, jnp.asarray(tok), jnp.asarray(tt)))
    with torch.no_grad():
        got = model.dfm_apply(torch.from_numpy(tok), torch.from_numpy(tt)).numpy()
    assert got.shape == (2, 40, V)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ZOO)
def test_causal_forward_prefill_and_decode_step_match_jax(arch):
    """The causal forward over 24 tokens; a 12-token prefill then 6 decode
    steps through the cache (gemma3's window of 16 cuts by the end): logits
    and every cache leaf within 1e-5, cursors exact."""
    jm, params, model = _pair(arch)
    fns = _jitted(arch)
    tok = np.random.default_rng(6).integers(0, V, (2, 24)).astype(np.int32)
    want = fns["forward"](params, jnp.asarray(tok))
    with torch.no_grad():
        got = model(torch.from_numpy(tok)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)

    jcache = jm.init_cache(2, 24, jnp.float32)
    cache = model.init_cache(2, 24, torch.float32)
    want, jcache = fns["prefill"](params, jnp.asarray(tok[:, :12]), jcache)
    with torch.no_grad():
        got, cache = model.prefill({"tokens": torch.from_numpy(tok[:, :12])}, cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        for i in range(12, 18):
            want, jcache = fns["decode_step"](params, jnp.asarray(tok[:, i:i + 1]), jcache,
                                              jnp.int32(i))
            got, cache = model.decode_step(torch.from_numpy(tok[:, i:i + 1]), cache, i)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    jl = jax.tree_util.tree_leaves_with_path(jcache)
    tl = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(lambda t: t.numpy(), cache))
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [jax.tree_util.keystr(p) for p, _ in tl]
    for (path, want), (_, got) in zip(jl, tl):
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
        if jax.tree_util.keystr(path).endswith("['pos']"):
            assert (got == 18).all()


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


@pytest.mark.parametrize("arch", ZOO)
def test_engine_tokens_match_jax(arch):
    """Both engines at ``decode_impl="auto"``: the draft kernels (plain
    versions here, Pallas in interpret mode in JAX) for the dense three,
    batched prefill; gemma3-1b the plain decode path, scanned prefill. Two
    calls: a prefill, then the pooled prefix reused."""
    jm, params, model = _pair(arch)
    adapter = TransformerDraftAdapter(model=model)
    kj = jax.random.split(jax.random.key(5), 2)
    kt = prng.split(prng.key(5), 2)
    prompt = np.tile(np.random.default_rng(9).integers(0, V, 3).astype(np.int32), (2, 1))
    jeng = JaxEngine(JaxAdapter(model=jm), params, max_len=3 + 6 - 1)
    eng = ARDraftEngine(adapter, max_len=3 + 6 - 1)
    mode = "scan" if arch == "gemma3-1b" else "batched"
    assert jeng.prefill_mode == eng.prefill_mode == mode
    for _ in range(2):
        want = jeng.generate_rows(kj, 6, prompt=jnp.asarray(prompt))
        got = eng.generate_rows(kt, 6, prompt=torch.from_numpy(prompt))
        assert got.shape == (2, 6) and got.dtype == torch.int32
        _first_mismatches_are_near_ties(adapter, kt, prompt, want, got)
    assert eng.stats.as_dict() == jeng.stats.as_dict()


def test_gemma3_drafts_on_the_plain_path():
    """JAX's ``auto`` takes XLA for gemma3 (outside the draft kernels'
    subset), so the port's takes the model's own decode; asking for the
    kernels raises."""
    model = _pair("gemma3-1b")[2]
    assert TransformerDraftAdapter(model=model)._decoder is None
    assert not TransformerDraftAdapter(model=model).exact_batched_prefill
    with pytest.raises(ValueError, match="draft_decode"):
        TransformerDraftAdapter(model=model, decode_impl="kernel")._decoder
    assert TransformerDraftAdapter(model=_pair("starcoder2-3b")[2])._decoder is not None


@pytest.mark.parametrize("arch", ZOO)
def test_serve_matches_jax(arch):
    """The arch's smoke model as the flow backbone, a given draft: tokens,
    NFE and the report's counts equal JAX's server."""
    jm, params, model = _pair(arch)
    draft = np.random.default_rng(4).integers(0, V, (3, 24)).astype(np.int32)
    jserver = JaxWarmStartServer(
        flow_model=jm, flow_cfg=jm.cfg, flow_params=params, path=JaxPath(t0=0.8),
        draft_generate=lambda rng, num: jnp.asarray(draft), cold_nfe=16)
    server = WarmStartServer(
        flow_model=model, flow_cfg=model.cfg, path=WarmStartPath(t0=0.8),
        draft_generate=lambda rng, num: torch.from_numpy(draft.copy()), cold_nfe=16,
        device="cpu")
    x_j, rep_j = jserver.serve(jax.random.key(11), 3)
    x_t, rep_t = server.serve(prng.key(11), 3)
    np.testing.assert_array_equal(np.asarray(x_j), x_t.numpy())
    for k in ("nfe", "backbone_evals", "cold_nfe", "fused_block"):
        assert rep_t[k] == rep_j[k]
    assert rep_t["nfe"] == 4


def _drop(feature, model, monkeypatch):
    """Take one gemma3 feature out of the port's model (or its forward)."""
    if feature == "window":
        for blk in model.blocks:
            blk.window = None
    elif feature == "dual_rope":
        monkeypatch.setattr(model_mod, "rope_context",
                            lambda cfg, pos, **kw: rope_context(cfg.replace(rope_type="default"),
                                                                pos, **kw))
    elif feature == "qk_norm":
        for blk in model.blocks:
            blk.attn.qnorm = blk.attn.knorm = None
    elif feature == "post_norms":
        for blk in model.blocks:
            blk.post_attn = blk.post_ffn = None
    elif feature == "embed_scale":
        model.embed.mult = None


@pytest.mark.parametrize("feature", ["window", "dual_rope", "qk_norm", "post_norms",
                                     "embed_scale"])
def test_gemma3_feature_is_pinned(feature, monkeypatch):
    """gemma3-1b's smoke model equals JAX's within 1e-4, and no longer does
    (by more than 1e-3) once the port drops ``feature``: the parity tests
    above would catch its loss."""
    _, params, base = _pair("gemma3-1b")
    model = Model(get_smoke_config("gemma3-1b"), device="cpu")
    model.load_state_dict(base.state_dict())
    tok, tt = _dfm_inputs()
    want = np.asarray(_jitted("gemma3-1b")["dfm_apply"](params, jnp.asarray(tok),
                                                         jnp.asarray(tt)))
    with torch.no_grad():
        got = model.dfm_apply(torch.from_numpy(tok), torch.from_numpy(tt)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        _drop(feature, model, monkeypatch)
        dropped = model.dfm_apply(torch.from_numpy(tok), torch.from_numpy(tt)).numpy()
    assert np.abs(dropped - want).max() > 1e-3


def test_prefix_layers_match_jax():
    """A config with a prefix layer before the pattern and a remainder after
    it runs its layers in JAX's stack order, with their caches in ``pre``."""
    cfg = get_smoke_config("gemma3-1b").replace(prefix=("attn",), num_layers=4,
                                                pattern=("local", "attn"))
    jm = jax_build_model(jax_get_smoke_config("gemma3-1b").replace(
        prefix=("attn",), num_layers=4, pattern=("local", "attn")))
    params = jm.init(jax.random.key(4))
    model = Model(cfg, device="cpu")
    model.load_state_dict(jax_params_to_torch(_flatten(params)), strict=True)
    assert [b.kind for b in model.blocks] == ["attn", "local", "attn", "local"]
    tok, tt = _dfm_inputs()
    want = np.asarray(jax.jit(jm.dfm_apply)(params, jnp.asarray(tok), jnp.asarray(tt)))
    with torch.no_grad():
        got = model.dfm_apply(torch.from_numpy(tok), torch.from_numpy(tt)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    jcache = jm.init_cache(2, 24, jnp.float32)
    cache = model.init_cache(2, 24, torch.float32)
    want, jcache = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(tok[:, :20])}, jcache)
    with torch.no_grad():
        got, cache = model.prefill({"tokens": torch.from_numpy(tok[:, :20])}, cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert set(cache["pre"]) == set(jcache["pre"]) == {"x0"}
    np.testing.assert_allclose(cache["pre"]["x0"]["k"].numpy(),
                               np.asarray(jcache["pre"]["x0"]["k"]), atol=1e-5)
