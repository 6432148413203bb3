"""The torch backbone against the JAX package's ``Model``: checkpoint
conversion both ways, ``dfm_apply`` logits at atol = rtol = 1e-4 on
converted weights (attention through the flash kernel's plain version
here, XLA's ``_sdpa`` in JAX), and the AR serving entry points
``init_cache``/``prefill``/``decode_step`` at 1e-5 on the draft configs
(rmsnorm, bias, gated MLP, tied head, no RoPE, GQA)."""

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _flatten
from repro.configs import dfm_dit as jax_dfm_dit
from repro.models import build_model as jax_build_model
from repro.models.common import time_embed as jax_time_embed
from repro.models.rope import apply_rope as jax_apply_rope, rope_angles as jax_rope_angles
from repro_torch.configs import dfm_dit
from repro_torch.convert import jax_leaves, jax_params_to_torch, torch_params_to_jax
from repro_torch.models import Model
from repro_torch.models.model import check_supported
from repro_torch.models.rope import apply_rope, rope_angles

CONFIGS = {
    "smoke": (jax_dfm_dit.smoke_config, dfm_dit.smoke_config),
    "tiny": (jax_dfm_dit.tiny_config, dfm_dit.tiny_config),
}


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread for these smoke-size models: the suite runs in
    several worker processes at once, where torch's default of a thread a
    core makes each small op wait on the others' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _converted(name, seed=0):
    jax_cfg_fn, cfg_fn = CONFIGS[name]
    jm = jax_build_model(jax_cfg_fn())
    params = jm.init(jax.random.key(seed))
    model = Model(cfg_fn(), device="cpu")
    model.load_state_dict(jax_params_to_torch(_flatten(params)), strict=True)
    return jm, params, model


@pytest.mark.parametrize("name", ["smoke", "tiny"])
def test_jax_params_to_torch_names_and_shapes(name):
    jax_cfg_fn, cfg_fn = CONFIGS[name]
    cfg = cfg_fn()
    params = jax_build_model(jax_cfg_fn()).init(jax.random.key(1))
    flat = _flatten(params)
    sd = jax_params_to_torch(flat)
    want = {k: tuple(v.shape) for k, v in Model(cfg, device="cpu").state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    # layer i of the torch stack is slice i of the JAX stacked leaf
    for i in range(cfg.num_layers):
        np.testing.assert_array_equal(sd[f"blocks.{i}.attn.wq.w"].numpy(),
                                      flat["stack|blocks|p0|attn|wq|w"][i])


def test_head_dim_quirk_survives_replace():
    """replace(d_model=192, num_heads=6) keeps CONFIG's head_dim=64."""
    cfg = dfm_dit.tiny_config()
    assert cfg.head_dim == jax_dfm_dit.tiny_config().head_dim == 64
    sd = Model(cfg, device="cpu").state_dict()
    assert tuple(sd["blocks.0.attn.wq.w"].shape) == (192, 384)
    assert dfm_dit.smoke_config().head_dim == 64
    assert dfm_dit.CONFIG.head_dim == 64 and dfm_dit.CONFIG.scan_split() == (12, ())


@pytest.mark.parametrize("name,b,s", [("smoke", 3, 32), ("tiny", 2, 24)])
def test_dfm_apply_matches_jax(name, b, s):
    jm, params, model = _converted(name)
    rng = np.random.default_rng(7)
    tok = rng.integers(0, 27, (b, s)).astype(np.int32)
    tt = rng.uniform(0.5, 1.0, b).astype(np.float32)
    want = np.asarray(jm.dfm_apply(params, jnp.asarray(tok), jnp.asarray(tt)))
    with torch.no_grad():
        got = model.dfm_apply(torch.from_numpy(tok), torch.from_numpy(tt)).numpy()
    assert got.shape == (b, s, 27)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_causal_forward_matches_jax():
    jm, params, model = _converted("smoke", seed=3)
    tok = np.random.default_rng(2).integers(0, 27, (2, 16)).astype(np.int32)
    want, _ = jm.forward(params, {"tokens": jnp.asarray(tok)})
    with torch.no_grad():
        got = model(torch.from_numpy(tok)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)


def test_rope_and_time_embed_match_jax():
    pos = np.arange(32, dtype=np.int32)
    sj, cj = jax_rope_angles(jnp.asarray(pos), 64, 10000.0)
    st, ct = rope_angles(torch.from_numpy(pos), 64, 10000.0)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)
    x = np.random.default_rng(0).standard_normal((2, 32, 4, 64)).astype(np.float32)
    np.testing.assert_allclose(apply_rope(torch.from_numpy(x), st, ct).numpy(),
                               np.asarray(jax_apply_rope(jnp.asarray(x), sj, cj)), atol=1e-5)
    jm, params, model = _converted("smoke")
    t = np.array([0.0, 0.3, 0.8, 1.0], np.float32)
    want = np.asarray(jax_time_embed(params["time"], jnp.asarray(t), jm.cfg))
    with torch.no_grad():
        got = model.time(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_unsupported_configs_raise():
    """Since the dense zoo, ``local`` layers, qk-norm, post-norms, dual RoPE
    and scaled embeddings are supported, since the recurrent family the
    ``mamba``, ``mlstm``, ``slstm`` and ``zshared`` kinds, and since the MoE
    family the ``moe`` and ``moe_res`` kinds with experts; MoE kinds or the
    MoE family without experts, MLA kinds without ``cfg.mla`` (supported
    with it since the MLA family), the logit softcap and other dtypes still
    raise."""
    cfg = dfm_dit.smoke_config()
    experts = dataclasses.replace(cfg.moe, num_experts=4, d_ff=64)
    for bad in (cfg.replace(norm="scalenorm"), cfg.replace(pattern=("moe",)),
                cfg.replace(attn_logit_softcap=30.0), cfg.replace(dtype="bfloat16"),
                cfg.replace(prefix=("mla",)), cfg.replace(rope_type="mrope"),
                cfg.replace(act="swish"), cfg.replace(family="moe")):
        with pytest.raises(NotImplementedError):
            check_supported(bad)
    check_supported(dfm_dit.CONFIG)
    for good in (cfg.replace(norm="rmsnorm"), cfg.replace(tie_embeddings=True),
                 cfg.replace(mlp_gated=True, use_bias=True, act="relu"),
                 cfg.replace(rope_type="none"), cfg.replace(pattern=("local",)),
                 cfg.replace(qk_norm=True, post_norms=True, embed_scale=True),
                 cfg.replace(rope_type="dual"), cfg.replace(pattern=("mamba",)),
                 cfg.replace(family="hybrid", pattern=("mamba", "zshared")),
                 cfg.replace(family="ssm", pattern=("mlstm", "slstm")),
                 cfg.replace(family="moe", pattern=("moe",), moe=experts),
                 cfg.replace(pattern=("attn", "moe_res"), moe=experts)):
        check_supported(good)


DRAFT_VARIANTS = {
    "dit": {},
    "rmsnorm-gated-bias-tied": dict(norm="rmsnorm", mlp_gated=True, use_bias=True,
                                    tie_embeddings=True, act="silu"),
    "norope-relu-gqa-3layers": dict(rope_type="none", act="relu", num_heads=4,
                                    num_kv_heads=1, num_layers=3),
    # pattern of two: stacked p0/p1 leaves plus one remainder layer r0
    "pattern2-remainder": dict(pattern=("attn", "attn"), num_layers=3),
}


def _draft_pair(name, seed=0):
    kw = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=2, d_ff=64)
    kw.update(DRAFT_VARIANTS[name])
    jm = jax_build_model(jax_dfm_dit.tiny_config(vocab_size=13).replace(**kw))
    rng = np.random.default_rng(seed)

    def leaf(path, x):   # biases and norm parameters start at 0 / 1
        if jax.tree_util.keystr(path).endswith(("['b']", "['bias']", "['scale']")):
            return x + 0.1 * jnp.asarray(rng.standard_normal(x.shape), jnp.float32)
        return x

    params = jax.tree_util.tree_map_with_path(leaf, jm.init(jax.random.key(seed)))
    model = Model(dfm_dit.tiny_config(vocab_size=13).replace(**kw), device="cpu")
    model.load_state_dict(jax_params_to_torch(_flatten(params)), strict=True)
    return jm, params, model


@pytest.mark.parametrize("name", sorted(DRAFT_VARIANTS))
def test_convert_round_trip(name):
    """JAX leaves -> state dict -> JAX leaves, equal; the tied config has
    no head leaf and no torch head."""
    jm, params, model = _draft_pair(name)
    flat = _flatten(params)
    back = torch_params_to_jax(model.state_dict(), model.cfg)
    assert set(back) == set(flat)
    # the optimizers' grouping: JAX's leaf order, layers in slice order
    leaves = jax_leaves(model)
    assert list(leaves) == list(flat)
    for k, ps in leaves.items():
        np.testing.assert_array_equal(
            np.stack([p.detach().numpy() for p in ps]) if k.startswith("stack|blocks|")
            else ps[0].detach().numpy(), flat[k])
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)
    tied = model.cfg.tie_embeddings
    assert (model.head is None) == tied and any(k.startswith("head|") for k in flat) != tied
    if name.startswith("rmsnorm"):
        assert "stack|blocks|p0|mlp|gate|w" in flat and "stack|blocks|p0|attn|wq|b" in flat
        assert "blocks.1.ln1.bias" not in model.state_dict()


@pytest.mark.parametrize("name", sorted(DRAFT_VARIANTS))
def test_prefill_and_decode_step_match_jax(name):
    """A 4-token prefill then three decode steps through the model's own
    cache path: logits and cache leaves within 1e-5, cursors exact."""
    jm, params, model = _draft_pair(name, seed=1)
    tok = np.random.default_rng(6).integers(0, 13, (2, 7)).astype(np.int32)
    jcache = jm.init_cache(2, 10, jnp.float32)
    cache = model.init_cache(2, 10, torch.float32)
    want, jcache = jm.prefill(params, {"tokens": jnp.asarray(tok[:, :4])}, jcache)
    with torch.no_grad():
        got, cache = model.prefill({"tokens": torch.from_numpy(tok[:, :4])}, cache)
        assert got.shape == (2, 1, 13)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        for i in range(4, 7):
            want, jcache = jm.decode_step(params, jnp.asarray(tok[:, i:i + 1]), jcache, i)
            got, cache = model.decode_step(torch.from_numpy(tok[:, i:i + 1]), cache, i)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    jl = jax.tree_util.tree_leaves_with_path(jcache)
    tl = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), cache))
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [jax.tree_util.keystr(p) for p, _ in tl]
    for (path, want), (_, got) in zip(jl, tl):
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
        if jax.tree_util.keystr(path).endswith("['pos']"):
            assert (got == 7).all()


def test_causal_forward_of_draft_configs_matches_jax():
    for name in sorted(DRAFT_VARIANTS):
        jm, params, model = _draft_pair(name, seed=2)
        tok = np.random.default_rng(3).integers(0, 13, (2, 9)).astype(np.int32)
        want, _ = jm.forward(params, {"tokens": jnp.asarray(tok)})
        with torch.no_grad():
            got = model(torch.from_numpy(tok)).numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


def test_init_cache_layout_and_bf16_default():
    model = Model(dfm_dit.smoke_config(), device="cpu")
    cache = model.init_cache(3, 11)
    leaves = cache["blocks"]["p0"]
    assert set(cache) == {"blocks", "rem", "pre"} and not cache["rem"] and not cache["pre"]
    assert leaves["k"].shape == leaves["v"].shape == (2, 3, 11, 4, 64)
    assert leaves["k"].dtype == torch.bfloat16 and leaves["pos"].dtype == torch.int32
    assert leaves["pos"].shape == (2,) and int(leaves["pos"].abs().sum()) == 0


def test_decode_step_with_global_window_matches_jax():
    """``global_window`` limits each query to the last W keys of the cache."""
    jm, params, model = _draft_pair("dit", seed=4)
    tok = np.random.default_rng(8).integers(0, 13, (2, 6)).astype(np.int32)
    jcache = jm.init_cache(2, 8, jnp.float32)
    cache = model.init_cache(2, 8, torch.float32)
    _, jcache = jm.prefill(params, {"tokens": jnp.asarray(tok[:, :4])}, jcache, global_window=3)
    with torch.no_grad():
        _, cache = model.prefill({"tokens": torch.from_numpy(tok[:, :4])}, cache,
                                 global_window=3)
        for i in range(4, 6):
            want, jcache = jm.decode_step(params, jnp.asarray(tok[:, i:i + 1]), jcache, i,
                                          global_window=3)
            got, cache = model.decode_step(torch.from_numpy(tok[:, i:i + 1]), cache, i,
                                           global_window=3)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
