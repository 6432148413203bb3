"""The torch DiT backbone against the JAX package's ``Model``: checkpoint
conversion, and ``dfm_apply`` logits at atol = rtol = 1e-4 on converted
weights (attention through the flash kernel's plain version here, XLA's
``_sdpa`` in JAX)."""

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
from repro_torch.convert import jax_params_to_torch
from repro_torch.models import Model
from repro_torch.models.model import check_supported
from repro_torch.models.rope import apply_rope, rope_angles

CONFIGS = {
    "smoke": (jax_dfm_dit.smoke_config, dfm_dit.smoke_config),
    "tiny": (jax_dfm_dit.tiny_config, dfm_dit.tiny_config),
}


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
    cfg = dfm_dit.smoke_config()
    for bad in (cfg.replace(norm="rmsnorm"), cfg.replace(pattern=("local",)),
                cfg.replace(tie_embeddings=True), cfg.replace(dtype="bfloat16"),
                cfg.replace(mlp_gated=True), cfg.replace(rope_type="none")):
        with pytest.raises(NotImplementedError):
            check_supported(bad)
    check_supported(dfm_dit.CONFIG)
