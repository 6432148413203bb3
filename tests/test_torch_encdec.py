"""The encoder-decoder family (whisper-medium) in the port against the JAX
package's, at the whisper smoke config on converted weights (biases and
norm parameters moved off their initial values), with the same frames and
tokens: the sinusoids, ``encode``, ``build_cross_kvs``, cross attention,
``forward`` in both modes and ``dfm_apply`` within 1e-5 (the logits 1e-4);
``prefill`` + ``decode_step`` against the causal forward and against JAX's,
and every cache leaf in JAX's tree; the weights both ways, bitwise; the
model's dispatch and config checks.

The sinusoid tables differ in the last bit of ``exp`` between XLA and torch
(see ``test_sinusoids_match_jax``); at the smoke config's 32 frames and
positions that stays below 1e-6, inside every tolerance here."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _flatten
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import attention as jax_attn
from repro.models import build_model as jax_build_model
from repro.models.encdec import _sinusoids as jax_sinusoids
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import jax_leaves, jax_params_to_torch, torch_params_to_jax
from repro_torch.models import EncDecModel, Model, build_model
from repro_torch.models.encdec import _sinusoids, check_encdec_supported
from repro_torch.models.model import check_supported

ARCH = "whisper-medium"
V, F, D = 512, 32, 128          # the smoke config's vocabulary, frames and width
ACT_TOL = 1e-5                  # activations: encoder states, cross k/v, attention outputs
LOGIT_TOL = 1e-4                # logits (x max(1, max |logit|) through the tied head)


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
def _pair(seed=0):
    """(JAX model, its params, the port's model on the same weights)."""
    jm = jax_build_model(jax_get_smoke_config(ARCH))
    rng = np.random.default_rng(seed)

    def leaf(path, x):   # biases and norm parameters start at 0 / 1
        if jax.tree_util.keystr(path).endswith(("['b']", "['bias']", "['scale']")):
            return x + 0.1 * jnp.asarray(rng.standard_normal(x.shape), jnp.float32)
        return x

    params = jax.tree_util.tree_map_with_path(leaf, jm.init(jax.random.key(seed)))
    model = EncDecModel(get_smoke_config(ARCH), device="cpu")
    model.load_state_dict(jax_params_to_torch(_flatten(params)), strict=True)
    return jm, params, model


def _frames(b=2, seed=1):
    return np.random.default_rng(seed).standard_normal((b, F, D)).astype(np.float32)


def _tokens(b, s, seed=2):
    return np.random.default_rng(seed).integers(0, V, (b, s)).astype(np.int32)


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def test_sinusoids_match_jax():
    """At the smoke config's (32, 128) within 1e-6. At whisper-medium's
    (1500, 1024) the tables differ by up to 1.2e-4 (held at 2e-4): XLA's
    float32 ``exp`` and torch's differ in the last bit of ``inv``, and
    angles up to 1499 rad amplify it. With JAX's own ``inv`` the two agree
    within 1e-6, so the difference is the ``exp``, not ``sin``/``cos``."""
    np.testing.assert_allclose(_sinusoids(F, D).numpy(), np.asarray(jax_sinusoids(F, D)),
                               rtol=0, atol=1e-6)
    want = np.asarray(jax_sinusoids(1500, 1024))
    got = _sinusoids(1500, 1024).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    half = 512
    inv = np.array(jnp.exp(-(np.log(10000.0) / (half - 1)) * jnp.arange(half,
                                                                         dtype=jnp.float32)))
    ang = torch.arange(1500, dtype=torch.float32)[:, None] * torch.from_numpy(inv)[None]
    same_inv = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).numpy()
    np.testing.assert_allclose(same_inv, want, rtol=0, atol=1e-6)


def test_encode_and_cross_kvs_match_jax():
    jm, params, model = _pair()
    fr = _frames()
    want = jax.jit(jm.encode)(params, jnp.asarray(fr))
    want_kv = jax.jit(jm.build_cross_kvs)(params, want)
    with torch.no_grad():
        got = model.encode(torch.from_numpy(fr))
        got_kv = model.build_cross_kvs(got)
    assert got.shape == (2, F, D)
    _close(got.numpy(), want, ACT_TOL)
    for name in ("k", "v"):
        assert got_kv[name].shape == (2, 2, F, 4, 32)     # (L, B, F, H, hd)
        _close(got_kv[name].numpy(), want_kv[name], ACT_TOL)


def test_cross_attention_matches_jax():
    """One decoder layer's cross attention, 7 queries against the 32
    encoder keys, on the same k/v: the port's flash_attn (plain version
    on the CPU, S != T, unmasked) against JAX's einsum softmax."""
    jm, params, model = _pair()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, D)).astype(np.float32)
    enc = rng.standard_normal((2, F, D)).astype(np.float32)
    p1 = jax.tree.map(lambda a: a[1], params["dec_blocks"])["cross"]
    kv = jax_attn.encode_cross_kv(p1, jnp.asarray(enc), jm.cfg)
    want = jax_attn.cross_attention(p1, jnp.asarray(x), kv, jm.cfg)
    cross = model.dec_blocks[1].cross
    with torch.no_grad():
        got_kv = cross.encode_kv(torch.from_numpy(enc))
        got = cross(torch.from_numpy(x), got_kv)
    _close(got_kv["k"].numpy(), kv["k"], ACT_TOL)
    _close(got.numpy(), want, ACT_TOL)


@pytest.mark.parametrize("mode", ["bidir", "causal"])
def test_forward_matches_jax(mode):
    """``forward`` with ``t`` (the DFM denoiser, bidirectional) and without
    (causal): the logits over 24 tokens."""
    jm, params, model = _pair()
    fr, tok = _frames(), _tokens(2, 24)
    tt = np.random.default_rng(4).uniform(0.5, 1.0, 2).astype(np.float32) \
        if mode == "bidir" else None
    want = jax.jit(lambda p, b, t: jm.forward(p, b, t)[0])(
        params, {"tokens": jnp.asarray(tok), "frames": jnp.asarray(fr)},
        None if tt is None else jnp.asarray(tt))
    with torch.no_grad():
        got = model(torch.from_numpy(tok), None if tt is None else torch.from_numpy(tt),
                    frames=torch.from_numpy(fr))
    assert got.shape == (2, 24, V)
    _close(got.numpy(), want, LOGIT_TOL)


def test_dfm_apply_with_extras_matches_jax():
    jm, params, model = _pair()
    fr, tok = _frames(3, seed=5), _tokens(3, 16, seed=6)
    tt = np.array([0.8, 0.9, 0.95], np.float32)
    want = jax.jit(lambda p, x, t, f: jm.dfm_apply(p, x, t, extras={"frames": f}))(
        params, jnp.asarray(tok), jnp.asarray(tt), jnp.asarray(fr))
    with torch.no_grad():
        got = model.dfm_apply(torch.from_numpy(tok), torch.from_numpy(tt),
                              extras={"frames": torch.from_numpy(fr)})
    _close(got.numpy(), want, LOGIT_TOL)
    with pytest.raises(ValueError, match="frames"):
        model.dfm_apply(torch.from_numpy(tok), torch.from_numpy(tt))


def test_prefill_and_decode_step_match_forward_and_jax():
    """JAX's arch check (``tests/test_archs_smoke.py``): a 12-token prefill
    then 4 decode steps through the cache give the causal forward's logits
    (1e-5); each against JAX's prefill/decode_step (1e-5), and every cache
    leaf in JAX's tree (the cross k/v at 1e-5, the cursors exact)."""
    jm, params, model = _pair()
    fr, tok = _frames(), _tokens(2, 16, seed=7)
    with torch.no_grad():
        full = model(torch.from_numpy(tok), frames=torch.from_numpy(fr)).numpy()
    jcache = jm.init_cache(2, 20, jnp.float32)
    cache = model.init_cache(2, 20, torch.float32)
    prefill = jax.jit(jm.prefill)
    decode = jax.jit(jm.decode_step)
    want, jcache = prefill(params, {"tokens": jnp.asarray(tok[:, :12]),
                                    "frames": jnp.asarray(fr)}, jcache)
    with torch.no_grad():
        got, cache = model.prefill({"tokens": torch.from_numpy(tok[:, :12]),
                                    "frames": torch.from_numpy(fr)}, cache)
        _close(got[:, 0].numpy(), full[:, 11], ACT_TOL)
        _close(got.numpy(), want, ACT_TOL)
        for i in range(12, 16):
            want, jcache = decode(params, jnp.asarray(tok[:, i:i + 1]), jcache, jnp.int32(i))
            got, cache = model.decode_step(torch.from_numpy(tok[:, i:i + 1]), cache, i)
            _close(got[:, 0].numpy(), full[:, i], ACT_TOL)
            _close(got.numpy(), want, ACT_TOL)
    jl = jax.tree_util.tree_leaves_with_path(jcache)
    tl = jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda t: t.numpy(), cache))
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [jax.tree_util.keystr(p) for p, _ in tl]
    for (path, want), (_, got) in zip(jl, tl):
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype, jax.tree_util.keystr(path)
        _close(got, want, ACT_TOL)
    np.testing.assert_array_equal(cache["self"]["pos"].numpy(), np.full(2, 16, np.int32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_init_cache_layout_matches_jax(dtype):
    """``{"cross": {"k", "v": (L, B, F, H, hd)}, "self": {"k", "pos", "v"}}``,
    zeros, the self k/v (L, B, T, KH, hd) and the cursors (L,) int32: the
    same paths, shapes and dtypes as JAX's."""
    jm, _, model = _pair()
    jcache = jm.init_cache(3, 9, getattr(jnp, dtype))
    cache = model.init_cache(3, 9, getattr(torch, dtype))
    jl = jax.tree_util.tree_leaves_with_path(jcache)
    tl = jax.tree_util.tree_leaves_with_path(cache)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [jax.tree_util.keystr(p) for p, _ in tl]
    for (path, want), (_, got) in zip(jl, tl):
        assert tuple(got.shape) == want.shape, jax.tree_util.keystr(path)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        assert not bool(got.any())
    assert tuple(cache["cross"]["k"].shape) == (2, 3, F, 4, 32)


def test_weights_convert_both_ways_bitwise():
    """JAX leaves -> state dict -> JAX leaves, bitwise: the stacked
    ``enc_blocks|...`` and ``dec_blocks|...`` leaves by layer, the norms,
    the time embedding and the table by name; ``jax_leaves`` in JAX's
    order, every stacked leaf a list of its layers."""
    cfg = get_smoke_config(ARCH)
    flat = _flatten(jax_build_model(jax_get_smoke_config(ARCH)).init(jax.random.key(2)))
    sd = jax_params_to_torch(flat)
    model = EncDecModel(cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    model.load_state_dict(sd, strict=True)
    back = torch_params_to_jax(model.state_dict(), cfg)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype
    leaves = jax_leaves(model)
    assert list(leaves) == list(flat)
    assert len(leaves["enc_blocks|attn|wq|w"]) == cfg.num_encoder_layers
    assert len(leaves["dec_blocks|cross|wo|b"]) == cfg.num_layers
    np.testing.assert_array_equal(sd["dec_blocks.1.cross.wk.w"].numpy(),
                                  flat["dec_blocks|cross|wk|w"][1])
    np.testing.assert_array_equal(sd["enc_blocks.0.ln2.bias"].numpy(),
                                  flat["enc_blocks|ln2|bias"][0])
    assert {"enc_norm|scale", "dec_norm|bias", "time|w1|w", "embed|table"} <= set(flat)


def test_build_model_dispatches_and_configs_are_checked():
    """``build_model`` gives an ``EncDecModel`` for whisper and a ``Model``
    otherwise; the decoder-only ``Model`` refuses the family and
    ``EncDecModel`` refuses what it does not run (the full config's
    bfloat16 among them); a decoder-only ``dfm_apply`` refuses extras;
    without ``device`` the model wants the card."""
    cfg = get_smoke_config(ARCH)
    assert isinstance(build_model(cfg, device="cpu"), EncDecModel)
    if not torch.cuda.is_available():      # the card is the default: no silent CPU path
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)
    dense = build_model(get_smoke_config("starcoder2-3b"), device="cpu")
    assert isinstance(dense, Model)
    with pytest.raises(NotImplementedError, match="extras"):
        dense.dfm_apply(torch.zeros((1, 4), dtype=torch.int32), torch.ones(1),
                        extras={"frames": torch.zeros(1)})
    with pytest.raises(NotImplementedError, match="family=audio"):
        check_supported(cfg)
    check_encdec_supported(cfg)
    check_encdec_supported(get_config(ARCH).replace(dtype="float32"))
    for bad, what in ((get_config(ARCH), "dtype"), (cfg.replace(norm="rmsnorm"), "norm"),
                      (cfg.replace(act="silu"), "act"), (cfg.replace(use_bias=False), "bias"),
                      (cfg.replace(rope_type="default"), "rope"),
                      (cfg.replace(attn_logit_softcap=30.0), "softcap"),
                      (get_smoke_config("starcoder2-3b"), "is_encoder_decoder")):
        with pytest.raises(NotImplementedError, match=what):
            EncDecModel(bad, device="cpu")
    assert jax_get_config(ARCH).num_audio_frames == get_config(ARCH).num_audio_frames == 1500
