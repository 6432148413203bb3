"""The MLA family in the port against the JAX package on the CPU, at
deepseek-v3-671b's smoke config (one dense ``mla`` prefix layer, one
``mla_moe`` layer of 4 experts top-2 beside a shared expert; d 128, 4 heads,
q_lora 64, kv_lora 32, qk 32 + 16, v 32; MTP depth 1), on the port's seeded
weights converted to JAX's tree (norm scales moved off their initial zeros,
numpy seed 0): the config fields; ``MLAttention`` without a cache against
JAX ``mla_attention`` (bidirectional and causal, its XLA path and
``_mla_chunked``) within 1e-5; a cached prefill and three decode steps,
naive and absorbed, within 1e-5 with the latent cache and cursor equal;
``dfm_apply`` within 1e-4; the causal forward, prefill and decode within
1e-5; the draft engine and a serve against JAX's; the weights both ways
bitwise; the loss (CE + MTP + the router's auxiliary term) and every
gradient within 1e-4 of each leaf's max |g|; ``attention_backward`` with V
narrower than Q and K against ``jax.grad``.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _flatten
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.core.paths import WarmStartPath as JaxPath
from repro.drafting import ARDraftEngine as JaxEngine
from repro.drafting import TransformerDraftAdapter as JaxAdapter
from repro.kernels import draft_decode_supported as jax_draft_decode_supported
from repro.models import build_model as jax_build_model
from repro.models.attention import _sdpa as jax_sdpa
from repro.models.attention import attn_mask as jax_attn_mask
from repro.models.attention import init_mla_cache as jax_init_mla_cache
from repro.models.attention import mla_attention as jax_mla_attention
from repro.models.rope import rope_angles as jax_rope_angles
from repro.serving.engine import WarmStartServer as JaxWarmStartServer
from repro.training import make_loss_fn as jax_make_loss_fn
from repro_torch import prng
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import jax_leaves, jax_params_to_torch, torch_params_to_jax
from repro_torch.core.paths import WarmStartPath
from repro_torch.drafting import ARDraftEngine, TransformerDraftAdapter
from repro_torch.kernels.draft_decode import draft_decode_supported
from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref
from repro_torch.kernels.flash_attn.ops import attention_backward
from repro_torch.models import Model
from repro_torch.models.attention import init_mla_cache
from repro_torch.models.model import check_supported
from repro_torch.models.rope import rope_angles
from repro_torch.optim.adafactor import stack_leaf
from repro_torch.serving import WarmStartServer
from repro_torch.training import make_loss_fn
from repro_torch.training.train_step import loss_and_grads
from test_torch_moe import _first_mismatches_are_near_ties
from test_torch_train_families import _nest

ARCH = "deepseek-v3-671b"
V = 512                       # the smoke config's vocabulary
D = 128                       # its d_model
T0 = 0.8
ATTN_TOL = 1e-5
LOGIT_TOL = 1e-4
GRAD_TOL = 1e-4               # x max |g| of the leaf


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
def _pair(absorb=False):
    """(JAX model, its params, the port's model on the same weights): the
    port's seeded init (seed 0) in JAX's tree, rmsnorm scales moved off 0.
    ``absorb`` builds both sides with ``mla_absorb=True``."""
    cfg = get_smoke_config(ARCH)
    flat = torch_params_to_jax(Model(cfg, device="cpu", seed=0).state_dict(), cfg)
    rng = np.random.default_rng(0)
    for k in sorted(flat):
        if k.endswith("|scale"):
            flat[k] = flat[k] + 0.1 * rng.standard_normal(flat[k].shape).astype(np.float32)
    params = _nest(flat)
    params["stack"].setdefault("rem", {})
    model = Model(cfg.replace(mla_absorb=absorb), device="cpu", seed=1)
    model.load_state_dict(jax_params_to_torch(flat), strict=True)
    jcfg = jax_get_smoke_config(ARCH).replace(mla_absorb=absorb)
    return jax_build_model(jcfg), params, model


def _hidden(seed, b=2, s=24):
    return np.random.default_rng(seed).standard_normal((b, s, D)).astype(np.float32)


def _positions(b, s, offset=0):
    return np.broadcast_to(np.arange(offset, offset + s, dtype=np.int32), (b, s)).copy()


def _jax_mla(cfg, mode):
    """JAX's ``mla_attention`` at ``cfg`` and ``mode``, jitted (op by op it
    compiles each primitive apart)."""
    return jax.jit(lambda p, x, sin, cos, q_pos, cache: jax_mla_attention(
        p, x, cfg, sin=sin, cos=cos, mode=mode, q_pos=q_pos, cache=cache))


def _port_angles(cfg, q_pos):
    return rope_angles(torch.from_numpy(q_pos), cfg.mla.qk_rope_head_dim, cfg.rope_theta)


@pytest.mark.parametrize("which", ["full", "smoke"])
def test_config_fields_equal_jax(which):
    """The registry builds both configs; every field equals JAX's; both are
    taken by the model (the full one in float32: its bfloat16 default is
    refused) and refused by the draft kernels, as JAX's are."""
    want = jax_get_config(ARCH) if which == "full" else jax_get_smoke_config(ARCH)
    got = get_config(ARCH) if which == "full" else get_smoke_config(ARCH)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.scan_split() == want.scan_split() and got.head_dim == want.head_dim
    assert got.mtp_depth == 1 and got.moe.num_shared_experts == 1
    check_supported(got.replace(dtype="float32"))
    if which == "full":
        with pytest.raises(NotImplementedError, match="dtype"):
            check_supported(got)
        assert (got.prefix, got.pattern, got.scan_split()) == (("mla",) * 3, ("mla_moe",),
                                                                (58, ()))
    assert not draft_decode_supported(got) and not jax_draft_decode_supported(want)


@pytest.mark.parametrize("impl", ["xla", "chunked"])
@pytest.mark.parametrize("mode", ["bidir", "causal"])
def test_mla_without_a_cache_matches_jax(mode, impl):
    """The prefix layer's MLA over 2 x 24 tokens (through ``flash_attn``'s
    plain version with V 32 wide against Q and K 48 wide) against JAX's
    ``mla_attention``: its XLA path, and ``_mla_chunked`` (``attn_impl=
    "chunked"`` at ``attn_chunk`` 8, three key chunks); within 1e-5."""
    jm, params, model = _pair()
    jcfg = jm.cfg.replace(attn_impl=impl, attn_chunk=8)
    x, q_pos = _hidden(1), _positions(2, 24)
    sin, cos = jax_rope_angles(jnp.asarray(q_pos), 32, jcfg.rope_theta)
    want, _ = _jax_mla(jcfg, mode)(params["stack"]["pre"]["x0"]["attn"], jnp.asarray(x), sin,
                                   cos, jnp.asarray(q_pos), None)
    sin, cos = _port_angles(model.cfg, q_pos)
    with torch.no_grad():
        got = model.blocks[0].attn(torch.from_numpy(x), sin=sin, cos=cos, mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.parametrize("absorb", [False, True])
def test_cached_prefill_and_decode_steps_match_jax(absorb):
    """The ``mla_moe`` layer's MLA with a cache: a 10-token prefill, then
    three one-token decode steps, naive or absorbed (``mla_absorb``: the
    latent never expanded); each output within 1e-5 of JAX's, ``c_kv`` and
    ``k_pe`` within 1e-5 and the cursor equal after every call."""
    jm, params, model = _pair(absorb)
    p = jax.tree.map(lambda a: a[0], params["stack"]["blocks"]["p0"]["attn"])
    mla = model.blocks[1].attn
    x = _hidden(2, s=13)
    jcache = jax_init_mla_cache(jm.cfg, 2, 16, jnp.float32)
    cache = init_mla_cache(model.cfg, 2, 16, torch.float32, "cpu")
    step = _jax_mla(jm.cfg, "causal")
    for lo, hi in ((0, 10), (10, 11), (11, 12), (12, 13)):
        q_pos = _positions(2, hi - lo, lo)
        sin, cos = jax_rope_angles(jnp.asarray(q_pos), 16, jm.cfg.rope_theta)
        want, jcache = step(p, jnp.asarray(x[:, lo:hi]), sin, cos, jnp.asarray(q_pos), jcache)
        sin, cos = _port_angles(model.cfg, q_pos)
        with torch.no_grad():
            got, cache = mla.forward_cached(torch.from_numpy(x[:, lo:hi]), cache, sin=sin,
                                            cos=cos, q_pos=torch.from_numpy(q_pos),
                                            absorb=absorb)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL, rtol=ATTN_TOL)
        for leaf in ("c_kv", "k_pe"):
            np.testing.assert_allclose(cache[leaf].numpy(), np.asarray(jcache[leaf]),
                                       atol=ATTN_TOL, rtol=ATTN_TOL, err_msg=leaf)
        assert int(cache["pos"]) == int(jcache["pos"]) == hi


def test_absorbed_decode_equals_naive_within_rounding():
    """The absorbed and the naive decode are the same function: after one
    prefill into the same cache, a decode step's output differs by float32
    rounding only (1e-5)."""
    _, _, naive = _pair(False)
    _, _, absorbed = _pair(True)
    tok = np.random.default_rng(3).integers(0, V, (2, 9)).astype(np.int32)
    outs = []
    for model in (naive, absorbed):
        cache = model.init_cache(2, 12, torch.float32)
        with torch.no_grad():
            _, cache = model.prefill({"tokens": torch.from_numpy(tok[:, :8])}, cache)
            outs.append(model.decode_step(torch.from_numpy(tok[:, 8:]), cache, 8)[0])
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), atol=1e-5, rtol=1e-5)
    assert not torch.equal(outs[0], outs[1])       # two computations, not one


def test_dfm_apply_matches_jax():
    jm, params, model = _pair()
    rng = np.random.default_rng(7)
    tok = rng.integers(0, V, (2, 40)).astype(np.int32)
    tt = rng.uniform(0.5, 1.0, 2).astype(np.float32)
    want = np.asarray(jax.jit(jm.dfm_apply)(params, jnp.asarray(tok), jnp.asarray(tt)))
    with torch.no_grad():
        got = model.dfm_apply(torch.from_numpy(tok), torch.from_numpy(tt)).numpy()
    assert got.shape == (2, 40, V)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("absorb", [False, True])
def test_causal_forward_prefill_and_decode_step_match_jax(absorb):
    """The causal forward over 20 tokens; a 12-token prefill then 4 decode
    steps (the absorbed decode too): logits and every cache leaf within
    1e-5, cursors exact; the cache tree is JAX's (``pre|x0`` and the
    stacked ``blocks|p0``, each ``{c_kv, k_pe, pos}``)."""
    jm, params, model = _pair(absorb)
    tok = np.random.default_rng(6).integers(0, V, (2, 20)).astype(np.int32)
    want = jax.jit(lambda p, t: jm.forward(p, {"tokens": t})[0])(params, jnp.asarray(tok))
    with torch.no_grad():
        got = model(torch.from_numpy(tok)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATTN_TOL, rtol=ATTN_TOL)

    jcache = jm.init_cache(2, 20, jnp.float32)
    cache = model.init_cache(2, 20, torch.float32)
    want, jcache = jax.jit(lambda p, t, c: jm.prefill(p, {"tokens": t}, c))(
        params, jnp.asarray(tok[:, :12]), jcache)
    decode = jax.jit(jm.decode_step)
    with torch.no_grad():
        got, cache = model.prefill({"tokens": torch.from_numpy(tok[:, :12])}, cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL, rtol=ATTN_TOL)
        for i in range(12, 16):
            want, jcache = decode(params, jnp.asarray(tok[:, i:i + 1]), jcache, jnp.int32(i))
            got, cache = model.decode_step(torch.from_numpy(tok[:, i:i + 1]), cache, i)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL,
                                       rtol=ATTN_TOL)
    jl = jax.tree_util.tree_leaves_with_path(jcache)
    tl = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(lambda t: t.numpy(), cache))
    paths = [jax.tree_util.keystr(p) for p, _ in jl]
    assert paths == [jax.tree_util.keystr(p) for p, _ in tl]
    assert any("c_kv" in p for p in paths) and not any("['k']" in p for p in paths)
    for (path, want), (_, got) in zip(jl, tl):
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype, jax.tree_util.keystr(path)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * max(1.0, float(np.abs(want).max())))
        if jax.tree_util.keystr(path).endswith("['pos']"):
            assert (got == 16).all()


def test_engine_matches_jax_and_a_reused_prefix_equals_a_fresh_engine():
    """The draft kernels refuse MLA, so ``auto`` takes the plain decode path
    with a scanned prefill, as JAX's; 3 rows of 8 tokens after a 4-token
    prompt equal JAX's engine off near-ties; a second call (the prefix
    reused, the latent cache rewound in place) equals a fresh engine's."""
    jm, params, model = _pair()
    adapter = TransformerDraftAdapter(model=model, decode_impl="xla")
    assert TransformerDraftAdapter(model=model)._decoder is None
    eng = ARDraftEngine(adapter, max_len=12)
    jeng = JaxEngine(JaxAdapter(model=jm), params, max_len=12)
    assert eng.prefill_mode == jeng.prefill_mode == "scan"
    prompt = np.array([[3, 1, 4, 1]] * 3, np.int32)
    want = jeng.generate_rows(jax.random.split(jax.random.key(5), 3), 8,
                              prompt=jnp.asarray(prompt))
    keys = prng.split(prng.key(5), 3)
    got = eng.generate_rows(keys, 8, torch.from_numpy(prompt))
    _first_mismatches_are_near_ties(adapter, keys, prompt, want, got)
    keys = prng.split(prng.key(6), 3)
    again = eng.generate_rows(keys, 8, torch.from_numpy(prompt))
    assert eng.stats.prefill_reuses == 1
    fresh = ARDraftEngine(TransformerDraftAdapter(model=model, decode_impl="xla"), max_len=12)
    assert torch.equal(again, fresh.generate_rows(keys, 8, torch.from_numpy(prompt)))


def test_serve_matches_jax():
    """The smoke model as the flow backbone (``flash_attn`` with V narrower
    than Q and K and the capacity path in every NFE), 4 x 32, t0 = 0.8,
    cold_nfe = 16, a given draft: tokens, NFE and the report's counts equal
    JAX's server."""
    jm, params, model = _pair()
    draft = np.random.default_rng(4).integers(0, V, (4, 32)).astype(np.int32)
    jserver = JaxWarmStartServer(
        flow_model=jm, flow_cfg=jm.cfg, flow_params=params, path=JaxPath(t0=T0),
        draft_generate=lambda rng, num: jnp.asarray(draft), cold_nfe=16)
    server = WarmStartServer(
        flow_model=model, flow_cfg=model.cfg, path=WarmStartPath(t0=T0),
        draft_generate=lambda rng, num: torch.from_numpy(draft.copy()), cold_nfe=16,
        device="cpu")
    x_j, rep_j = jserver.serve(jax.random.key(11), 4)
    x_t, rep_t = server.serve(prng.key(11), 4)
    np.testing.assert_array_equal(np.asarray(x_j), x_t.numpy())
    for k in ("nfe", "backbone_evals", "cold_nfe", "fused_block"):
        assert rep_t[k] == rep_j[k]
    assert rep_t["nfe"] == 4


def test_weights_convert_both_ways_bitwise():
    """JAX's tree (``stack|pre|x0|attn|wq_a|w`` ... ``wkv_b``, ``q_norm``,
    ``kv_norm``, the prefix layer's MLP; ``stack|blocks|p0|attn|...`` and
    ``moe|shared|…`` stacked (1, ...)) -> state dict -> JAX's tree, bitwise,
    and the optimizers' leaf groups in JAX's leaf order."""
    _, params, model = _pair()
    want = _flatten(params)
    back = torch_params_to_jax(model.state_dict(), model.cfg)
    assert sorted(back) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert back[k].dtype == w.dtype and back[k].tobytes() == w.tobytes(), k
    assert want["stack|pre|x0|attn|wq_b|w"].shape == (64, 4 * 48)
    assert want["stack|pre|x0|attn|wkv_a|w"].shape == (D, 32 + 16)
    assert want["stack|blocks|p0|attn|wkv_b|w"].shape == (1, 32, 4 * (32 + 32))
    assert want["stack|blocks|p0|moe|shared|up|w"].shape == (1, D, 64)
    assert "stack|pre|x0|mlp|gate|w" in want
    assert list(jax_leaves(model)) == list(want)


def _batch():
    r = np.random.default_rng(1)
    return {k: r.integers(0, V, (2, 24)).astype(np.int32) for k in ("x_src", "x_tgt")}


def test_loss_with_mtp_and_every_gradient_match_jax():
    """The WS-DFM loss with ``router_aux_weight · aux`` and ``0.1 · mtp``
    (DeepSeek's depth-1 MTP term) against ``jax.value_and_grad`` of JAX's:
    the loss, CE, MTP and ``moe_aux`` within 1e-6 relative, t_mean exact,
    and every leaf's gradient (MLA's through ``FlashAttentionFn`` with V
    narrower than Q and K) within GRAD_TOL of its max |g|."""
    jm, params, model = _pair()
    fn = jax.jit(jax.value_and_grad(jax_make_loss_fn(jm, jm.cfg, JaxPath(T0)), has_aux=True))
    (want_loss, want_m), want = fn(params, {k: jnp.asarray(v) for k, v in _batch().items()},
                                   jax.random.key(3))
    want = _flatten(want)
    loss, metrics, grads = loss_and_grads(
        make_loss_fn(model, model.cfg, WarmStartPath(T0)), model, jax_leaves(model),
        {k: torch.from_numpy(v) for k, v in _batch().items()}, prng.key(3))
    assert set(metrics) == set(want_m) == {"ce", "t_mean", "moe_aux", "mtp", "loss"}
    for k in ("loss", "ce", "mtp", "moe_aux"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(want_m[k]), rtol=1e-6,
                                   err_msg=k)
    assert float(metrics["t_mean"]) == float(want_m["t_mean"])
    m = {k: v.detach() for k, v in metrics.items()}
    assert float(loss.detach()) == float(m["ce"] + model.cfg.moe.router_aux_weight
                                         * m["moe_aux"] + 0.1 * m["mtp"])
    assert list(grads) == list(want)
    for k, w in want.items():
        got = stack_leaf(k, [g.detach() for g in grads[k]]).numpy()
        assert got.shape == w.shape, k
        np.testing.assert_allclose(got, w, rtol=0, atol=GRAD_TOL * np.abs(w).max(), err_msg=k)
    for k in ("stack|pre|x0|attn|wkv_b|w", "stack|blocks|p0|attn|wq_b|w",
              "stack|blocks|p0|moe|shared|down|w", "stack|blocks|p0|moe|router"):
        assert np.abs(want[k]).max() > 0, k


@pytest.mark.parametrize("causal", [False, True])
def test_attention_backward_with_narrow_values_matches_jax(causal):
    """``attention_backward`` (the gradient ``FlashAttentionFn`` returns) at
    q, k (2, 20, 4, 48), v (2, 20, 4, 32) against ``jax.grad`` of JAX's
    ``_sdpa`` under the same mask: dq, dk, dv within 1e-5 of each max |g|;
    the forward's plain version within 1e-6 of ``_sdpa``."""
    rng = np.random.default_rng(11)
    q, k = (rng.standard_normal((2, 20, 4, 48)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((2, 20, 4, 32)).astype(np.float32)
    d_out = rng.standard_normal((2, 20, 4, 32)).astype(np.float32)
    scale = 1.0 / math.sqrt(48)
    pos = jnp.asarray(_positions(2, 20))
    mask = jax_attn_mask(pos, pos, mode="causal" if causal else "bidir", window=None)

    def f(q_, k_, v_):
        out = jax_sdpa(q_.reshape(2, 20, 4, 1, 48), k_, v_, mask, scale=scale)
        return jnp.sum(out.reshape(2, 20, 4, 32) * d_out), out.reshape(2, 20, 4, 32)

    (_, want_out), want = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = flash_attention_ref(tq, tk, tv, causal=causal, scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-6, rtol=1e-6)
    got = attention_backward(tq, tk, tv, torch.from_numpy(d_out), causal=causal, window=None,
                             scale=scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)
    tq.requires_grad_(True)
    with torch.enable_grad():
        out = flash_attention(tq, tk, tv, causal=causal, scale=scale)
    assert out.shape == (2, 20, 4, 32) and out.grad_fn is not None


def test_what_stays_refused():
    """An MLA kind without ``cfg.mla``, post-norms on MLA layers, and a
    q/k and v width pair the kernel is not built for (on a CPU tensor the
    plain version takes any pair)."""
    cfg = get_smoke_config(ARCH)
    for bad in (cfg.replace(mla=None), cfg.replace(post_norms=True),
                get_smoke_config("starcoder2-3b").replace(prefix=("mla",))):
        with pytest.raises(NotImplementedError):
            check_supported(bad)
    from repro_torch.kernels.flash_attn import ops

    assert (192, 128) in ops.SUPPORTED_HEAD_DIMS and (48, 32) in ops.SUPPORTED_HEAD_DIMS
    assert (48, 48) not in ops.SUPPORTED_HEAD_DIMS
    with pytest.raises(ValueError, match="do not match"):
        flash_attention(torch.zeros(1, 4, 2, 48), torch.zeros(1, 4, 2, 32),
                        torch.zeros(1, 4, 2, 32))


def test_draft_noise_in_blocks_of_steps_is_bitwise_the_whole(monkeypatch):
    """``row_gumbel`` hashes noise past ``ROW_GUMBEL_CHUNK`` elements in
    blocks of steps (deepseek-v3's vocabulary of 129 280 would hold 12.8 GB
    of the hash's intermediates at once): a block of one step, of three (a
    ragged last block) and all at once give the same bits, and equal
    ``jax.random.gumbel`` of each row's key folded with the step within 1e-6
    (torch's float32 ``log`` and XLA's differ in the last bit)."""
    from repro_torch.drafting import ar_engine

    keys = prng.split(prng.key(9), 3)
    whole = ar_engine.row_gumbel(keys, 7, 50, "cpu")
    for budget in (1, 3 * 3 * 50, 7 * 3 * 50 - 1):
        monkeypatch.setattr(ar_engine, "ROW_GUMBEL_CHUNK", budget)
        assert torch.equal(ar_engine.row_gumbel(keys, 7, 50, "cpu"), whole), budget
    jkeys = jax.random.split(jax.random.key(9), 3)
    want = np.stack([np.stack([np.asarray(jax.random.gumbel(jax.random.fold_in(k, i), (50,)))
                               for i in range(7)]) for k in jkeys])
    np.testing.assert_allclose(whole.numpy(), want, rtol=1e-6, atol=1e-6)
