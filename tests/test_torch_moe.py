"""The MoE family in the port against the JAX package on the CPU, at
arctic-480b's smoke config (2 ``moe_res`` layers, d 128, 4 experts, top-2,
a dense residual FFN), on the port's seeded weights converted to JAX's tree
(norm scales moved off their initial zeros, numpy seed 0): the config
fields; ``capacity`` and the routing (top-k choices, the kept mask, drops
forced at ``capacity_factor=0.5``) exact; ``moe_ffn`` and
``moe_ffn_dropless`` within 1e-5 and the auxiliary loss within 1e-6
relative under both ``capacity_sharding`` values; the dropless chunks
bitwise; ``dfm_apply`` within 1e-4; the causal forward, prefill (a prefill
of more than 1024 tokens on the capacity path) and decode within 1e-5; the
draft engine and a ``WarmStartServer`` serve against JAX's; the weights
both ways bitwise; the loss (with the router's auxiliary term) and every
gradient within 1e-4 of each leaf's max |g|; three AdamW and three
Adafactor steps on the 4-D stacked expert leaves; the ``shardmap`` dispatch
refused by name.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _flatten
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.configs.base import RunConfig as JaxRunConfig
from repro.core.paths import WarmStartPath as JaxPath
from repro.drafting import ARDraftEngine as JaxEngine
from repro.drafting import TransformerDraftAdapter as JaxAdapter
from repro.kernels import draft_decode_supported as jax_draft_decode_supported
from repro.models import build_model as jax_build_model
from repro.models.moe import _capacity as jax_capacity
from repro.models.moe import moe_ffn as jax_moe_ffn
from repro.models.moe import moe_ffn_dropless as jax_moe_ffn_dropless
from repro.optim import build_optimizer as jax_build_optimizer
from repro.serving.engine import WarmStartServer as JaxWarmStartServer
from repro.training import TrainState as JaxTrainState
from repro.training import make_loss_fn as jax_make_loss_fn
from repro.training import make_train_step as jax_make_train_step
from repro_torch import prng
from repro_torch.checkpoint.io import flatten
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.convert import jax_leaves, jax_params_to_torch, torch_params_to_jax
from repro_torch.core.paths import WarmStartPath
from repro_torch.drafting import ARDraftEngine, TransformerDraftAdapter, row_gumbel
from repro_torch.kernels.draft_decode import draft_decode_supported
from repro_torch.models import Model
from repro_torch.models import moe as moe_module
from repro_torch.models.model import check_supported
from repro_torch.optim import build_optimizer
from repro_torch.optim.adafactor import stack_leaf
from repro_torch.serving import WarmStartServer
from repro_torch.training import TrainState, make_loss_fn, make_train_step
from repro_torch.training.train_step import loss_and_grads
from test_torch_train_families import _nest

ARCH = "arctic-480b"
V = 512                       # the smoke config's vocabulary
T0 = 0.8
TIE_TOL = 1e-5
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


def _cfg(**moe):
    cfg = get_smoke_config(ARCH)
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **moe)) if moe else cfg


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX model, its params, the port's model on the same weights): the
    port's seeded init (seed 0) in JAX's tree, rmsnorm scales moved off 0."""
    cfg = _cfg()
    flat = torch_params_to_jax(Model(cfg, device="cpu", seed=0).state_dict(), cfg)
    rng = np.random.default_rng(0)
    for k in sorted(flat):
        if k.endswith("|scale"):
            flat[k] = flat[k] + 0.1 * rng.standard_normal(flat[k].shape).astype(np.float32)
    params = _nest(flat)
    params["stack"].setdefault("pre", {})
    params["stack"].setdefault("rem", {})
    model = Model(cfg, device="cpu", seed=1)
    model.load_state_dict(jax_params_to_torch(flat), strict=True)
    return jax_build_model(jax_get_smoke_config(ARCH)), params, model


def _layer0(params):
    """Layer 0's MoE leaves of JAX's stacked tree."""
    return jax.tree.map(lambda a: a[0], params["stack"]["blocks"]["p0"]["moe"])


def _hidden(seed, b=2, s=40):
    return np.random.default_rng(seed).standard_normal((b, s, 128)).astype(np.float32)


@pytest.mark.parametrize("which", ["full", "smoke"])
def test_config_fields_equal_jax(which):
    """The registry builds both configs; every field equals JAX's, and
    both are taken by the model (the full one in float32: its bfloat16
    default is refused) and refused by the draft kernels, as JAX's are."""
    want = jax_get_config(ARCH) if which == "full" else jax_get_smoke_config(ARCH)
    got = get_config(ARCH) if which == "full" else get_smoke_config(ARCH)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.scan_split() == want.scan_split() and got.head_dim == want.head_dim
    check_supported(got.replace(dtype="float32"))
    if which == "full":
        with pytest.raises(NotImplementedError, match="dtype"):
            check_supported(got)
    assert not draft_decode_supported(got) and not jax_draft_decode_supported(want)


def test_capacity_is_exact():
    """``capacity`` against JAX's ``_capacity`` over token counts and
    capacity factors, incl. the minimum of 8 and the round up to 8s."""
    for cf in (0.5, 1.0, 1.25, 2.0):
        cfg = _cfg(capacity_factor=cf)
        for tokens in (1, 3, 8, 13, 40, 64, 100, 257, 1024, 1025, 2048, 4099):
            assert moe_module.capacity(tokens, cfg) == jax_capacity(tokens, cfg), (cf, tokens)
    full = get_config(ARCH)
    assert moe_module.capacity(2048, full) == jax_capacity(2048, full) == 40
    assert moe_module.capacity(64, full) == 8


def _jax_routing(p, x, cfg):
    """JAX ``moe_ffn``'s routing lines (``src/repro/models/moe.py:107-130``)
    run in jnp: (experts (T, k), weights (T, k), kept (T, k) in slot order,
    capacity)."""
    m = cfg.moe
    t, k = x.shape[0] * x.shape[1], m.num_experts_per_tok
    xt = jnp.asarray(x).reshape(t, -1)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ p["router"], axis=-1)
    gate_w, gate_i = jax.lax.top_k(probs, k)
    gate_w = gate_w / jnp.maximum(gate_w.sum(-1, keepdims=True), 1e-9)
    cap = jax_capacity(t, cfg)
    flat_e = gate_i.reshape(-1)
    order = jnp.argsort(flat_e)
    se = flat_e[order]
    counts = jnp.bincount(se, length=m.num_experts)
    starts = jnp.cumsum(counts) - counts
    pos = jnp.arange(t * k, dtype=jnp.int32) - starts[se]
    keep = jnp.zeros(t * k, bool).at[order].set(pos < cap)
    return np.asarray(gate_i), np.asarray(gate_w), np.asarray(keep).reshape(t, k), cap


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_routing_and_kept_mask_exact(cf):
    """The top-2 choices and the kept mask equal JAX's exactly; at
    ``capacity_factor=0.5`` (capacity 24 for 160 slots over 4 experts)
    slots are dropped; the weights within 1e-6."""
    cfg = _cfg(capacity_factor=cf)
    _, params, model = _pair()
    x = _hidden(1)
    want_i, want_w, want_keep, cap = _jax_routing(_layer0(params), x, cfg)
    with torch.no_grad():
        _, gate_w, gate_i = moe_module.route(torch.from_numpy(x).reshape(80, 128),
                                             model.blocks[0].moe.router, 2)
        row, keep = moe_module.dispatch_slots(gate_i, 4, moe_module.capacity(80, cfg))
    np.testing.assert_array_equal(gate_i.numpy(), want_i)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_allclose(gate_w.numpy(), want_w, rtol=1e-6, atol=1e-7)
    assert (row[keep] < 4 * cap).all() and (row[~keep] == 4 * cap).all()
    assert len(set(row[keep].tolist())) == int(keep.sum())       # one slot a buffer row
    assert bool(keep.all()) == (cf == 1.25)


@pytest.mark.parametrize("sharding", ["none", "data"])
def test_moe_ffn_and_dropless_match_jax(sharding):
    """Layer 0's FFN: ``moe_ffn`` within 1e-5 (with drops too) and its
    auxiliary loss within 1e-6 relative; ``moe_ffn_dropless`` within 1e-5,
    aux 0. ``capacity_sharding`` changes nothing on one device."""
    _, params, model = _pair()
    moe = model.blocks[0].moe
    x = _hidden(2)
    for cf in (1.25, 0.5):
        cfg = _cfg(capacity_sharding=sharding, capacity_factor=cf)
        want, want_aux = jax_moe_ffn(_layer0(params), jnp.asarray(x), cfg)
        moe.cfg = cfg
        try:
            with torch.no_grad():
                got, aux = moe.capacity_ffn(torch.from_numpy(x))
        finally:
            moe.cfg = model.cfg
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    cfg = _cfg(capacity_sharding=sharding)
    want, want_aux = jax_moe_ffn_dropless(_layer0(params), jnp.asarray(x), cfg)
    with torch.no_grad():
        got, aux = moe.dropless(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert float(aux) == float(want_aux) == 0.0


def test_dropless_chunks_are_bitwise_the_whole(monkeypatch):
    """A chunk of one token, of three (a ragged last chunk) and all 80 at
    once (``DROPLESS_GATHER_BYTES`` cut down): the same bits."""
    _, _, model = _pair()
    moe = model.blocks[1].moe
    x = torch.from_numpy(_hidden(3))
    slot = 2 * 128 * 64 * 4                       # one token's two experts, a matrix
    with torch.no_grad():
        whole = moe.dropless(x)[0]
        for budget in (1, 3 * slot, 79 * slot):
            monkeypatch.setattr(moe_module, "DROPLESS_GATHER_BYTES", budget)
            assert torch.equal(moe.dropless(x)[0], whole), budget


def test_dfm_apply_matches_jax():
    jm, params, model = _pair()
    rng = np.random.default_rng(7)
    tok = rng.integers(0, V, (2, 40)).astype(np.int32)
    tt = rng.uniform(0.5, 1.0, 2).astype(np.float32)
    want = np.asarray(jax.jit(jm.dfm_apply)(params, jnp.asarray(tok), jnp.asarray(tt)))
    with torch.no_grad():
        got = model.dfm_apply(torch.from_numpy(tok), torch.from_numpy(tt)).numpy()
    assert got.shape == (2, 40, V)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_forward_returns_the_summed_aux_as_jax():
    """``forward(..., return_aux=True)``: the logits as without it and the
    two layers' auxiliary losses summed, within 1e-6 relative of JAX's."""
    jm, params, model = _pair()
    tok = np.random.default_rng(8).integers(0, V, (2, 24)).astype(np.int32)
    tt = np.array([0.6, 0.9], np.float32)
    want, want_aux = jax.jit(lambda p, t, s: jm.forward(p, {"tokens": t}, s))(
        params, jnp.asarray(tok), jnp.asarray(tt))
    with torch.no_grad():
        got, aux = model(torch.from_numpy(tok), torch.from_numpy(tt), return_aux=True)
        assert torch.equal(got, model(torch.from_numpy(tok), torch.from_numpy(tt)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


def test_causal_forward_prefill_and_decode_step_match_jax():
    """The causal forward over 24 tokens; a 12-token prefill (dropless: 24
    tokens with a cache) then 4 decode steps: logits and every cache leaf
    within 1e-5, cursors exact."""
    jm, params, model = _pair()
    tok = np.random.default_rng(6).integers(0, V, (2, 24)).astype(np.int32)
    want = jax.jit(lambda p, t: jm.forward(p, {"tokens": t})[0])(params, jnp.asarray(tok))
    with torch.no_grad():
        got = model(torch.from_numpy(tok)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)

    jcache = jm.init_cache(2, 24, jnp.float32)
    cache = model.init_cache(2, 24, torch.float32)
    want, jcache = jax.jit(lambda p, t, c: jm.prefill(p, {"tokens": t}, c))(
        params, jnp.asarray(tok[:, :12]), jcache)
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
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * max(1.0, float(np.abs(want).max())))
        if jax.tree_util.keystr(path).endswith("['pos']"):
            assert (got == 16).all()


def test_a_prefill_over_1024_tokens_takes_the_capacity_path(monkeypatch):
    """3 x 400 tokens with a cache is past ``DROPLESS_MAX_TOKENS``: both
    layers take the capacity path (as JAX's ``_moe_dispatch``), the next
    decode step (3 tokens) the dropless one; logits within 1e-5 of JAX's."""
    jm, params, model = _pair()
    tok = np.random.default_rng(9).integers(0, V, (3, 401)).astype(np.int32)
    calls = []
    for name in ("capacity_ffn", "dropless"):
        real = getattr(moe_module.MoE, name)
        monkeypatch.setattr(moe_module.MoE, name,
                            lambda self, x, *a, _n=name, _r=real, **kw:
                            calls.append((_n, x.shape[0] * x.shape[1])) or _r(self, x, *a, **kw))
    jcache = jm.init_cache(3, 401, jnp.float32)
    want, jcache = jax.jit(lambda p, t, c: jm.prefill(p, {"tokens": t}, c))(
        params, jnp.asarray(tok[:, :400]), jcache)
    want_step, _ = jax.jit(jm.decode_step)(params, jnp.asarray(tok[:, 400:]), jcache,
                                           jnp.int32(400))
    cache = model.init_cache(3, 401, torch.float32)
    with torch.no_grad():
        got, cache = model.prefill({"tokens": torch.from_numpy(tok[:, :400])}, cache)
        got_step, _ = model.decode_step(torch.from_numpy(tok[:, 400:]), cache, 400)
    assert calls == [("capacity_ffn", 1200)] * 2 + [("dropless", 3)] * 2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_step.numpy(), np.asarray(want_step), atol=1e-5, rtol=1e-5)


def test_weights_convert_both_ways_bitwise():
    """JAX's tree (``moe|router``, ``moe|up|gate|down`` stacked (L, E, d,
    ff), ``moe|residual|…``) -> state dict -> JAX's tree, bitwise, and the
    optimizers' leaf groups in JAX's leaf order."""
    _, params, model = _pair()
    want = _flatten(params)
    back = torch_params_to_jax(model.state_dict(), model.cfg)
    assert sorted(back) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert back[k].dtype == w.dtype and back[k].tobytes() == w.tobytes(), k
    assert want["stack|blocks|p0|moe|up"].shape == (2, 4, 128, 64)
    assert want["stack|blocks|p0|moe|down"].shape == (2, 4, 64, 128)
    leaves = jax_leaves(model)
    assert list(leaves) == list(_flatten(params))
    assert [tuple(p.shape) for p in leaves["stack|blocks|p0|moe|gate"]] == [(4, 128, 64)] * 2


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


def test_engine_takes_the_plain_path_and_matches_jax():
    """The draft kernels refuse MoE, so ``auto`` takes the plain decode
    path with a scanned prefill, as JAX's; 3 rows of 8 tokens after a
    4-token prompt equal JAX's engine off near-ties."""
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


def test_serve_matches_jax():
    """The smoke model as the flow backbone (the capacity path in every
    NFE), 4 x 32, t0 = 0.8, cold_nfe = 16, a given draft: tokens, NFE and
    the report's counts equal JAX's server."""
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


def _batch():
    r = np.random.default_rng(1)
    return {k: r.integers(0, V, (2, 24)).astype(np.int32) for k in ("x_src", "x_tgt")}


@functools.lru_cache(maxsize=None)
def _jax_grads():
    jm, params, _ = _pair()
    fn = jax.jit(jax.value_and_grad(jax_make_loss_fn(jm, jm.cfg, JaxPath(T0)), has_aux=True))
    (loss, metrics), grads = fn(params, {k: jnp.asarray(v) for k, v in _batch().items()},
                                jax.random.key(3))
    return float(loss), {k: float(v) for k, v in metrics.items()}, _flatten(grads)


@functools.lru_cache(maxsize=None)
def _port_grads(remat):
    _, _, model = _pair()
    loss, metrics, grads = loss_and_grads(
        make_loss_fn(model, model.cfg, WarmStartPath(T0), remat=remat), model,
        jax_leaves(model), {k: torch.from_numpy(v) for k, v in _batch().items()},
        prng.key(3))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_match_jax(remat):
    """The WS-DFM loss with ``router_aux_weight · aux`` added (loss within
    1e-6 relative, ``moe_aux`` within 1e-6, t_mean exact) and every leaf's
    gradient within GRAD_TOL of its max |g|; remat (a checkpoint a layer,
    the aux carried through) gives the same bits as no remat."""
    _, _, model = _pair()
    want_loss, want_m, want = _jax_grads()
    loss, metrics, grads = _port_grads(remat)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-6)
    assert set(metrics) == set(want_m) == {"ce", "t_mean", "moe_aux", "loss"}
    np.testing.assert_allclose(float(metrics["moe_aux"]), want_m["moe_aux"], rtol=1e-6)
    assert float(metrics["t_mean"]) == want_m["t_mean"]
    assert float(loss) == float(metrics["ce"] + model.cfg.moe.router_aux_weight
                                * metrics["moe_aux"])
    assert list(grads) == list(want)
    for k, w in want.items():
        got = stack_leaf(k, [g.detach() for g in grads[k]]).numpy()
        assert got.shape == w.shape, k
        np.testing.assert_allclose(got, w, rtol=0, atol=GRAD_TOL * np.abs(w).max(), err_msg=k)
    assert np.abs(want["stack|blocks|p0|moe|router"]).max() > 0
    if remat:
        loss0, _, grads0 = _port_grads(False)
        assert torch.equal(loss, loss0)
        for k in grads:
            for g, g0 in zip(grads[k], grads0[k]):
                assert torch.equal(g, g0), k


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_three_train_steps_match_jax(optimizer):
    """Three ``make_train_step`` steps (AdamW with AMSGrad, or Adafactor,
    factored over the last two axes of the 4-D ``(L, E, d, ff)`` expert
    leaves) against JAX's from the same weights, batch and keys: loss, CE,
    ``moe_aux`` and grad norm within 1e-5 relative; the optimizer state's
    leaf shapes equal; the parameters within 2 x the summed learning rates
    and 99.9% of each leaf within 1e-4 of its max |p|."""
    jm, params, _ = _pair()
    model = Model(_cfg(), device="cpu")
    model.load_state_dict(jax_params_to_torch(_flatten(params)), strict=True)
    run = RunConfig(arch=ARCH, t0=T0, learning_rate=1e-3, warmup_steps=1, total_steps=3,
                    optimizer=optimizer)
    opt = build_optimizer(run)
    step = make_train_step(model, model.cfg, run, opt)
    state = TrainState.create(model, opt)
    jrun = JaxRunConfig(**{f: getattr(run, f) for f in (
        "arch", "t0", "learning_rate", "warmup_steps", "total_steps", "optimizer")})
    jopt = jax_build_optimizer(jrun)
    jstep = jax.jit(jax_make_train_step(jm, jm.cfg, jrun, jopt))
    jstate = JaxTrainState.create(params, jopt)
    batch = _batch()
    for i in range(3):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, prng.key(i))
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                            jax.random.key(i))
        assert set(m) == set(jm_)
        for k in ("loss", "ce", "moe_aux", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm_[k]), rtol=1e-5, err_msg=k)
    got, want = flatten(state), _flatten(jstate)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
    if optimizer == "adafactor":
        assert got["opt_state|vr|stack|blocks|p0|moe|up"].shape == (2, 4, 128)
        assert got["opt_state|vc|stack|blocks|p0|moe|up"].shape == (2, 4, 64)
    bound = 2 * sum(opt.learning_rate(i) for i in (1, 2, 3))
    for k, w in want.items():
        if k.startswith("params|"):
            diff = np.abs(got[k] - w)
            assert diff.max() <= bound, (k, diff.max(), bound)
            assert (diff <= 1e-4 * np.abs(w).max()).mean() >= 0.999, k


def test_what_stays_refused():
    """The ``shardmap`` dispatch by name (its queue item) in the model and
    in the FFN; an MoE family or kind with no experts; post-norms on MoE
    layers (JAX's MoE blocks hold no such weights)."""
    cfg = _cfg(dispatch_impl="shardmap")
    with pytest.raises(NotImplementedError, match="shardmap.*item 7"):
        check_supported(cfg)
    _, _, model = _pair()
    moe = model.blocks[0].moe
    moe.cfg = cfg
    try:
        with pytest.raises(NotImplementedError, match="shardmap"):
            moe.capacity_ffn(torch.zeros((1, 4, 128)))
    finally:
        moe.cfg = model.cfg
    for bad in (_cfg(num_experts=0), _cfg().replace(post_norms=True),
                get_smoke_config("starcoder2-3b").replace(pattern=("moe",)),
                get_smoke_config("starcoder2-3b").replace(family="moe")):
        with pytest.raises(NotImplementedError):
            check_supported(bad)
