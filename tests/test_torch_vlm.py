"""The VLM family in the port against the JAX package on the CPU, at
qwen2-vl-72b's smoke config (2 ``attn`` layers, d 128, 4 heads over 2 KV
heads of 32, M-RoPE sections (8, 4, 4), 8 patches), on the port's seeded
weights converted to JAX's tree (rmsnorm scales moved off their initial
value, numpy seed 0), with 8 patches of ``0.1 N(0, 1)`` (numpy seed 1) laid
out as Qwen2-VL lays out one image of a 2 x 4 merged grid (``vlm_positions``:
patches at (0, row, col), the text from 4 on all three streams): the config
fields; ``mrope_angles`` at both section sets within 1e-6, and bitwise
``rope_angles`` where the streams are equal; the DFM forward with patches
and positions (the embedded inputs within 1e-5, logits 1e-4); ``dfm_apply``
dropping the patches' logits; the forward without positions on standard
RoPE; the causal forward masked by temporal ids (item 4); the cached
prefill and decode with and without ``batch_extras`` (1e-5), reference fault
R10 pinned; ``make_refine_step_fn`` and ``WarmStartServer`` through
``Conditioned``; ``ar_generate`` dropping the extras as JAX's (reference
fault R11 pinned); the weights both ways bitwise, ``patch_proj`` included;
the loss over the text logits and every gradient within 1e-4 of each
leaf's max |g|.
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
from repro.core.paths import WarmStartPath as JaxPath
from repro.kernels import draft_decode_supported as jax_draft_decode_supported
from repro.models import build_model as jax_build_model
from repro.models.rope import mrope_angles as jax_mrope_angles
from repro.models.rope import rope_angles as jax_rope_angles
from repro.serving.engine import WarmStartServer as JaxWarmStartServer
from repro.serving.engine import ar_generate as jax_ar_generate
from repro.serving.engine import make_refine_step_fn as jax_make_refine_step_fn
from repro.training import make_loss_fn as jax_make_loss_fn
from repro_torch import prng
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import jax_leaves, jax_params_to_torch, torch_params_to_jax
from repro_torch.core.guarantees import warm_nfe
from repro_torch.core.paths import WarmStartPath
from repro_torch.kernels.draft_decode import draft_decode_supported
from repro_torch.models import Conditioned, Model
from repro_torch.models.model import VISION_DIM, check_supported
from repro_torch.models.rope import mrope_angles, rope_angles, vlm_positions
from repro_torch.optim.adafactor import stack_leaf
from repro_torch.serving import WarmStartServer, ar_generate, make_refine_step_fn
from repro_torch.training.train_step import loss_and_grads, make_loss_fn
from test_torch_train_families import _nest

ARCH = "qwen2-vl-72b"
V, P, GRID = 512, 8, (2, 4)     # the smoke config's vocabulary, patches and their grid
B, S = 2, 12                    # rows and text tokens
T0 = 0.8
GRAD_TOL = 1e-4                 # x max |g| of the leaf


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
def _pair():
    """(JAX model, its params, the port's model on the same weights)."""
    cfg = get_smoke_config(ARCH)
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


def _inputs(rows=B, text=S, seed=1):
    """(tokens (rows, text), patches (rows, P, 1280), positions (3, rows, P +
    text)), numpy arrays."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, V, (rows, text)).astype(np.int32)
    patches = (0.1 * rng.standard_normal((rows, P, VISION_DIM))).astype(np.float32)
    return tok, patches, vlm_positions(rows, GRID, text).numpy()


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("which", ["full", "smoke"])
def test_config_fields_equal_jax(which):
    """The registry builds both configs; every field equals JAX's; the model
    takes both (the full one in float32: its bfloat16 default is refused);
    the draft kernels refuse both, as JAX's ``draft_decode_supported``."""
    want = jax_get_config(ARCH) if which == "full" else jax_get_smoke_config(ARCH)
    got = get_config(ARCH) if which == "full" else get_smoke_config(ARCH)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.head_dim == want.head_dim and got.family == "vlm"
    assert sum(got.mrope_sections) == got.head_dim // 2
    check_supported(got.replace(dtype="float32"))
    if which == "full":
        with pytest.raises(NotImplementedError, match="dtype"):
            check_supported(got)
        assert (got.num_layers, got.d_model, got.num_heads, got.num_kv_heads, got.d_ff,
                got.vocab_size, got.num_vision_tokens) == (80, 8192, 64, 8, 29568, 152064, 256)
    assert not draft_decode_supported(got) and not jax_draft_decode_supported(want)
    with pytest.raises(NotImplementedError, match="mrope_sections"):
        check_supported(got.replace(dtype="float32", mrope_sections=(8, 8, 8)))


@pytest.mark.parametrize("sections,head_dim,grid", [((16, 24, 24), 128, (16, 16)),
                                                     ((8, 4, 4), 32, GRID)])
def test_mrope_angles_match_jax(sections, head_dim, grid):
    """Qwen2-VL's ids (the image, then 5 text tokens): within 1e-6 of JAX's;
    with the three streams equal, bitwise ``rope_angles`` at that stream."""
    pos = vlm_positions(2, grid, 5)
    assert pos.shape == (3, 2, grid[0] * grid[1] + 5)
    assert int(pos[0, 0, -5]) == int(pos[1, 0, -5]) == max(grid)
    got = mrope_angles(pos, head_dim, 1e6, sections)
    want = jax_mrope_angles(jnp.asarray(pos.numpy()), head_dim, 1e6, sections)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    same = pos[2:3].expand(3, -1, -1)
    for g, w in zip(mrope_angles(same, head_dim, 1e6, sections),
                    rope_angles(pos[2], head_dim, 1e6)):
        assert torch.equal(g, w)
    for g, w in zip(rope_angles(pos[2], head_dim, 1e6),
                    jax_rope_angles(jnp.asarray(pos[2].numpy()), head_dim, 1e6)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


def test_forward_with_patches_and_positions_matches_jax():
    """The DFM forward over 8 patches + 12 tokens: the embedded inputs (the
    patches' projection first, the time embedding at every position) within
    1e-5, the logits (B, 20, V) within 1e-4."""
    jm, params, model = _pair()
    tok, patches, pos = _inputs()
    tt = np.array([0.6, 0.9], np.float32)
    (jt, jp, jpos, jtt), (t_, p_, pos_, tt_) = _both(tok, patches, pos, tt)
    batch = {"tokens": jt, "patches": jp, "positions": jpos}
    want_x = jm._embed_inputs(params, batch, jtt)
    want = jax.jit(lambda p, b, s: jm.forward(p, b, s)[0])(params, batch, jtt)
    with torch.no_grad():
        got_x = model._embed_inputs(t_, tt_, p_)
        got = model(t_, tt_, patches=p_, positions=pos_)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=1e-5, rtol=1e-5)
    assert got.shape == (B, P + S, V)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_dfm_apply_drops_the_patch_logits():
    """``dfm_apply(extras={"patches", "positions"})`` gives the text rows
    only, (B, S, V), within 1e-4 of JAX's and of the port's own forward's
    rows P.. (the head runs on the text rows alone)."""
    jm, params, model = _pair()
    tok, patches, pos = _inputs(seed=2)
    tt = np.array([0.7, 0.85], np.float32)
    (jt, jp, jpos, jtt), (t_, p_, pos_, tt_) = _both(tok, patches, pos, tt)
    want = jax.jit(lambda p, a, s, e: jm.dfm_apply(p, a, s, extras=e))(
        params, jt, jtt, {"patches": jp, "positions": jpos})
    with torch.no_grad():
        got = model.dfm_apply(t_, tt_, extras={"patches": p_, "positions": pos_})
        whole = model(t_, tt_, patches=p_, positions=pos_)
    assert got.shape == np.asarray(want).shape == (B, S, V)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), whole[:, P:].numpy(), atol=1e-5, rtol=1e-5)
    with pytest.raises(NotImplementedError, match="frames"):
        model.dfm_apply(t_, tt_, extras={"frames": p_})


def test_forward_without_positions_is_standard_rope():
    """Without ``positions`` an mrope config rotates by standard RoPE at the
    indices 0..P+S-1 (JAX's ``_rope_ctx`` fallback): bitwise the forward
    with ``arange`` on all three streams, within 1e-4 of JAX's, and not the
    forward under Qwen2-VL's ids."""
    jm, params, model = _pair()
    tok, patches, pos = _inputs(seed=3)
    tt = np.array([0.75, 0.95], np.float32)
    (jt, jp, jtt), (t_, p_, tt_) = _both(tok, patches, tt)
    want = jax.jit(lambda p, b, s: jm.forward(p, b, s)[0])(
        params, {"tokens": jt, "patches": jp}, jtt)
    arange = torch.arange(P + S, dtype=torch.int32)[None, None].expand(3, B, P + S)
    with torch.no_grad():
        got = model(t_, tt_, patches=p_)
        same = model(t_, tt_, patches=p_, positions=arange)
        qwen = model(t_, tt_, patches=p_, positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    assert torch.equal(got, same)
    assert float((got - qwen).abs().max()) > 1e-3


def test_causal_forward_masks_by_temporal_ids():
    """A causal forward under Qwen2-VL's ids masks as JAX's does, by the
    temporal stream (``k_pos = q_pos``): the 8 patches (all at id 0) see
    one another and every text token sees all patches; within 1e-5 of JAX's
    logits. An index-causal mask would differ: the first patch's logits
    move when the last patch changes."""
    jm, params, model = _pair()
    tok, patches, pos = _inputs(seed=4)
    (jt, jp, jpos), (t_, p_, pos_) = _both(tok, patches, pos)
    fwd = jax.jit(lambda p, b: jm.forward(p, b)[0])
    want = fwd(params, {"tokens": jt, "patches": jp, "positions": jpos})
    p2 = patches.copy()
    p2[:, -1] += 1.0
    want2 = fwd(params, {"tokens": jt, "patches": jnp.asarray(p2), "positions": jpos})
    with torch.no_grad():
        got = model(t_, patches=p_, positions=pos_)
        got2 = model(t_, patches=torch.from_numpy(p2), positions=pos_)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), atol=1e-5, rtol=1e-5)
    assert float((got2[:, 0] - got[:, 0]).abs().max()) > 1e-4


def _tree_close(jtree, ttree, tol=1e-5):
    jl = jax.tree_util.tree_leaves_with_path(jtree)
    tl = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(lambda t: t.numpy(), ttree))
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [jax.tree_util.keystr(p) for p, _ in tl]
    for (path, want), (_, got) in zip(jl, tl):
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype, jax.tree_util.keystr(path)
        np.testing.assert_allclose(got, want, rtol=tol,
                                   atol=tol * max(1.0, float(np.abs(want).max())))


def test_prefill_and_decode_match_jax_and_pin_r10():
    """A prefill of 8 patches + 8 tokens under Qwen2-VL's ids, then 4 decode
    steps, 2 with ``batch_extras={"positions": ...}`` (the ids going on at
    12, 13) and 2 without (standard RoPE at the cursor): logits and every
    cache leaf within 1e-5 of JAX's, cursors exact. R10: JAX's prefill
    masks the temporal ids (text from 4) against the buffer's indices (the
    text sits at 8..), so its last logits are not the uncached causal
    forward's; the port's equal JAX's."""
    jm, params, model = _pair()
    tok, patches, pos = _inputs(text=12, seed=5)
    n = 8
    (jt, jp, jpos), (t_, p_, pos_) = _both(tok[:, :n], patches, pos[:, :, :P + n])
    jbatch = {"tokens": jt, "patches": jp, "positions": jpos}
    jcache = jm.init_cache(B, P + 12, jnp.float32)
    cache = model.init_cache(B, P + 12, torch.float32)
    want, jcache = jax.jit(jm.prefill)(params, jbatch, jcache)
    full = jax.jit(lambda p, b: jm.forward(p, b)[0])(params, jbatch)
    assert float(jnp.abs(want[:, -1] - full[:, -1]).max()) > 1e-3       # R10
    decode = jax.jit(jm.decode_step)
    with torch.no_grad():
        got, cache = model.prefill({"tokens": t_, "patches": p_, "positions": pos_}, cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        for i in range(n, n + 4):
            step = tok[:, i:i + 1]
            at = P + i
            extras = ({"positions": pos[:, :, at:at + 1]} if i < n + 2 else None)
            want, jcache = decode(params, jnp.asarray(step), jcache, jnp.int32(at),
                                  batch_extras=(None if extras is None else
                                                {"positions": jnp.asarray(extras["positions"])}))
            got, cache = model.decode_step(
                torch.from_numpy(step), cache, at,
                batch_extras=(None if extras is None else
                              {"positions": torch.from_numpy(extras["positions"])}))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    _tree_close(jcache, cache)
    assert int(cache["blocks"]["p0"]["pos"][0]) == P + n + 4


class JaxConditioned:
    """The JAX side of ``Conditioned``: ``dfm_apply(params, tokens, t)`` with
    the patches and positions bound."""

    def __init__(self, jm, extras):
        self.jm, self.cfg, self.extras = jm, jm.cfg, extras

    def dfm_apply(self, params, tokens, t, extras=None):
        return self.jm.dfm_apply(params, tokens, t, extras=self.extras)


def test_refine_and_serve_through_conditioned_match_jax():
    """``make_refine_step_fn(extras=...)`` one step, and ``WarmStartServer``
    on ``Conditioned(model, {"patches", "positions"})``, 2 x 12, t0 = 0.8,
    cold_nfe = 16, a given draft: tokens equal JAX's, NFE == ``warm_nfe``,
    the report's counts equal."""
    jm, params, model = _pair()
    tok, patches, pos = _inputs(seed=6)
    (jp, jpos), (p_, pos_) = _both(patches, pos)
    jextras, extras = {"patches": jp, "positions": jpos}, {"patches": p_, "positions": pos_}
    t = np.full((B,), T0, np.float32)
    h = np.float32(1 / 16)
    jfn = jax.jit(jax_make_refine_step_fn(jm, jm.cfg, JaxPath(t0=T0), extras=jextras))
    want = np.asarray(jfn(params, jax.random.key(6), jnp.asarray(tok), jnp.asarray(t), h))
    fn = make_refine_step_fn(model, model.cfg, WarmStartPath(t0=T0), extras=extras)
    with torch.no_grad():
        got = fn(prng.key(6), torch.from_numpy(tok), torch.from_numpy(t), torch.tensor(h))
    np.testing.assert_array_equal(got.numpy(), want)

    jserver = JaxWarmStartServer(
        flow_model=JaxConditioned(jm, jextras), flow_cfg=jm.cfg, flow_params=params,
        path=JaxPath(t0=T0), draft_generate=lambda rng, n: jnp.asarray(tok), cold_nfe=16)
    cond = Conditioned(model, extras)
    server = WarmStartServer(flow_model=cond, flow_cfg=model.cfg, path=WarmStartPath(t0=T0),
                             draft_generate=lambda rng, n: torch.from_numpy(tok.copy()),
                             cold_nfe=16, device="cpu")
    x_j, rep_j = jserver.serve(jax.random.key(11), B)
    x_t, rep_t = server.serve(prng.key(11), B)
    assert x_t.shape == (B, S)
    np.testing.assert_array_equal(np.asarray(x_j), x_t.numpy())
    for k in ("nfe", "backbone_evals", "cold_nfe", "fused_block"):
        assert rep_t[k] == rep_j[k]
    assert rep_t["nfe"] == warm_nfe(16, T0) == 4


def test_ar_generate_drops_the_extras_as_jax_and_pins_r11():
    """R11: JAX's ``ar_generate`` passes extras only to an encoder-decoder,
    so a VLM's draft ignores its patches and positions (the same tokens as
    without them). The port does the same, and its tokens equal JAX's."""
    jm, params, model = _pair()
    _, patches, pos = _inputs(text=6, seed=7)
    (jp, jpos), (p_, pos_) = _both(patches, pos)
    kw = dict(batch_size=B, seq_len=6)
    want = np.asarray(jax_ar_generate(jm, jm.cfg, params, jax.random.key(4),
                                      extras={"patches": jp, "positions": jpos}, **kw))
    plain = np.asarray(jax_ar_generate(jm, jm.cfg, params, jax.random.key(4), **kw))
    np.testing.assert_array_equal(want, plain)                          # R11
    got = ar_generate(model, model.cfg, prng.key(4), extras={"patches": p_, "positions": pos_},
                      **kw)
    assert torch.equal(got, ar_generate(model, model.cfg, prng.key(4), **kw))
    assert got.shape == (B, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_weights_convert_both_ways_bitwise():
    """JAX's tree, ``patch_proj|w`` (1280, d) included -> state dict -> JAX's
    tree, bitwise, and the optimizers' leaf groups in JAX's leaf order; a
    JAX init has the same leaves and shapes."""
    _, params, model = _pair()
    want = _flatten(params)
    assert want["patch_proj|w"].shape == (VISION_DIM, 128)
    back = torch_params_to_jax(model.state_dict(), model.cfg)
    assert sorted(back) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert back[k].dtype == w.dtype and back[k].tobytes() == w.tobytes(), k
    assert list(jax_leaves(model)) == list(want)
    init = _flatten(jax_build_model(jax_get_smoke_config(ARCH)).init(jax.random.key(0)))
    assert {k: v.shape for k, v in init.items()} == {k: v.shape for k, v in want.items()}
    assert Model(get_smoke_config("starcoder2-3b"), device="cpu").patch_proj is None


def _batch():
    tok, patches, pos = _inputs(text=16, seed=8)
    r = np.random.default_rng(9)
    return {"x_src": tok, "x_tgt": r.integers(0, V, tok.shape).astype(np.int32),
            "patches": patches, "positions": pos}


def test_loss_and_every_gradient_match_jax():
    """The WS-DFM loss over the text logits only (loss, CE within 1e-6
    relative, t_mean exact) and every leaf's gradient, ``patch_proj``'s
    included, within GRAD_TOL of its max |g|, against ``jax.value_and_grad``
    on the same batch (16 tokens after 8 patches, Qwen2-VL's ids) and key."""
    jm, params, model = _pair()
    batch = _batch()
    fn = jax.jit(jax.value_and_grad(jax_make_loss_fn(jm, jm.cfg, JaxPath(T0)), has_aux=True))
    (want_loss, want_m), want = fn(params, {k: jnp.asarray(v) for k, v in batch.items()},
                                   jax.random.key(3))
    want = _flatten(want)
    loss, metrics, grads = loss_and_grads(
        make_loss_fn(model, model.cfg, WarmStartPath(T0)), model, jax_leaves(model),
        {k: torch.from_numpy(v) for k, v in batch.items()}, prng.key(3))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-6)
    np.testing.assert_allclose(float(metrics["ce"].detach()), float(want_m["ce"]), rtol=1e-6)
    assert float(metrics["t_mean"]) == float(want_m["t_mean"])
    assert list(grads) == list(want)
    for k, w in want.items():
        got = stack_leaf(k, [g.detach() for g in grads[k]]).numpy()
        assert got.shape == w.shape, k
        np.testing.assert_allclose(got, w, rtol=0, atol=GRAD_TOL * np.abs(w).max(), err_msg=k)
    assert np.abs(want["patch_proj|w"]).max() > 0
