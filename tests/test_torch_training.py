"""The port's training path against the JAX package's, on the CPU: the
path's ``sample_t``/``interpolate`` (exact), the losses, the schedule,
clipping, AdamW (AMSGrad on and off, bf16 moments) and Adafactor on the
stacked JAX leaves, the attention gradient, one train step's gradients
and a 10-step ``Trainer.fit``, the couplings (array-equal) and the
launcher. Both sides start from one JAX init (``Trainer.init_state``
takes the JAX parameter tree). Each tolerance is stated where it is used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _flatten
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import RunConfig as JaxRunConfig
from repro.core.coupling import (
    IndependentCoupling as JaxIndependent, KNNRefinementCoupling as JaxKNN,
    OracleRefinementCoupling as JaxOracle, pair_iterator as jax_pair_iterator,
)
from repro.core.losses import (
    dfm_cross_entropy as jax_dfm_ce, distill_map_loss as jax_distill_loss,
    ws_dfm_loss as jax_ws_dfm_loss,
)
from repro.core.paths import WarmStartPath as JaxPath
from repro.data import SyntheticCorpus as JaxCorpus, WordOracle as JaxWordOracle
from repro.models import build_model as jax_build_model
from repro.models.attention import _sdpa, attn_mask
from repro.optim import (
    Adafactor as JaxAdafactor, AdamW as JaxAdamW, clip_by_global_norm as jax_clip,
    warmup_cosine as jax_warmup_cosine,
)
from repro.core import CorruptionDraft as JaxCorruptionDraft
from repro.training import (
    Trainer as JaxTrainer, TrainState as JaxTrainState, make_loss_fn as jax_make_loss_fn,
)
from repro_torch import prng
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.convert import jax_leaves, jax_params_to_torch, torch_params_to_jax
from repro_torch.core.coupling import (
    IndependentCoupling, KNNRefinementCoupling, OracleRefinementCoupling, pair_iterator,
)
from repro_torch.core.losses import dfm_cross_entropy, distill_map_loss, ws_dfm_loss
from repro_torch.core.paths import WarmStartPath
from repro_torch.data import SyntheticCorpus, WordOracle
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.optim import Adafactor, AdamW, clip_by_global_norm, warmup_cosine
from repro_torch.optim.adafactor import stack_leaf
from repro_torch.optim.adamw import is_stacked
from repro_torch.training import Trainer, make_loss_fn, make_train_step
from repro_torch.training.train_step import loss_and_grads

ARCH = "dfm-dit"
B, N = 4, 16


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread for these smoke-size models: the suite runs in
    several worker processes at once, where torch's default of a thread a
    core makes each small op wait on the others' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_params(seed=0):
    return jax_build_model(jax_smoke_config(ARCH)).init(jax.random.key(seed))


def _model(params):
    model = build_model(get_smoke_config(ARCH), device="cpu")
    model.load_state_dict(jax_params_to_torch(_flatten(params)), strict=True)
    return model


def _batch(seed, v=27, b=B, n=N):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, v, (b, n)).astype(np.int32),
            rng.integers(0, v, (b, n)).astype(np.int32))


def _leaf_array(name, tensors):
    return stack_leaf(name, [t.detach() for t in tensors]).numpy()


# -- the path --------------------------------------------------------------------

@pytest.mark.parametrize("t0", [0.0, 0.5, 0.8])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_sample_t_and_interpolate_match_jax_exactly(t0, seed):
    """t equals the jitted JAX train step's (XLA fuses ``t0 + (1 - t0) * u``
    into one FMA there; op by op JAX rounds twice), and x_t equals JAX's
    token for token, op by op and jitted."""
    jpath, path = JaxPath(t0=t0), WarmStartPath(t0=t0)
    key = jax.random.key(seed)
    want_t = np.array(jax.jit(lambda k: jpath.sample_t(k, (64,)))(key))
    got_t = path.sample_t(prng.key(seed), (64,)).numpy()
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(path.kappa(torch.from_numpy(want_t)).numpy(),
                                  np.asarray(jpath.kappa(jnp.asarray(want_t))))
    xs, xt = _batch(seed, b=64, n=40)
    want_x = np.asarray(jpath.interpolate(key, jnp.asarray(xs), jnp.asarray(xt),
                                          jnp.asarray(want_t)))
    want_x_jit = np.asarray(jax.jit(jpath.interpolate)(key, jnp.asarray(xs), jnp.asarray(xt),
                                                        jnp.asarray(want_t)))
    got_x = path.interpolate(prng.key(seed), torch.from_numpy(xs), torch.from_numpy(xt),
                             torch.from_numpy(got_t)).numpy()
    np.testing.assert_array_equal(got_x, want_x)
    np.testing.assert_array_equal(got_x, want_x_jit)
    assert got_x.dtype == np.int32
    np.testing.assert_array_equal(path.kappa_dot(torch.tensor([0.9])).numpy(),
                                  np.asarray(jpath.kappa_dot(jnp.asarray([0.9]))))


# -- losses ------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_dfm_cross_entropy_matches_jax(weighted, z_loss):
    """Within 1e-6 relative: float32 logsumexp and mean in another order."""
    rng = np.random.default_rng(3)
    logits = (3 * rng.standard_normal((3, 11, 29))).astype(np.float32)
    tgt = rng.integers(0, 29, (3, 11)).astype(np.int32)
    w = (rng.random((3, 11)) < 0.6).astype(np.float32) if weighted else None
    want = jax_dfm_ce(jnp.asarray(logits), jnp.asarray(tgt),
                      weights=None if w is None else jnp.asarray(w), z_loss=z_loss)
    got = dfm_cross_entropy(torch.from_numpy(logits), torch.from_numpy(tgt),
                            weights=None if w is None else torch.from_numpy(w), z_loss=z_loss)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_ws_dfm_and_distill_losses_match_jax(weighted):
    """The same key draws the same t and x_t (exact); the losses and aux
    agree within 1e-5 relative (the backbone's float32 logits, 1e-4 abs)."""
    params = _jax_params()
    jm, model = jax_build_model(jax_smoke_config(ARCH)), _model(params)
    xs, xt = _batch(5)
    w = (np.random.default_rng(9).random((B, N)) < 0.7).astype(np.float32) if weighted else None
    jw, tw = (None, None) if w is None else (jnp.asarray(w), torch.from_numpy(w))
    path, jpath = WarmStartPath(0.8), JaxPath(0.8)
    want, want_aux = jax.jit(lambda k: jax_ws_dfm_loss(
        jm.dfm_apply, params, k, jnp.asarray(xs), jnp.asarray(xt), jpath, weights=jw,
        z_loss=1e-4))(jax.random.key(11))
    with torch.no_grad():
        got, aux = ws_dfm_loss(model.dfm_apply, prng.key(11), torch.from_numpy(xs),
                               torch.from_numpy(xt), path, weights=tw, z_loss=1e-4)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_array_equal(float(aux["t_mean"]), float(want_aux["t_mean"]))
    assert float(aux["frac_target"]) == float(want_aux["frac_target"])

    t0 = np.array([0.8, 0.5, 0.9, 0.7], np.float32)
    want, want_aux = jax_distill_loss(jm.dfm_apply, params, jnp.asarray(xs), jnp.asarray(xt),
                                      jnp.asarray(t0), weights=jw, z_loss=1e-4)
    with torch.no_grad():
        got, aux = distill_map_loss(model.dfm_apply, torch.from_numpy(xs), torch.from_numpy(xt),
                                    torch.from_numpy(t0), weights=tw, z_loss=1e-4)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(aux["agreement"]) == float(want_aux["agreement"])


# -- schedule and clipping -----------------------------------------------------------

@pytest.mark.parametrize("base_lr,warmup,total", [(3e-4, 100, 300), (1e-3, 20, 300)])
def test_warmup_cosine_matches_jax_at_every_step(base_lr, warmup, total):
    """Every step of a 300-step schedule (and past its end) within 1e-6
    relative, a few float32 ulps: the jitted expression (XLA's float32 cos,
    its FMA contractions and divisions by constants) rounds differently
    from the port's float32 host arithmetic."""
    jsched, sched = jax_warmup_cosine(base_lr, warmup, total), warmup_cosine(base_lr, warmup,
                                                                             total)
    steps = np.arange(0, total + 20, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(jsched))(jnp.asarray(steps)))
    got = np.array([sched(int(s)) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == 0.0 and got[warmup] == np.float32(base_lr)


@pytest.mark.parametrize("max_norm", [1e-3, 1.0, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    """Norm and clipped gradients within 1e-6 relative (float32 sums in
    another order); above the norm nothing is scaled."""
    rng = np.random.default_rng(4)
    shapes = [(3, 5), (7,), (2, 4, 6), ()]
    grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    want, want_norm = jax_clip([jnp.asarray(g) for g in grads], max_norm)
    got, norm = clip_by_global_norm([torch.from_numpy(g.copy()) for g in grads], max_norm)
    np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-9)


# -- optimizers on identical gradients ------------------------------------------------

def _run_optimizers(jax_opt, opt, steps=3, seed=0):
    """``steps`` updates of the smoke model's parameters by both optimizers
    on the same random gradients (each leaf at its own scale, 1e-4..1);
    returns (JAX params, JAX state, torch model, torch state)."""
    params = _jax_params()
    model = _model(params)
    leaves = jax_leaves(model)
    treedef = jax.tree_util.tree_structure(params)
    names = list(leaves)
    assert names == list(_flatten(params))   # the JAX leaf order
    jstate, state = jax_opt.init(params), opt.init(leaves)
    update = jax.jit(jax_opt.update)
    shapes = {k: v.shape for k, v in _flatten(params).items()}
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        g = {k: (rng.standard_normal(shapes[k]) * 10.0 ** rng.uniform(-4, 0)).astype(np.float32)
             for k in names}
        params, jstate = update(jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(g[k]) for k in names]), jstate, params)
        tg = {k: [torch.from_numpy(np.array(x)) for x in (g[k] if is_stacked(k) else [g[k]])]
              for k in names}
        _, state = opt.update(tg, state, leaves)
    return params, jstate, model, state


def _assert_params_close(params, model, rtol, atol=1e-9):
    want = _flatten(params)
    got = torch_params_to_jax(model.state_dict(), model.cfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("amsgrad", [True, False])
def test_adamw_matches_jax_on_identical_gradients(amsgrad):
    """Three steps, warm-up then cosine, weight decay 0.1: parameters within
    4e-7 relative (an ulp of p: ``p - lr * upd`` rounds at p's scale) and
    the moments within 1e-5 relative plus 1e-6 of the leaf's max |m| (XLA
    contracts ``b * m + (1 - b) * g`` into FMAs; the port rounds each term,
    as the JAX expression reads, and where the two terms cancel the
    difference is one at the terms' scale)."""
    kw = dict(weight_decay=0.1, amsgrad=amsgrad, moments_dtype="float32")
    params, jstate, model, state = _run_optimizers(
        JaxAdamW(learning_rate=jax_warmup_cosine(3e-4, 2, 10), **kw),
        AdamW(learning_rate=warmup_cosine(3e-4, 2, 10), **kw))
    _assert_params_close(params, model, rtol=4e-7)
    assert int(state.step) == int(jstate.step) == 3
    fields = ("mu", "nu", "nu_max") if amsgrad else ("mu", "nu")
    assert (state.nu_max is None) == (jstate.nu_max is None) == (not amsgrad)
    for f in fields:
        want = _flatten(getattr(jstate, f))
        got = getattr(state, f)
        assert list(got) == list(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-5,
                                       atol=1e-6 * np.abs(w).max(), err_msg=f"{f} {k}")


def test_adamw_bf16_moments_match_jax():
    """bf16 moments: the update runs in float32 and stores the moments
    rounded to bf16 as JAX does. An ulp of float32 difference can round a
    moment to the neighbouring bf16 value (2**-8 relative), so moments are
    held within 1e-2 relative plus 1e-5 of the leaf's max (where the next
    step's two terms cancel) and, for 99.9% of elements, equal; the
    parameters within 1e-6 relative plus 2**-7 of the largest step (lr =
    3e-4: such a moment moves its element's update by up to 2**-8 of it)."""
    kw = dict(weight_decay=0.1, amsgrad=True, moments_dtype="bfloat16")
    params, jstate, model, state = _run_optimizers(
        JaxAdamW(learning_rate=jax_warmup_cosine(3e-4, 2, 10), **kw),
        AdamW(learning_rate=warmup_cosine(3e-4, 2, 10), **kw))
    _assert_params_close(params, model, rtol=1e-6, atol=2.0 ** -7 * 3e-4)
    for f in ("mu", "nu", "nu_max"):
        want = _flatten(getattr(jstate, f))
        for k, w in want.items():
            got = getattr(state, f)[k]
            assert got.dtype == torch.bfloat16
            g, w = got.float().numpy(), np.asarray(w, np.float32)
            np.testing.assert_allclose(g, w, rtol=1e-2, atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"{f} {k}")
            assert (g == w).mean() >= 0.999, (f, k, (g == w).mean())


def test_adafactor_matches_jax_on_stacked_leaves():
    """Three steps with weight decay: parameters within 4e-7 relative, the
    row and column factors (stacked shapes: a per-layer bias is (L,) x (d,))
    within 1e-5 relative."""
    params, jstate, model, state = _run_optimizers(
        JaxAdafactor(learning_rate=jax_warmup_cosine(1e-3, 2, 10), weight_decay=0.1),
        Adafactor(learning_rate=warmup_cosine(1e-3, 2, 10), weight_decay=0.1))
    _assert_params_close(params, model, rtol=4e-7)
    for f in ("vr", "vc"):
        want = _flatten(getattr(jstate, f))
        for k, w in want.items():
            got = getattr(state, f)[k].numpy()
            assert got.shape == w.shape, (f, k)
            np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-30, err_msg=f"{f} {k}")
    assert state.vr["stack|blocks|p0|ln1|bias"].shape == (2,)
    assert state.vc["stack|blocks|p0|ln1|bias"].shape == (128,)


def test_per_parameter_adafactor_would_differ_from_jax():
    """Updating each layer's tensor on its own (factors a layer, RMS a
    layer) moves the parameters far outside the stacked update's 4e-7: the
    stacked-leaf grouping is what makes the port JAX's optimizer."""
    params = _jax_params()
    jax_opt = JaxAdafactor(learning_rate=1e-3)
    opt = Adafactor(learning_rate=1e-3)
    name = "stack|blocks|p0|ln1|bias"
    rng = np.random.default_rng(2)
    p = np.asarray(_flatten(params)[name]) + rng.standard_normal((2, 128)).astype(np.float32)
    g = rng.standard_normal((2, 128)).astype(np.float32) * np.array([[1.0], [30.0]], np.float32)
    want_p, _ = jax_opt.update({"x": jnp.asarray(g)}, jax_opt.init({"x": jnp.asarray(p)}),
                               {"x": jnp.asarray(p)})
    want_p = np.asarray(want_p["x"])
    beta = float(np.float32(1.0) - np.float32(1) ** np.float32(-0.8))
    stacked, _, _ = opt.update_leaf(torch.from_numpy(g), torch.zeros(2), torch.zeros(128),
                                    torch.from_numpy(p), beta, 1e-3)
    np.testing.assert_allclose(stacked.numpy(), want_p, rtol=4e-7)
    per_layer = np.stack([opt.update_leaf(torch.from_numpy(g[i]), torch.zeros(128),
                                          torch.zeros(1), torch.from_numpy(p[i]), beta,
                                          1e-3)[0].numpy() for i in range(2)])
    diff = np.abs(per_layer - want_p).max()
    assert diff > 1e3 * 4e-7 * np.abs(want_p).max(), diff


# -- the attention gradient ------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,kh,d,mode,window", [
    (2, 16, 4, 4, 16, "causal", None),
    (2, 16, 4, 4, 16, "bidir", None),
    (2, 24, 4, 4, 8, "bidir", 5),
    (2, 24, 4, 4, 8, "causal", 6),
    (2, 16, 8, 2, 16, "bidir", None),     # GQA, 4 query heads a KV head
    (1, 12, 6, 1, 8, "causal", None),     # MQA
])
def test_flash_attention_fn_grad_matches_jax_sdpa(b, s, h, kh, d, mode, window):
    """``FlashAttentionFn``'s gradients (its forward the plain version here,
    its backward the matmul formula) against ``jax.grad`` of JAX ``_sdpa``
    under ``attn_mask``: within 1e-5 of the gradient's max (float32)."""
    rng = np.random.default_rng(s * h + kh)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    w_out = rng.standard_normal((b, s, h, d)).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    mask = attn_mask(pos, pos, mode=mode, window=window)

    def jax_loss(q, k, v):
        out = _sdpa(q.reshape(b, s, kh, h // kh, d), k, v, mask, scale=scale)
        return jnp.sum(out.reshape(b, s, h, d) * w_out)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=mode == "causal", window=window, scale=scale)
    assert out.grad_fn is not None and "FlashAttentionFn" in type(out.grad_fn).__name__
    torch.sum(out * torch.from_numpy(w_out)).backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_every_parameter_gets_a_gradient_through_flash_attention():
    """A backward through the model reaches every parameter (wq, wk, wv of
    every block included: the attention is no cut in the graph), and no
    gradient is all zero."""
    model = build_model(get_smoke_config(ARCH), device="cpu")
    xs, xt = _batch(1)
    loss, _ = make_loss_fn(model, model.cfg, WarmStartPath(0.8))(
        model, {"x_src": torch.from_numpy(xs), "x_tgt": torch.from_numpy(xt)}, prng.key(0))
    loss.backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(p.grad.abs().sum() > 0), name
    assert {n for n, _ in model.named_parameters() if ".attn.wk." in n} == {
        f"blocks.{i}.attn.wk.w" for i in range(model.cfg.num_layers)}


# -- the train step and the trainer --------------------------------------------------------

def test_train_step_matches_jax():
    """One step from one init on one batch and key: loss and grad norm
    within 1e-5 relative; every gradient leaf within 1e-4 of its max
    (float32 through two blocks: attention's dS = P (dP - rowsum) cancels);
    the parameters after the AdamW step within 1e-6 relative, except where
    a gradient is so small that Adam's normalised step turns on its
    rounding: there within 2 x lr (the step's size)."""
    jcfg, jrun = jax_smoke_config(ARCH), JaxRunConfig()
    jm, params = jax_build_model(jcfg), _jax_params()
    xs, xt = _batch(2)
    jbatch = {"x_src": jnp.asarray(xs), "x_tgt": jnp.asarray(xt)}
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        jax_make_loss_fn(jm, jcfg, JaxPath(0.8)), has_aux=True))(params, jbatch,
                                                                 jax.random.key(3))
    want_norm = float(jax_clip(jgrads, 1.0)[1])

    model = _model(params)
    cfg = model.cfg
    batch = {"x_src": torch.from_numpy(xs), "x_tgt": torch.from_numpy(xt)}
    leaves = jax_leaves(model)
    loss, metrics, grads = loss_and_grads(make_loss_fn(model, cfg, WarmStartPath(0.8)), model,
                                          leaves, batch, prng.key(3))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert float(metrics["t_mean"]) == float(jmetrics["t_mean"])
    want = _flatten(jgrads)
    assert list(grads) == list(want)
    for k, w in want.items():
        np.testing.assert_allclose(_leaf_array(k, grads[k]), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)

    trainer = Trainer(model, cfg, RunConfig())
    state = trainer.init_state(_flatten(params))
    state, m = trainer._step_fn(state, batch, prng.key(3))
    np.testing.assert_allclose(float(m["grad_norm"]), want_norm, rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=1e-5)
    assert int(state.step) == 1 and int(state.opt_state.step) == 1


def _fit_both(steps, seed=0, **run_kw):
    """``steps`` steps of both trainers from one init on the same pairs
    (``pair_iterator`` with one numpy seed on each side)."""
    jcfg = jax_smoke_config(ARCH)
    params = _jax_params(seed)
    corpus = np.random.default_rng(seed).integers(0, 27, (64, N)).astype(np.int32)
    src = np.random.default_rng(seed + 1).integers(0, 27, (64, N)).astype(np.int32)
    kw = dict(t0=0.8, batch_size=B, total_steps=steps, warmup_steps=3, log_every=2,
              learning_rate=1e-3, seed=seed, **run_kw)
    jtrainer = JaxTrainer(jax_build_model(jcfg), jcfg, JaxRunConfig(**kw))
    jstate = jtrainer.fit(JaxTrainState.create(params, jtrainer.optimizer),
                          jax_pair_iterator(src, corpus, B, np.random.default_rng(seed)))
    model = _model(params)
    trainer = Trainer(model, model.cfg, RunConfig(**kw))
    state = trainer.fit(trainer.init_state(_flatten(params)),
                        pair_iterator(src, corpus, B, np.random.default_rng(seed)))
    return jtrainer, jstate, trainer, state


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_trainer_fit_matches_jax_for_10_steps(optimizer):
    """The history's steps, losses and grad norms within 1e-4 relative
    (float32 drifts a little each step). The final parameters: 99.99% of
    each leaf's elements within 1e-4 of its max |p|, and every element
    within 2 x the sum of the learning rates (AdamW moves an element at
    most about lr a step: where an element's gradient is at the level of
    float32 rounding, its normalised step m / sqrt(v) follows that rounding
    and may differ in sign; Adafactor's clipped steps likewise)."""
    jtrainer, jstate, trainer, state = _fit_both(10, optimizer=optimizer)
    assert [i for i, _ in trainer.history] == [i for i, _ in jtrainer.history] == [
        1, 2, 4, 6, 8, 10]
    for (_, m), (_, jm) in zip(trainer.history, jtrainer.history):
        assert set(m) == set(jm)
        for key in ("loss", "ce", "grad_norm", "t_mean"):
            np.testing.assert_allclose(m[key], jm[key], rtol=1e-4, err_msg=key)
    assert len(trainer.step_losses) == len(trainer.step_grad_norms) == 10
    assert trainer.step_ms() == []        # no card: no step events
    assert int(state.step) == int(jstate.step) == 10
    want = _flatten(jstate.params)
    got = torch_params_to_jax(state.params.state_dict(), state.params.cfg)
    sched = warmup_cosine(1e-3, 3, 10)
    bound = 2 * sum(sched(i) for i in range(1, 11))
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        assert diff.max() <= bound, (k, diff.max(), bound)
        assert (diff <= 1e-4 * np.abs(w).max()).mean() >= 0.9999, k


def test_make_train_step_refuses_what_the_port_does_not_run():
    """Nothing of the zoo is refused any more. Since the VLM family a batch's
    ``patches`` and ``positions`` train qwen2-vl-72b's smoke config (a
    finite loss over the text logits; against JAX's in ``test_torch_vlm``)
    and ``get_config("qwen2-vl-72b")`` builds;
    ``RunConfig(remat="block")`` builds (remat is ported), since the MoE
    family the router's auxiliary loss is ported: arctic-480b builds and its
    loss adds ``router_aux_weight · moe_aux`` (against JAX's in
    ``test_torch_moe``), and since the MLA family deepseek-v3's smoke config
    builds and its loss adds the MTP term too (against JAX's in
    ``test_torch_mla``)."""
    model = build_model(get_smoke_config(ARCH), device="cpu")
    cfg = model.cfg
    assert callable(make_train_step(model, cfg, RunConfig(remat="block"), AdamW()))
    loss_fn = make_loss_fn(model, cfg, WarmStartPath(0.8))
    xs, xt = _batch(0)
    vlm = build_model(get_smoke_config("qwen2-vl-72b"), device="cpu")
    p = vlm.cfg.num_vision_tokens
    pos = torch.arange(p + N, dtype=torch.int32)[None, None].expand(3, B, p + N)
    with torch.no_grad():
        loss, metrics = make_loss_fn(vlm, vlm.cfg, WarmStartPath(0.8))(
            vlm, {"x_src": torch.from_numpy(xs), "x_tgt": torch.from_numpy(xt),
                  "patches": torch.zeros(B, p, 1280), "positions": pos}, prng.key(0))
    assert bool(torch.isfinite(loss)) and float(loss) == float(metrics["ce"])
    moe = build_model(get_smoke_config("arctic-480b"), device="cpu")
    batch = {"x_src": torch.from_numpy(xs), "x_tgt": torch.from_numpy(xt)}
    with torch.no_grad():
        loss, metrics = make_loss_fn(moe, moe.cfg, WarmStartPath(0.8))(moe, batch, prng.key(0))
    assert float(metrics["moe_aux"]) > 0
    assert float(loss) == float(metrics["ce"] + moe.cfg.moe.router_aux_weight
                                * metrics["moe_aux"])
    assert get_config("arctic-480b").moe.num_experts == 128
    assert get_config("qwen2-vl-72b").family == "vlm"
    mla = build_model(get_smoke_config("deepseek-v3-671b"), device="cpu")
    with torch.no_grad():
        loss, metrics = make_loss_fn(mla, mla.cfg, WarmStartPath(0.8))(mla, batch, prng.key(0))
    assert float(metrics["moe_aux"]) > 0 and float(metrics["mtp"]) > 0
    assert float(loss) == float(metrics["ce"] + mla.cfg.moe.router_aux_weight
                                * metrics["moe_aux"] + 0.1 * metrics["mtp"])
    assert get_config(ARCH).num_layers == 12 and get_smoke_config(ARCH).num_layers == 2


def test_mtp_branch_matches_jax():
    """With ``mtp_depth`` the loss adds 0.1 x the shifted-target CE, as in JAX
    (within 1e-5 relative)."""
    params = _jax_params()
    jcfg = jax_smoke_config(ARCH).replace(mtp_depth=1)
    xs, xt = _batch(6)
    want, wm = jax_make_loss_fn(jax_build_model(jcfg), jcfg, JaxPath(0.5))(
        params, {"x_src": jnp.asarray(xs), "x_tgt": jnp.asarray(xt)}, jax.random.key(2))
    model = _model(params)
    with torch.no_grad():
        got, m = make_loss_fn(model, model.cfg.replace(mtp_depth=1), WarmStartPath(0.5))(
            model, {"x_src": torch.from_numpy(xs), "x_tgt": torch.from_numpy(xt)},
            prng.key(2))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(m["mtp"]), float(wm["mtp"]), rtol=1e-5)


# -- couplings ------------------------------------------------------------------------------

def test_couplings_and_pair_iterator_match_jax_array_for_array():
    data = JaxCorpus(seed=0).sequences(300, 24, seed=1) % 27
    np.testing.assert_array_equal(SyntheticCorpus(seed=0).sequences(300, 24, seed=1) % 27, data)
    drafts = np.random.default_rng(5).integers(0, 27, (90, 24)).astype(np.int32)
    for jax_c, c, dr in (
            (JaxIndependent(27, 24), IndependentCoupling(27, 24), None),
            (JaxKNN(k=3, k_inject=2, max_candidates=200, chunk=32),
             KNNRefinementCoupling(k=3, k_inject=2, max_candidates=200, chunk=32), drafts),
            (JaxOracle(JaxWordOracle(JaxCorpus(seed=0)), inject_prob=0.3),
             OracleRefinementCoupling(WordOracle(SyntheticCorpus(seed=0)), inject_prob=0.3),
             None)):
        if isinstance(c, OracleRefinementCoupling):
            # word-length fragments: the oracle's R5 limit (ROADMAP) is not hit
            dr = np.tile(np.array([1, 2, 3, 0], np.int32), (40, 6))
        want = jax_c.build(data, dr, np.random.default_rng(8))
        got = c.build(data, dr, np.random.default_rng(8))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    src, tgt = want
    it_j = jax_pair_iterator(src, tgt, 7, np.random.default_rng(3))
    it = pair_iterator(src, tgt, 7, np.random.default_rng(3))
    for _ in range(2 * len(src) // 7 + 3):     # across epoch boundaries
        for g, w in zip(next(it), next(it_j)):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        next(pair_iterator(src, tgt[:-1], 7, np.random.default_rng(3)))


# -- the launcher ---------------------------------------------------------------------------

def test_launch_train_main_runs_on_cpu(tmp_path):
    """``main([...])`` trains the smoke config a few steps on the CPU and
    saves a checkpoint; the pairs equal the JAX launcher's construction."""
    argv = ["--smoke", "--device", "cpu", "--steps", "3", "--batch-size", "4",
            "--seq-len", "16", "--checkpoint-dir", str(tmp_path)]
    trainer, state, path = launch_train.main(argv)
    assert path.endswith("step_00000003") and int(state.step) == 3
    assert all(np.isfinite(float(x)) for x in trainer.step_losses)
    assert [i for i, _ in trainer.history] == [1]
    args = launch_train.parse_args(argv)
    src, tgt, _ = launch_train.training_pairs(state.params.cfg, args)
    data = (JaxCorpus(seed=0).sequences(4096, 16, seed=1) % 27).astype(np.int32)
    drafts = np.asarray(JaxCorruptionDraft(data=data, vocab_size=27, corruption=0.3).generate(
        jax.random.key(0), data.shape[0]))
    want = JaxKNN(k=1, k_inject=1, max_candidates=2048).build(data, drafts,
                                                              np.random.default_rng(0))
    np.testing.assert_array_equal(src, want[0])
    np.testing.assert_array_equal(tgt, want[1])
    with pytest.raises(RuntimeError, match="device='cpu'"):   # the card is the default
        launch_train.main(["--smoke", "--steps", "1", "--checkpoint-dir", str(tmp_path)])
