"""Serving the encoder-decoder family (whisper-medium's smoke config) in the
port against the JAX package, on converted weights with the same frames
and keys: ``ar_generate`` with ``extras={"frames": ...}`` (tokens equal off
near-ties; reference fault R8 pinned: ``seq_len - 1`` tokens on both
sides), ``make_refine_step_fn(extras=...)`` on one step, and
``WarmStartServer`` through the conditioning object (``Conditioned``) with
a given draft and with the ``ar_generate`` draft asked for ``N + 1``:
tokens, NFE and the report's counts equal to JAX's server on the same
object; ``make_loss_fn`` trains the family with its frames."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _flatten
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.core.paths import WarmStartPath as JaxPath
from repro.models import build_model as jax_build_model
from repro.serving.engine import WarmStartServer as JaxWarmStartServer
from repro.serving.engine import ar_generate as jax_ar_generate
from repro.serving.engine import make_refine_step_fn as jax_make_refine_step_fn
from repro_torch import prng
from repro_torch.configs import get_smoke_config
from repro_torch.core.guarantees import warm_nfe
from repro_torch.core.paths import WarmStartPath
from repro_torch.convert import jax_params_to_torch
from repro_torch.models import Conditioned, EncDecModel
from repro_torch.serving import WarmStartServer, ar_generate, make_refine_step_fn
from repro_torch.training.train_step import make_loss_fn

ARCH = "whisper-medium"
V, F, D = 512, 32, 128          # the smoke config's vocabulary, frames and width
TIE_TOL = 1e-5                  # a draw's two best (noise + logits) within this: a near tie
SEQ, ROWS = 8, 2                # R8's reproduction: ar_generate(batch_size=2, seq_len=8)


@functools.lru_cache(maxsize=None)
def _pair(seed=0):
    """(JAX model, its params, the port's model on the same weights, frames)."""
    jm = jax_build_model(jax_get_smoke_config(ARCH))
    rng = np.random.default_rng(seed)

    def leaf(path, x):   # biases and norm parameters start at 0 / 1
        if jax.tree_util.keystr(path).endswith(("['b']", "['bias']", "['scale']")):
            return x + 0.1 * jnp.asarray(rng.standard_normal(x.shape), jnp.float32)
        return x

    params = jax.tree_util.tree_map_with_path(leaf, jm.init(jax.random.key(seed)))
    model = EncDecModel(get_smoke_config(ARCH), device="cpu")
    model.load_state_dict(jax_params_to_torch(_flatten(params)), strict=True)
    frames = np.random.default_rng(1).standard_normal((4, F, D)).astype(np.float32)
    return jm, params, model, frames


class JaxConditioned:
    """The JAX side of ``Conditioned``: ``dfm_apply(params, tokens, t)``
    with the frames bound."""

    def __init__(self, jm, frames):
        self.jm, self.cfg, self.frames = jm, jm.cfg, jnp.asarray(frames)

    def dfm_apply(self, params, tokens, t, extras=None):
        return self.jm.dfm_apply(params, tokens, t, extras={"frames": self.frames})


def _first_mismatches_are_near_ties(model, frames, key, want, got):
    """Rows where ``got`` differs from ``want``: at the first differing step
    the port's two best ``gumbel + logits`` scores lie within TIE_TOL (the
    draws of ``ar_generate``: the key split once a step from position 1)."""
    want, got = np.asarray(want), np.asarray(got)
    rows = np.nonzero((want != got).any(axis=1))[0]
    if not len(rows):
        return
    b = want.shape[0]
    cache = model.init_cache(b, SEQ + 1, torch.float32)
    bos = torch.zeros((b, 1), dtype=torch.int32)
    with torch.no_grad():
        _, cache = model.prefill({"tokens": bos, "frames": frames}, cache)
        tok, rng, steps = bos, key, []
        for i in range(1, SEQ):
            rng, sub = prng.split(rng, 2)
            logits, cache = model.decode_step(tok, cache, i)
            steps.append(prng.gumbel(sub, logits[:, -1].shape) + logits[:, -1])
            tok = torch.from_numpy(want[:, i - 1:i].copy())
    for r in rows:
        i = int(np.argmax(want[r] != got[r]))
        top2 = steps[i][r].topk(2).values
        assert float(top2[0] - top2[1]) <= TIE_TOL, f"row {r} step {i} is no near tie"


def test_ar_generate_matches_jax_and_pins_r8():
    """R8: for an encoder-decoder config JAX prefills BOS with the frames,
    discards the logits, decodes BOS again at position 1 and scans positions
    1..seq_len-1: (B, seq_len - 1) tokens. The port keeps it, and its
    tokens equal JAX's at the same key off near-ties."""
    jm, params, model, frames = _pair()
    fr = frames[:ROWS]
    want = np.asarray(jax_ar_generate(jm, jm.cfg, params, jax.random.key(4), batch_size=ROWS,
                                      seq_len=SEQ, extras={"frames": jnp.asarray(fr)}))
    assert want.shape == (ROWS, SEQ - 1)
    got = ar_generate(model, model.cfg, prng.key(4), batch_size=ROWS, seq_len=SEQ,
                      extras={"frames": torch.from_numpy(fr)})
    assert got.shape == (ROWS, SEQ - 1) and got.dtype == torch.int32
    _first_mismatches_are_near_ties(model, torch.from_numpy(fr), prng.key(4), want, got)


def test_refine_step_fn_with_extras_matches_jax():
    jm, params, model, frames = _pair()
    rng = np.random.default_rng(5)
    x0 = rng.integers(0, V, (4, 16)).astype(np.int32)
    t = np.full((4,), 0.8, np.float32)
    h = np.float32(1 / 16)
    jfn = jax.jit(jax_make_refine_step_fn(jm, jm.cfg, JaxPath(t0=0.8),
                                          extras={"frames": jnp.asarray(frames)}))
    want = np.asarray(jfn(params, jax.random.key(6), jnp.asarray(x0), jnp.asarray(t), h))
    fn = make_refine_step_fn(model, model.cfg, WarmStartPath(t0=0.8),
                             extras={"frames": torch.from_numpy(frames)})
    with torch.no_grad():
        got = fn(prng.key(6), torch.from_numpy(x0), torch.from_numpy(t), torch.tensor(h))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("draft", ["given", "ar_generate"])
def test_serve_through_the_conditioning_object_matches_jax(draft):
    """``WarmStartServer`` on ``Conditioned(model, {"frames": ...})``, 4 x
    16 tokens (the ``ar_generate`` draft: 2 x 8, asked for seq_len 9 because
    of R8), t0 = 0.8, cold_nfe = 16: tokens, NFE (== ``warm_nfe``) and the
    report's counts equal JAX's server on the same conditioning."""
    jm, params, model, frames = _pair()
    if draft == "given":
        num, x = 4, np.random.default_rng(7).integers(0, V, (4, 16)).astype(np.int32)
        jdraft = lambda rng, n: jnp.asarray(x)                      # noqa: E731
        tdraft = lambda rng, n: torch.from_numpy(x.copy())          # noqa: E731
    else:
        num = ROWS
        jfr, tfr = jnp.asarray(frames[:num]), torch.from_numpy(frames[:num])
        jdraft = lambda rng, n: jax_ar_generate(                    # noqa: E731
            jm, jm.cfg, params, rng, batch_size=n, seq_len=SEQ + 1, extras={"frames": jfr})
        tdraft = lambda rng, n: ar_generate(                        # noqa: E731
            model, model.cfg, rng, batch_size=n, seq_len=SEQ + 1, extras={"frames": tfr})
    jserver = JaxWarmStartServer(
        flow_model=JaxConditioned(jm, frames[:num]), flow_cfg=jm.cfg, flow_params=params,
        path=JaxPath(t0=0.8), draft_generate=jdraft, cold_nfe=16)
    cond = Conditioned(model, {"frames": torch.from_numpy(frames[:num])})
    assert cond.device.type == "cpu" and cond.cfg is model.cfg
    server = WarmStartServer(flow_model=cond, flow_cfg=model.cfg, path=WarmStartPath(t0=0.8),
                             draft_generate=tdraft, cold_nfe=16, device="cpu")
    x_j, rep_j = jserver.serve(jax.random.key(11), num)
    x_t, rep_t = server.serve(prng.key(11), num)
    assert x_t.shape == (num, 16 if draft == "given" else SEQ)
    np.testing.assert_array_equal(np.asarray(x_j), x_t.numpy())
    for k in ("nfe", "backbone_evals", "cold_nfe", "fused_block"):
        assert rep_t[k] == rep_j[k]
    assert rep_t["nfe"] == warm_nfe(16, 0.8) == 4


def test_training_the_family_is_refused():
    """The refusal this test pinned is lifted: ``make_loss_fn`` builds for
    the encoder-decoder family and, with the frames in the batch, gives a
    finite loss whose backward reaches every encoder and decoder block (its
    gradients against JAX's are ``test_torch_train_families``'s)."""
    model = _pair()[2]
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(rng.integers(0, 512, (2, 8)).astype(np.int32))
             for k in ("x_src", "x_tgt")}
    batch["frames"] = torch.from_numpy(
        (0.1 * rng.standard_normal((2, model.cfg.num_audio_frames, model.cfg.d_model)))
        .astype(np.float32))
    loss, _ = make_loss_fn(model, model.cfg, WarmStartPath(t0=0.8))(model, batch, prng.key(0))
    assert bool(torch.isfinite(loss))
    grads = torch.autograd.grad(loss, [model.enc_blocks[0].attn.wq.w,
                                       model.dec_blocks[-1].mlp.up.w])
    assert all(bool(torch.isfinite(g).all()) and bool(g.any()) for g in grads)
