"""The gradients of every family the port serves, against the JAX package on
the CPU, at the smoke configs of zamba2-2.7b (Mamba2 + the shared attention
block), xlstm-1.3b (mLSTM + sLSTM) and whisper-medium (encoder-decoder, with
its frames), on the same converted weights, batch, frames and key: the
WS-DFM loss and every gradient against ``jax.value_and_grad`` of JAX's
``make_loss_fn`` (remat on as well for whisper); the port's remat against
no remat, bitwise; remat checkpoints JAX's units (a scanned group, a block). The
optimizer steps, checkpoints and trainers are ``test_torch_train_steps``'s.
Each JAX gradient is jitted once per module. Tolerances are stated where
they are used.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _flatten
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.paths import WarmStartPath as JaxPath
from repro.models import build_model as jax_build_model
from repro.training import make_loss_fn as jax_make_loss_fn
from repro_torch import prng
from repro_torch.configs import get_smoke_config
from repro_torch.convert import jax_leaves, jax_params_to_torch, torch_params_to_jax
from repro_torch.core.paths import WarmStartPath
from repro_torch.models import build_model
from repro_torch.models import encdec as encdec_module
from repro_torch.models import model as model_module
from repro_torch.optim.adafactor import stack_leaf
from repro_torch.training import make_loss_fn
from repro_torch.training.train_step import loss_and_grads

ARCHS = ("zamba2-2.7b", "xlstm-1.3b", "whisper-medium")
B, S, T0 = 2, 24, 0.5
GRAD_TOL = 1e-4          # x max |g| of the leaf: float32 through the smoke stacks
# the key projection's bias moves every score of a row by one constant, which
# the softmax cancels: its gradient is zero in exact arithmetic, and both
# packages give rounding noise of ~1e-9 of the model's largest gradient
ZERO_GRAD_LEAVES = ("attn|wk|b", "cross|wk|b")
ZERO_GRAD_NOISE = 1e-7   # x the model's largest |g|


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread for these smoke-size models: the suite runs in
    several worker processes at once, where torch's default of a thread a
    core makes each small op wait on the others' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nest(flat):
    """A flat ``{"a|b": array}`` -> the nested dict tree JAX's params are."""
    tree = {}
    for key, arr in flat.items():
        *path, leaf = key.split("|")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(arr)
    return tree


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(JAX model, its params, JAX batch, port batch): the port's seeded
    init in JAX's leaves (``convert.torch_params_to_jax``), biases and norm
    parameters moved off 0 / 1 (numpy seed 0); tokens and frames from
    numpy seed 1."""
    jm = jax_build_model(jax_smoke_config(arch))
    cfg = get_smoke_config(arch)
    flat = torch_params_to_jax(build_model(cfg, device="cpu", seed=0).state_dict(), cfg)
    rng = np.random.default_rng(0)
    for k in sorted(flat):
        if k.endswith(("|b", "|bias", "|scale", "|conv_b", "|dt_bias")):
            flat[k] = flat[k] + 0.1 * rng.standard_normal(flat[k].shape).astype(np.float32)
    params = _nest(flat)
    if "stack" in params:      # JAX's init keeps the empty prefix and remainder groups
        for group in ("pre", "rem"):
            params["stack"].setdefault(group, {})
    r = np.random.default_rng(1)
    v = cfg.vocab_size
    batch = {"x_src": r.integers(0, v, (B, S)).astype(np.int32),
             "x_tgt": r.integers(0, v, (B, S)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["frames"] = (0.1 * r.standard_normal(
            (B, cfg.num_audio_frames, cfg.d_model))).astype(np.float32)
    jbatch = {k: jnp.asarray(x) for k, x in batch.items()}
    tbatch = {k: torch.from_numpy(x) for k, x in batch.items()}
    return jm, params, jbatch, tbatch


def _model(arch):
    """The port's model on ``_setup``'s weights."""
    _, params, _, _ = _setup(arch)
    model = build_model(get_smoke_config(arch), device="cpu")
    model.load_state_dict(jax_params_to_torch(_flatten(params)), strict=True)
    return model


@functools.lru_cache(maxsize=None)
def _jax_grads(arch, remat):
    jm, params, jbatch, _ = _setup(arch)
    fn = jax.jit(jax.value_and_grad(jax_make_loss_fn(jm, jm.cfg, JaxPath(T0), remat=remat),
                                    has_aux=True))
    (loss, metrics), grads = fn(params, jbatch, jax.random.key(3))
    return float(loss), float(metrics["t_mean"]), _flatten(grads)


@functools.lru_cache(maxsize=None)
def _port_grads(arch, remat):
    model = _model(arch)
    loss, metrics, grads = loss_and_grads(
        make_loss_fn(model, model.cfg, WarmStartPath(T0), remat=remat), model,
        jax_leaves(model), _setup(arch)[3], prng.key(3))
    return float(loss.detach()), float(metrics["t_mean"]), grads


# remat on against JAX's remat for whisper, whose encoder and decoder blocks
# are checkpointed apart; the decoder-only archs' remat gradients are their
# no-remat ones bit for bit (below), and JAX's jit of each costs ~6 s of CPU
@pytest.mark.parametrize("arch,remat", [(arch, False) for arch in ARCHS]
                         + [("whisper-medium", True)])
def test_loss_and_every_gradient_match_jax(arch, remat):
    """The loss within 1e-6 relative, t_mean exact; every leaf within
    GRAD_TOL of its max |g|, except the key biases, where both sides are
    rounding noise under ZERO_GRAD_NOISE; the leaves JAX leaves exactly
    zero (zamba2's ``zshared`` positions' ``ln1``, which the shared block
    never reads) are exactly zero here too."""
    want_loss, want_t, want = _jax_grads(arch, remat)
    loss, t_mean, grads = _port_grads(arch, remat)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    assert t_mean == want_t
    assert list(grads) == list(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    zero = []
    for k, w in want.items():
        got = stack_leaf(k, [g.detach() for g in grads[k]]).numpy()
        assert got.shape == w.shape, k
        if k.endswith(ZERO_GRAD_LEAVES):
            assert max(np.abs(got).max(), np.abs(w).max()) <= ZERO_GRAD_NOISE * top, k
            continue
        if not np.abs(w).any():
            zero.append(k)
        np.testing.assert_allclose(got, w, rtol=0, atol=GRAD_TOL * np.abs(w).max(), err_msg=k)
    assert zero == (["stack|blocks|p5|ln1|scale"] if arch == "zamba2-2.7b" else [])


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bitwise_in_the_port(arch):
    """The same loss and gradients with and without remat, bit for bit (the
    recomputed forward runs the same operations, and the backward graph is
    the same)."""
    loss, _, grads = _port_grads(arch, False)
    loss_r, _, grads_r = _port_grads(arch, True)
    assert loss == loss_r
    for k in grads:
        for g, g_r in zip(grads[k], grads_r[k]):
            assert torch.equal(g, g_r), k


def _counting(monkeypatch, module):
    calls = []
    real = module.checkpoint

    def counted(fn, *args, **kwargs):
        calls.append(fn)
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(module, "checkpoint", counted)
    return calls


def test_remat_checkpoints_the_units_jax_checkpoints(monkeypatch):
    """Decoder-only: one checkpoint a scanned group of ``len(pattern)``
    layers, none for the remainder (zamba2's pattern at 14 layers: 2
    groups of 6 and 2 remainder layers); the encoder-decoder: one a block,
    encoder and decoder, ``build_cross_kvs`` outside."""
    calls = _counting(monkeypatch, model_module)
    cfg = get_smoke_config("zamba2-2.7b").replace(num_layers=14)
    assert cfg.scan_split() == (2, ("mamba", "mamba"))
    model = build_model(cfg, device="cpu")
    x = torch.zeros((1, 8), dtype=torch.int64)
    t = torch.full((1,), 0.5)
    model(x, t, remat=True).sum().backward()
    assert len(calls) == 2
    calls = _counting(monkeypatch, encdec_module)
    model = _model("whisper-medium")
    frames = _setup("whisper-medium")[3]["frames"]
    model(x, t.expand(1), frames=frames[:1], remat=True).sum().backward()
    assert len(calls) == model.cfg.num_encoder_layers + model.cfg.num_layers
