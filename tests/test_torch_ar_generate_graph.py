"""``ar_generate``'s dispatch on the CPU: its compile key (what JAX's one
``lax.scan`` would recompile on), what enters the CUDA graph as inputs, the
per-model map of graphs (held weakly), and the eager loop against JAX's
``ar_generate`` on converted weights: whisper-medium's smoke config (the
encoder prefill inside; reference fault R8, ``seq_len - 1`` tokens) and
starcoder2-3b's (decoder-only), tokens equal off near-ties. The graph
itself is captured only on the card (``tests/test_torch_kernels_cuda.py``)."""

import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _flatten
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import build_model as jax_build_model
from repro.serving.engine import ar_generate as jax_ar_generate
from repro_torch import prng
from repro_torch.configs import get_smoke_config
from repro_torch.convert import jax_params_to_torch
from repro_torch.graphs import GraphCache
from repro_torch.models import Model, build_model
from repro_torch.serving import engine
from repro_torch.serving.engine import _ar_generate_eager, ar_compile_key, ar_generate, ar_graphs

TIE_TOL = 1e-5        # a draw's two best (gumbel + logits / T) within this: a near tie
ENCDEC, DENSE, VLM = "whisper-medium", "starcoder2-3b", "qwen2-vl-72b"


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread for these smoke-size models: the suite runs in
    several worker processes at once, where torch's default of a thread a
    core makes each small op wait on the others' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def dispatched(monkeypatch):
    """Every ``GraphCache`` call of the test as (key, inputs), passed on."""
    seen = []
    call = GraphCache.__call__

    def spy(self, key, fn, *inputs):
        seen.append((key, inputs))
        return call(self, key, fn, *inputs)

    monkeypatch.setattr(GraphCache, "__call__", spy)
    return seen


def _frames(cfg, rows=2, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.standard_normal((rows, cfg.num_audio_frames, cfg.d_model)).astype(np.float32))


KW = dict(batch_size=2, seq_len=6, bos=0, temperature=1.0, dtype=torch.float32)


@pytest.mark.parametrize("change", [
    dict(batch_size=3), dict(seq_len=7), dict(temperature=0.7), dict(bos=5),
    dict(dtype=torch.bfloat16), dict(frames=(2, 16, 128)), dict(frames_dtype=torch.bfloat16),
], ids=["rows", "seq_len", "temperature", "bos", "dtype", "frames_shape", "frames_dtype"])
def test_compile_key_changes_with_what_the_scan_recompiles_on(change):
    cfg = get_smoke_config(ENCDEC)
    frames = torch.zeros((2, cfg.num_audio_frames, cfg.d_model))
    base = ar_compile_key(cfg, extras={"frames": frames}, **KW)
    kw = dict(KW)
    kw.update({k: v for k, v in change.items() if not k.startswith("frames")})
    if "frames" in change:
        frames = torch.zeros(change["frames"])
    frames = frames.to(change.get("frames_dtype", torch.float32))
    assert ar_compile_key(cfg, extras={"frames": frames}, **kw) != base


def test_one_key_for_other_keys_and_frames_and_the_frames_enter_as_inputs(dispatched):
    """An encoder-decoder's calls under other rng keys and other frames of
    the same shape dispatch one compile key, with the key and the frames
    (by name) as the graph's inputs; a new row count is a new key."""
    cfg = get_smoke_config(ENCDEC)
    model = build_model(cfg, device="cpu", seed=1)
    fa, fb = _frames(cfg, seed=1), _frames(cfg, seed=2)
    a = ar_generate(model, cfg, prng.key(3), extras={"frames": fa}, **KW)
    b = ar_generate(model, cfg, prng.key(4), extras={"frames": fb}, **KW)
    ar_generate(model, cfg, prng.key(3), extras={"frames": _frames(cfg, rows=3)},
                **dict(KW, batch_size=3))
    (ka, ia), (kb, ib), (kc, _) = dispatched
    assert ka == kb == ar_compile_key(cfg, extras={"frames": fa}, **KW) != kc
    assert len(ia) == 2 and torch.equal(ia[0], prng.key(3)) and ia[1] is fa
    assert torch.equal(ib[0], prng.key(4)) and ib[1] is fb
    assert a.shape == b.shape == (2, KW["seq_len"] - 1) and not torch.equal(a, b)


def test_decoder_only_extras_enter_neither_the_key_nor_the_inputs(dispatched):
    """R11: a VLM's patches and positions are dropped, as JAX drops them:
    the same key as without them, the rng key the graph's only input, the
    same tokens."""
    from repro_torch.models.rope import vlm_positions

    cfg = get_smoke_config(VLM)
    model = Model(cfg, device="cpu", seed=2)
    extras = {"patches": 0.1 * torch.randn((2, cfg.num_vision_tokens, 1280)),
              "positions": vlm_positions(2, (2, 4), 6)}
    assert ar_compile_key(cfg, extras=extras, **KW) == ar_compile_key(cfg, **KW)
    with_extras = ar_generate(model, cfg, prng.key(5), extras=extras, **KW)
    plain = ar_generate(model, cfg, prng.key(5), **KW)
    (k1, i1), (k2, i2) = dispatched
    assert k1 == k2 == ar_compile_key(cfg, **KW)
    assert len(i1) == len(i2) == 1 and torch.equal(i1[0], prng.key(5))
    assert torch.equal(with_extras, plain) and plain.shape == (2, KW["seq_len"])


def test_the_graph_map_holds_no_model():
    """The per-model map of graphs holds each model weakly: one cache a
    model, and after ``del model`` its entry (with any graph and pool) is
    gone. On the CPU nothing is captured."""
    cfg = get_smoke_config(ENCDEC)
    model = build_model(cfg, device="cpu", seed=1)
    ar_generate(model, cfg, prng.key(3), extras={"frames": _frames(cfg)}, **KW)
    graphs = ar_graphs(model)
    assert ar_graphs(model) is graphs and model in engine._AR_GRAPHS
    assert (graphs.captures, graphs.replays, len(graphs)) == (0, 0, 0)
    n = len(engine._AR_GRAPHS)
    del model
    gc.collect()
    assert len(engine._AR_GRAPHS) == n - 1


# -- against JAX ----------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _pair(arch, seed=0):
    """(JAX model, its params, the port's model on the same weights), the
    norm scales and biases moved off their initial values."""
    jm = jax_build_model(jax_get_smoke_config(arch))
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if jax.tree_util.keystr(path).endswith(("['b']", "['bias']", "['scale']")):
            return x + 0.1 * jnp.asarray(rng.standard_normal(x.shape), jnp.float32)
        return x

    params = jax.tree_util.tree_map_with_path(leaf, jm.init(jax.random.key(seed)))
    model = build_model(get_smoke_config(arch), device="cpu")
    model.load_state_dict(jax_params_to_torch(_flatten(params)), strict=True)
    return jm, params, model


def _scores(model, key, tokens, seq_len, extras, temperature):
    """Each draw's ``gumbel + logits / T`` in the port, the loop fed
    ``tokens`` (B, n): what ``ar_generate`` draws from along that path."""
    cfg, b = model.cfg, tokens.shape[0]
    cache = model.init_cache(b, seq_len + 1, torch.float32)
    tok, start, out = torch.zeros((b, 1), dtype=torch.int32), 0, []
    with torch.no_grad():
        if cfg.is_encoder_decoder:
            _, cache = model.prefill({"tokens": tok, **extras}, cache)
            start = 1
        for j, i in enumerate(range(start, seq_len)):
            key, sub = prng.split(key, 2)
            logits, cache = model.decode_step(tok, cache, i)
            last = logits[:, -1].float() / temperature
            out.append(prng.gumbel(sub, last.shape) + last)
            tok = tokens[:, j:j + 1]
    return out


@pytest.mark.parametrize("arch,rows,seq_len,temperature", [
    (ENCDEC, 2, 8, 1.0), (DENSE, 3, 8, 0.8)])
def test_ar_generate_on_the_cpu_matches_jax(arch, rows, seq_len, temperature):
    """The eager loop == JAX's ``ar_generate`` at the same key off near-ties
    (at a row's first differing draw the port's two best scores lie within
    TIE_TOL), with R8 for the encoder-decoder (``seq_len - 1`` tokens); the
    dispatched call == the eager yardstick bitwise."""
    jm, params, model = _pair(arch)
    cfg = model.cfg
    extras = {"frames": _frames(cfg, rows)} if cfg.is_encoder_decoder else {}
    kw = dict(batch_size=rows, seq_len=seq_len, temperature=temperature)
    want = np.asarray(jax_ar_generate(
        jm, jm.cfg, params, jax.random.key(4),
        extras={k: jnp.asarray(v.numpy()) for k, v in extras.items()}, **kw))
    got = ar_generate(model, cfg, prng.key(4), extras=extras, **kw)
    n = seq_len - 1 if cfg.is_encoder_decoder else seq_len
    assert want.shape == tuple(got.shape) == (rows, n) and got.dtype == torch.int32
    assert torch.equal(got, _ar_generate_eager(model, cfg, prng.key(4), extras=extras, **kw))
    rows_off = np.nonzero((want != got.numpy()).any(axis=1))[0]
    if len(rows_off):
        scores = _scores(model, prng.key(4), torch.from_numpy(want), seq_len, extras,
                         temperature)
        for r in rows_off:
            i = int(np.argmax(want[r] != got.numpy()[r]))
            top2 = scores[i][r].topk(2).values
            assert float(top2[0] - top2[1]) <= TIE_TOL, f"row {r} step {i} is no near tie"
