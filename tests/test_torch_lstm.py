"""The port's LSTM draft (``models/lstm.py``) and its engine adapter
against the JAX package's, on JAX parameters converted by
``convert.jax_lstm_params_to_torch``.

``step``, ``forward`` and ``loss`` agree within 1e-5 (float32 products in
another order); sampled tokens are equal (same noise, and no draw here
lies within that error of a tie); the engine with ``LSTMDraftAdapter``
equals the JAX engine and the cache-free oracle token for token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _flatten
from repro.drafting import ARDraftEngine as JaxEngine
from repro.drafting import LSTMDraftAdapter as JaxAdapter
from repro.models.lstm import LSTMConfig as JaxConfig
from repro.models.lstm import LSTMModel as JaxLSTM
from repro_torch import prng
from repro_torch.convert import jax_lstm_params_to_torch
from repro_torch.drafting import ARDraftEngine, LSTMDraftAdapter, oracle_generate_rows
from repro_torch.models import LSTMConfig, LSTMModel

VOCAB, HIDDEN, EMBED = 27, 32, 16
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread for these smoke-size models: the suite runs in
    several worker processes at once, where torch's default of a thread a
    core makes each small op wait on the others' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(layers=2, seed=1):
    jcfg = JaxConfig(vocab_size=VOCAB, hidden=HIDDEN, num_layers=layers, embed_dim=EMBED)
    jmodel = JaxLSTM(jcfg)
    jparams = jmodel.init(jax.random.key(seed))
    model = LSTMModel(LSTMConfig(vocab_size=VOCAB, hidden=HIDDEN, num_layers=layers,
                                 embed_dim=EMBED))
    params = jax_lstm_params_to_torch(_flatten(jparams), device="cpu")
    return jmodel, jparams, model, params


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, s)).astype(np.int32)


@pytest.mark.parametrize("layers", [1, 2])
def test_step_matches_jax(layers):
    jmodel, jparams, model, params = _models(layers)
    toks = _tokens(3, 4)
    jstate, state = jmodel.init_state(3), model.init_state(3, device="cpu")
    for i in range(4):
        jl, jstate = jmodel.step(jparams, jnp.asarray(toks[:, i]), jstate)
        lg, state = model.step(params, torch.from_numpy(toks[:, i]), state)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=TOL, rtol=0)
        for (jh, jc), (h, c) in zip(jstate, state):
            np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=TOL, rtol=0)
            np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=TOL, rtol=0)


def test_forward_and_loss_match_jax():
    jmodel, jparams, model, params = _models()
    toks = _tokens(4, 16, seed=1)
    want = np.asarray(jmodel.forward(jparams, jnp.asarray(toks)))
    got = model.forward(params, torch.from_numpy(toks))
    assert got.shape == (4, 16, VOCAB)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    np.testing.assert_allclose(float(model.loss(params, torch.from_numpy(toks))),
                               float(jmodel.loss(jparams, jnp.asarray(toks))), atol=TOL, rtol=0)


@pytest.mark.parametrize("num,seq_len,temperature,bos", [(4, 16, 1.0, 0), (3, 9, 0.7, 5)])
def test_generate_matches_jax(num, seq_len, temperature, bos):
    jmodel, jparams, model, params = _models()
    want = np.asarray(jmodel.generate(jparams, jax.random.key(7), num, seq_len,
                                      temperature=temperature, bos=bos))
    got = model.generate(params, prng.key(7), num, seq_len, temperature=temperature, bos=bos)
    assert got.dtype == torch.int32 and got.shape == (num, seq_len)
    np.testing.assert_array_equal(got.numpy(), want)


def test_conversion_carries_every_leaf():
    """JAX tree -> flat ``|`` keys (the checkpoint layout) -> torch tree: the
    same arrays at the same places; a stray leaf raises."""
    _, jparams, _, params = _models()
    flat = _flatten(jparams)
    assert sorted(flat) == ["embed|table", "head|w", "layers|0|wh|w", "layers|0|wx|w",
                            "layers|1|wh|w", "layers|1|wx|w"]
    np.testing.assert_array_equal(params["embed"]["table"].numpy(), flat["embed|table"])
    np.testing.assert_array_equal(params["head"]["w"].numpy(), flat["head|w"])
    for i, lp in enumerate(params["layers"]):
        for w in ("wx", "wh"):
            np.testing.assert_array_equal(lp[w]["w"].numpy(), flat[f"layers|{i}|{w}|w"])
    with pytest.raises(KeyError):
        jax_lstm_params_to_torch({**flat, "layers|0|wx|b": flat["head|w"]}, device="cpu")


def test_seeded_init_shapes_and_scales():
    model = LSTMModel(LSTMConfig(vocab_size=VOCAB, hidden=64, num_layers=2, embed_dim=48))
    p = model.init(3, device="cpu")
    assert p["embed"]["table"].shape == (VOCAB, 48)
    assert [lp["wx"]["w"].shape for lp in p["layers"]] == [(48, 256), (64, 256)]
    assert [lp["wh"]["w"].shape for lp in p["layers"]] == [(64, 256), (64, 256)]
    assert p["head"]["w"].shape == (64, VOCAB)
    assert abs(float(p["embed"]["table"].std()) - 0.02) < 0.005
    assert abs(float(p["layers"][0]["wx"]["w"].std()) - 48 ** -0.5) < 0.02
    torch.testing.assert_close(model.init(3, device="cpu")["head"]["w"], p["head"]["w"])


def _engine_case():
    keys = np.stack([np.asarray(jax.random.key_data(k)) for k in
                     jax.random.split(jax.random.key(4), 3)]).astype(np.int64)
    prompt = _tokens(3, 3, seed=5)
    return keys, prompt


def test_engine_with_lstm_adapter_matches_jax_engine_and_oracle():
    """Twice with the same prompt (the second call reuses the pooled state),
    then a new prompt and the default BOS prompt."""
    jmodel, jparams, model, params = _models()
    keys, prompt = _engine_case()
    jeng = JaxEngine(JaxAdapter(model=jmodel), jparams, max_len=20)
    adapter = LSTMDraftAdapter(model=model, params=params)
    eng = ARDraftEngine(adapter, max_len=20)
    assert eng.prefill_mode == "batched"
    tkeys = torch.from_numpy(keys)
    jkeys = jax.random.wrap_key_data(jnp.asarray(keys.astype(np.uint32)))
    for p, n in ((prompt, 12), (prompt, 12), (prompt[:, :2] + 1, 8), (None, 6)):
        want = np.asarray(jeng.generate_rows(jkeys, n, prompt=None if p is None else
                                             jnp.asarray(p)))
        tp = None if p is None else torch.from_numpy(p)
        got = eng.generate_rows(tkeys, n, prompt=tp)
        np.testing.assert_array_equal(got.numpy(), want)
        oracle = oracle_generate_rows(adapter, tkeys, n, prompt=tp)
        np.testing.assert_array_equal(got.numpy(), oracle.numpy())
    assert eng.stats.as_dict() == jeng.stats.as_dict()
    assert eng.stats.prefill_reuses == 1


def test_lstm_adapter_scan_prefill_equals_batched():
    _, _, model, params = _models()
    keys, prompt = _engine_case()
    adapter = LSTMDraftAdapter(model=model, params=params)
    outs = [ARDraftEngine(adapter, max_len=20, prefill_mode=mode).generate_rows(
        torch.from_numpy(keys), 10, prompt=torch.from_numpy(prompt))
        for mode in ("scan", "batched")]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
