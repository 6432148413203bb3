"""The port's AR draft stage against the JAX package's: row-keyed
``categorical``, ``ARDraftEngine.generate_rows`` tokens and stats,
``ar_generate``; and, inside the port, the engine equal to the cache-free
oracle bitwise (prefill lengths, batch sizes, partial prefix reuse), pack
invariance, batched prefill equal to scan, and the capacity errors.

Tokens must equal JAX's except where a row's first mismatch is a float
near-tie: the port's two best scores (Gumbel noise + logits / T) at that
step within 1e-5 (the two sides' logits differ by ~1e-6, their noise by
at most 1 ulp). The JAX oracle stays out (O(L^2) Pallas interpret calls).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _flatten
from repro.configs.dfm_dit import tiny_config as jax_tiny_config
from repro.drafting import (
    ARDraftEngine as JaxEngine, TransformerDraftAdapter as JaxAdapter,
)
from repro.models import build_model as jax_build_model
from repro.serving.engine import ar_generate as jax_ar_generate
from repro_torch import prng
from repro_torch.configs.dfm_dit import tiny_config
from repro_torch.convert import jax_params_to_torch
from repro_torch.drafting import (
    ARDraftEngine, TransformerDraftAdapter, oracle_generate_rows, row_gumbel,
)
from repro_torch.models import Model
from repro_torch.serving import BatchKeyedDraftWarning, ar_generate, batch_keyed_draft

VOCAB = 13
TIE_TOL = 1e-5
SMALL = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=2, d_ff=64)


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread for these smoke-size models: the suite runs in
    several worker processes at once, where torch's default of a thread a
    core makes each small op wait on the others' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    cfg_kw = dict(SMALL)
    jm = jax_build_model(jax_tiny_config(vocab_size=VOCAB, seq_len=64).replace(**cfg_kw))
    params = jm.init(jax.random.key(0))
    model = Model(tiny_config(vocab_size=VOCAB, seq_len=64).replace(**cfg_kw), device="cpu")
    model.load_state_dict(jax_params_to_torch(_flatten(params)), strict=True)
    return jm, params, model


@pytest.fixture(scope="module")
def adapter(pair):
    return TransformerDraftAdapter(model=pair[2])


def _keys(n, seed=5):
    return jax.random.split(jax.random.key(seed), n), prng.split(prng.key(seed), n)


def _prompt(b, p, seed=9):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, p)).astype(np.int32)


def _first_mismatches_are_near_ties(adapter, keys, prompt, want, got, temperature):
    """Rows where ``got`` differs from ``want``: at the first differing
    step, replay the common prefix through the port and require its two
    best scores to lie within TIE_TOL. Returns the number of such rows."""
    want, got = np.asarray(want), np.asarray(got)
    noise = row_gumbel(keys, want.shape[1], VOCAB, "cpu")
    ties = 0
    for b in np.nonzero((want != got).any(axis=1))[0]:
        i = int(np.argmax(want[b] != got[b]))
        toks = torch.from_numpy(np.concatenate([prompt[b], want[b, :i]]).astype(np.int32))[None]
        cache = adapter.init_cache(1, toks.shape[1])
        for j in range(toks.shape[1]):
            logits, cache = adapter.decode_step(toks[:, j], cache, j)
        top2 = (noise[b, i] + logits[0] / temperature).topk(2).values
        assert float(top2[0] - top2[1]) <= TIE_TOL, f"row {b} step {i} is no near tie"
        ties += 1
    return ties


def test_categorical_matches_jax():
    logits = (3 * np.random.default_rng(0).standard_normal((6, VOCAB))).astype(np.float32)
    kj, kt = _keys(6, seed=3)
    want = jax.vmap(jax.random.categorical)(kj, jnp.asarray(logits))
    np.testing.assert_array_equal(prng.categorical(kt, torch.from_numpy(logits)).numpy(),
                                  np.asarray(want))
    want = jax.random.categorical(jax.random.key(8), jnp.asarray(logits))
    np.testing.assert_array_equal(prng.categorical(prng.key(8), torch.from_numpy(logits)).numpy(),
                                  np.asarray(want))


def test_row_gumbel_is_the_per_token_categorical_noise():
    """Token i of row b draws with ``fold_in(keys[b], i)`` (the JAX
    engine's rule); the engine takes all tokens' noise in one batch."""
    _, kt = _keys(3)
    noise = row_gumbel(kt, 4, VOCAB, "cpu")
    logits = torch.from_numpy(np.random.default_rng(1).standard_normal((3, VOCAB)).astype(np.float32))
    for i in range(4):
        want = prng.categorical(prng.fold_in(kt, i), logits)
        assert torch.equal(torch.argmax(noise[:, i] + logits, -1), want)


@pytest.mark.parametrize("b,p", [(1, 1), (1, 3), (3, 1), (3, 3)])
def test_engine_tokens_and_stats_match_jax(pair, adapter, b, p):
    """The JAX kernel-path engine and the port's, same weights, keys and
    prompt: a prefill then a reuse of the pooled prefix."""
    jm, params, _ = pair
    kj, kt = _keys(b)
    prompt = _prompt(b, p)
    jeng = JaxEngine(JaxAdapter(model=jm), params, max_len=12, temperature=0.9)
    eng = ARDraftEngine(adapter, max_len=12, temperature=0.9)
    assert jeng.prefill_mode == eng.prefill_mode == "batched"
    for _ in range(2):
        want = jeng.generate_rows(kj, 8, prompt=jnp.asarray(prompt))
        got = eng.generate_rows(kt, 8, prompt=torch.from_numpy(prompt))
        assert got.dtype == torch.int32 and got.shape == (b, 8)
        _first_mismatches_are_near_ties(adapter, kt, prompt, want, got, 0.9)
    assert eng.stats.as_dict() == jeng.stats.as_dict() == {
        "prefill_computes": 1, "prefill_reuses": 1, "decode_dispatches": 2,
        "tokens_generated": 16 * b}


@pytest.mark.parametrize("batch,prefix_len", [(1, 1), (3, 1), (2, 3), (2, 6)])
def test_engine_matches_oracle(adapter, batch, prefix_len):
    _, kt = _keys(batch)
    prompt = torch.from_numpy(_prompt(batch, prefix_len))
    out = ARDraftEngine(adapter, max_len=16, temperature=0.9).generate_rows(
        kt, 6, prompt=prompt)
    ref = oracle_generate_rows(adapter, kt, 6, prompt=prompt, temperature=0.9, max_len=16)
    assert torch.equal(out, ref)


def test_default_prompt_is_bos(adapter):
    _, kt = _keys(2)
    out = ARDraftEngine(adapter, max_len=8, bos=3).generate_rows(kt, 5)
    assert torch.equal(out, oracle_generate_rows(adapter, kt, 5, bos=3, max_len=8))


def test_partial_cache_reuse_is_bit_exact(adapter):
    """The prefix KV survives across calls and bucket lengths; the reused
    cache stays bit-identical to the oracle."""
    eng = ARDraftEngine(adapter, max_len=16)
    _, kt = _keys(2)
    prompt = torch.from_numpy(_prompt(2, 4, seed=3))
    ref8 = oracle_generate_rows(adapter, kt, 8, prompt=prompt, max_len=16)
    outs = [eng.generate_rows(kt, n, prompt=prompt) for n in (8, 8, 5, 8)]
    for out in (outs[0], outs[1], outs[3]):
        assert torch.equal(out, ref8)
    assert torch.equal(outs[2], ref8[:, :5])      # prefix-stable drafts
    assert (eng.stats.prefill_computes, eng.stats.prefill_reuses) == (1, 3)
    other = torch.zeros((2, 4), dtype=torch.int32)
    out = eng.generate_rows(kt, 8, prompt=other)
    assert eng.stats.prefill_computes == 2
    assert torch.equal(out, oracle_generate_rows(adapter, kt, 8, prompt=other, max_len=16))
    assert eng.stats.as_dict() == {"prefill_computes": 2, "prefill_reuses": 3,
                                   "decode_dispatches": 5, "tokens_generated": 2 * 37}


def test_engine_keeps_its_cache_and_rewinds_in_place(adapter):
    """One cache per row count for the engine's lifetime (a decode graph
    writes those buffers): across computed, reused and recomputed prefixes
    the k/v and cursor tensors keep their storage, the cursors rest at the
    prefix length, and the tokens equal the oracle's; reset drops them."""
    eng = ARDraftEngine(adapter, max_len=16)
    _, kt = _keys(2)
    prompts = [torch.from_numpy(_prompt(2, 4, seed=s)) for s in (3, 3, 4, 3)]
    leaves, ptrs = None, None
    for prompt in prompts:
        out = eng.generate_rows(kt, 7, prompt=prompt)
        assert torch.equal(out, oracle_generate_rows(adapter, kt, 7, prompt=prompt, max_len=16))
        cache = eng._caches[2]
        now = [leaf for group in ("blocks", "rem") for c in cache[group].values()
               for leaf in (c["k"], c["v"], c["pos"])]
        if leaves is None:
            leaves, ptrs = now, [t.data_ptr() for t in now]
        assert all(a is b for a, b in zip(now, leaves))
        assert [t.data_ptr() for t in now] == ptrs
        assert all(int(c["pos"].min()) == int(c["pos"].max()) == 4
                   for group in ("blocks", "rem") for c in cache[group].values())
        assert eng._pool[2].snapshot is cache
    assert (eng.stats.prefill_computes, eng.stats.prefill_reuses) == (3, 1)
    eng.reset()
    assert not eng._caches and not eng._pool


def test_decode_graph_keys_and_eager_path(adapter, monkeypatch):
    """The decode goes through the graph cache keyed (rows, prefix_len,
    seq_len): repeated shapes share a key, another rows, prefix or seq_len
    does not; the graphed path, the private eager one and the oracle agree
    bitwise, with reused and recomputed prefixes."""
    from repro_torch.graphs import GraphCache

    keys = []

    def call(self, key, fn, *inputs):
        keys.append(key)
        return fn(*inputs)

    monkeypatch.setattr(GraphCache, "__call__", call)
    eng = ARDraftEngine(adapter, max_len=16)
    eager = ARDraftEngine(adapter, max_len=16)
    cases = [(2, 3, 6, 5), (2, 3, 6, 6), (2, 3, 6, 7), (3, 3, 6, 5), (2, 4, 6, 5), (2, 3, 5, 5)]
    for b, p, n, seed in cases:
        _, kt = _keys(b, seed=seed)
        prompt = torch.from_numpy(_prompt(b, p))
        got = eng.generate_rows(kt, n, prompt=prompt)
        assert torch.equal(got, eager._generate_rows_eager(kt, n, prompt=prompt))
        assert torch.equal(got, oracle_generate_rows(adapter, kt, n, prompt=prompt, max_len=16))
    assert keys == [(2, 3, 6)] * 3 + [(3, 3, 6), (2, 4, 6), (2, 3, 5)]
    assert eng.stats.as_dict() == eager.stats.as_dict()


def test_generate_rows_is_pack_invariant(adapter):
    _, kt = _keys(5)
    eng = ARDraftEngine(adapter, max_len=12)
    full = eng.generate_rows(kt, 6)
    assert torch.equal(full[1:4], eng.generate_rows(kt[1:4], 6))


def test_batched_prefill_is_bit_identical_to_scan(adapter):
    _, kt = _keys(2)
    prompt = torch.from_numpy(_prompt(2, 5, seed=11))
    outs = [ARDraftEngine(adapter, max_len=16, prefill_mode=mode).generate_rows(
        kt, 6, prompt=prompt) for mode in ("scan", "batched", None)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_plain_decode_path_keeps_scan_default(pair, adapter):
    """decode_impl="xla" (the model's own plain-torch decode) is only
    float-close in a batched prefill, so the engine falls back to scan."""
    xla = TransformerDraftAdapter(model=pair[2], decode_impl="xla")
    assert not xla.exact_batched_prefill
    eng = ARDraftEngine(xla, max_len=16)
    assert eng.prefill_mode == "scan"
    _, kt = _keys(2)
    prompt = _prompt(2, 5, seed=11)
    out = eng.generate_rows(kt, 6, prompt=torch.from_numpy(prompt))
    ref = ARDraftEngine(adapter, max_len=16).generate_rows(kt, 6, prompt=torch.from_numpy(prompt))
    _first_mismatches_are_near_ties(adapter, kt, prompt, ref, out, 1.0)


def test_engine_validates_capacity_and_shapes(adapter):
    eng = ARDraftEngine(adapter, max_len=8)
    _, kt = _keys(2)
    with pytest.raises(ValueError, match="cache capacity"):
        eng.generate_rows(kt, 9)
    with pytest.raises(ValueError, match="prompt rows"):
        eng.generate_rows(kt, 4, prompt=torch.zeros((3, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="seq_len"):
        eng.generate_rows(kt, 0)
    with pytest.raises(ValueError, match="prefill_mode"):
        ARDraftEngine(adapter, max_len=8, prefill_mode="nope")
    eng.generate_rows(kt, 8)                       # 1 + 8 - 1 fills it exactly


def test_ar_generate_matches_jax(pair):
    jm, params, model = pair
    want = jax_ar_generate(jm, jm.cfg, params, jax.random.key(4), batch_size=3, seq_len=6,
                           temperature=0.8)
    got = ar_generate(model, model.cfg, prng.key(4), batch_size=3, seq_len=6, temperature=0.8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batch_keyed_draft_warns_once_and_keys_off_row_zero():
    seen = []

    def generate(key, num, seq_len):
        seen.append(key.clone())
        return torch.zeros((num, seq_len), dtype=torch.int32)

    draft = batch_keyed_draft(generate)
    keys = prng.split(prng.key(1), 3)
    with pytest.warns(BatchKeyedDraftWarning):
        assert draft(keys, 4).shape == (3, 4)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        draft(keys, 4)
    assert all(torch.equal(k, keys[0]) for k in seen)
