"""The paper's generation API in the port against the JAX package's:
``EulerSampler``, ``WarmStartPipeline.generate`` with each draft kind, the
drafts themselves, ``make_refine_step`` and ``make_refine_step_fn``, on
the same converted weights and keys.

Counts (``nfe``, ``backbone_evals``) and ``SpeedupReport`` fields are
exact; tokens are equal (both sides draw the same noise; the default step
on the CPU is ``euler_step_probs`` + ``categorical_from_probs``, and no
draw here lies within float error of a tie). The installed JAX fails
``EulerSampler(jit=True)`` (reference fault R1), so the JAX side runs with
``jit=False``; nothing in ``src/repro`` changes for that.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _flatten
from repro.configs.dfm_dit import tiny_config as jax_tiny_config
from repro.core import draft as jax_draft
from repro.core.guarantees import GuaranteeViolation as JaxGuaranteeViolation
from repro.core.paths import WarmStartPath as JaxPath
from repro.core.paths import uniform_noise as jax_uniform_noise
from repro.core.pipeline import WarmStartPipeline as JaxPipeline
from repro.core.sampler import EulerSampler as JaxSampler
from repro.core.sampler import make_refine_step as jax_make_refine_step
from repro.models import build_model as jax_build_model
from repro.models.lstm import LSTMConfig as JaxLSTMConfig
from repro.models.lstm import LSTMModel as JaxLSTM
from repro.serving.engine import make_refine_step_fn as jax_make_refine_step_fn
from repro_torch import prng
from repro_torch.configs.dfm_dit import tiny_config
from repro_torch.convert import jax_lstm_params_to_torch, jax_params_to_torch
from repro_torch.core import (
    ARDraft, CorruptionDraft, EulerSampler, GuaranteeViolation, HistogramDraft, SamplerStats,
    WarmStartPath, WarmStartPipeline, cold_start_path, make_refine_step, mask_noise,
    uniform_noise,
)
from repro_torch.drafting import measure_cost_ratio
from repro_torch.models import LSTMConfig, LSTMModel, Model
from repro_torch.serving import make_refine_step_fn

V, SEQ, NUM, COLD_NFE = 27, 16, 4, 16


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
def models():
    jm = jax_build_model(jax_tiny_config())
    params = jm.init(jax.random.key(0))
    model = Model(tiny_config(), device="cpu")
    model.load_state_dict(jax_params_to_torch(_flatten(params)), strict=True)
    jlstm = JaxLSTM(JaxLSTMConfig(vocab_size=V, hidden=32, num_layers=2, embed_dim=16))
    lparams = jlstm.init(jax.random.key(2))
    lstm = LSTMModel(LSTMConfig(vocab_size=V, hidden=32, num_layers=2, embed_dim=16))
    tparams = jax_lstm_params_to_torch(_flatten(lparams), device="cpu")
    data = np.random.default_rng(9).integers(0, V, (40, SEQ)).astype(np.int32)
    return {"jm": jm, "params": params, "model": model, "jlstm": jlstm, "lparams": lparams,
            "lstm": lstm, "tparams": tparams, "data": data}


def _model_fns(m):
    def jax_fn(x, t):
        return m["jm"].dfm_apply(m["params"], x, t)

    def torch_fn(x, t):
        return m["model"].dfm_apply(x, t)

    return jax_fn, torch_fn


def _x_init(seed):
    return np.random.default_rng(seed).integers(0, V, (NUM, SEQ)).astype(np.int32)


@pytest.mark.parametrize("t0", [0.8, 0.0])
@pytest.mark.parametrize("fused_block", [1, 2])
@pytest.mark.parametrize("argmax_final", [False, True])
def test_euler_sampler_matches_jax(models, t0, fused_block, argmax_final):
    cold = 16 if t0 else 8
    kw = dict(num_steps=cold, argmax_final=argmax_final, fused_block=fused_block)
    jsmp = JaxSampler(path=JaxPath(t0=t0), jit=False, **kw)
    smp = EulerSampler(path=WarmStartPath(t0=t0), **kw)
    assert (smp.h, smp.nfe, smp.backbone_evals) == (jsmp.h, jsmp.nfe, jsmp.backbone_evals)
    jax_fn, torch_fn = _model_fns(models)
    calls = []

    def counted(x, t):
        calls.append(1)
        return torch_fn(x, t)

    x0 = _x_init(int(10 * t0) + fused_block)
    xj, sj = jsmp.sample(jax.random.key(3), jax_fn, jnp.asarray(x0))
    xt, st = smp.sample(prng.key(3), counted, torch.from_numpy(x0))
    assert isinstance(st, SamplerStats)
    assert st.nfe == int(sj.nfe) == smp.backbone_evals == len(calls)
    assert st.final_t == 1.0
    assert xt.dtype == torch.int32 and xt.shape == (NUM, SEQ)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))


def test_euler_sampler_jit_flag_runs_the_same_loop(models):
    """``jit=True`` (the default) works in the port and changes nothing."""
    _, torch_fn = _model_fns(models)
    x0 = torch.from_numpy(_x_init(5))
    a = EulerSampler(path=WarmStartPath(t0=0.5), num_steps=8).sample(prng.key(1), torch_fn, x0)
    b = EulerSampler(path=WarmStartPath(t0=0.5), num_steps=8, jit=False).sample(
        prng.key(1), torch_fn, x0)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    assert a[1] == b[1] == SamplerStats(nfe=4, final_t=1.0)


def _record_graph_keys(monkeypatch):
    """Replace the graph cache's call with one that records each key and
    runs the loop (on the CPU the cache runs it eagerly anyway): the keys the
    port would capture on the card, and its graphed code path, on the CPU."""
    from repro_torch.graphs import GraphCache

    keys = []

    def call(self, key, fn, *inputs):
        keys.append(key)
        return fn(*inputs)

    monkeypatch.setattr(GraphCache, "__call__", call)
    return keys


@pytest.mark.parametrize("fused_block", [1, 2])
def test_euler_sampler_jit_equals_jit_false_and_jax(models, monkeypatch, fused_block):
    """``jit=True`` goes through the graph cache, keyed by model_fn and
    x_init's shape, dtype and device (JAX's jit cache per model_fn, its jit
    per shape): the same shape shares a key, another shape or model_fn does
    not; its tokens equal ``jit=False``'s and JAX's ``jit=False``'s."""
    keys = _record_graph_keys(monkeypatch)
    jax_fn, torch_fn = _model_fns(models)
    kw = dict(num_steps=8, fused_block=fused_block)
    smp = EulerSampler(path=WarmStartPath(t0=0.5), **kw)
    eager = EulerSampler(path=WarmStartPath(t0=0.5), jit=False, **kw)
    jsmp = JaxSampler(path=JaxPath(t0=0.5), jit=False, **kw)
    x0 = _x_init(7)
    for seed in (1, 2):
        got = smp.sample(prng.key(seed), torch_fn, torch.from_numpy(x0))[0]
        want = eager.sample(prng.key(seed), torch_fn, torch.from_numpy(x0))[0]
        jwant = jsmp.sample(jax.random.key(seed), jax_fn, jnp.asarray(x0))[0]
        assert torch.equal(got, want)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jwant))
    smp.sample(prng.key(3), torch_fn, torch.from_numpy(x0[:2]))
    smp.sample(prng.key(3), lambda x, t: torch_fn(x, t), torch.from_numpy(x0))
    assert len(keys) == 4 and keys[0] == keys[1]
    assert len(set(keys)) == 3 and keys[0][0] is torch_fn
    assert keys[0][1:] == ((NUM, SEQ), torch.int32, torch.device("cpu"))


def _drafts(m, kind):
    """(JAX draft, port draft) of one kind on the same data / weights."""
    data = m["data"]
    if kind is None:
        return None, None
    if kind == "corruption":
        return (jax_draft.CorruptionDraft(data=data, vocab_size=V, corruption=0.3, jitter=2),
                CorruptionDraft(data=data, vocab_size=V, corruption=0.3, jitter=2, device="cpu"))
    if kind == "histogram":
        return (jax_draft.HistogramDraft.fit(data, V),
                HistogramDraft.fit(data, V, device="cpu"))
    return (jax_draft.ARDraft(decode_fn=m["jlstm"].generate, params=m["lparams"], seq_len=SEQ),
            ARDraft(decode_fn=m["lstm"].generate, params=m["tparams"], seq_len=SEQ))


@pytest.mark.parametrize("kind", ["corruption", "histogram", "lstm"])
def test_drafts_match_jax(models, kind):
    jd, td = _drafts(models, kind)
    for seed, num in ((4, NUM), (5, 7)):
        want = np.asarray(jd.generate(jax.random.key(seed), num))
        got = td.generate(prng.key(seed), num)
        assert got.dtype == torch.int32 and got.shape == (num, SEQ)
        np.testing.assert_array_equal(got.numpy(), want)
    assert td.cost_ratio == jd.cost_ratio


def test_histogram_fit_equal(models):
    np.testing.assert_array_equal(HistogramDraft.fit(models["data"], V, 0.5, device="cpu").probs,
                                  jax_draft.HistogramDraft.fit(models["data"], V, 0.5).probs)


@pytest.mark.parametrize("kind,t0", [(None, 0.0), (None, 0.5), ("corruption", 0.8),
                                     ("histogram", 0.7), ("lstm", 0.8)])
def test_pipeline_generate_matches_jax(models, kind, t0):
    jax_fn, torch_fn = _model_fns(models)
    jd, td = _drafts(models, kind)
    jpipe = JaxPipeline(model_fn=jax_fn, draft=jd, path=JaxPath(t0=t0), cold_nfe=COLD_NFE,
                        vocab_size=V, seq_len=SEQ)
    jpipe._sampler = JaxSampler(path=JaxPath(t0=t0), num_steps=COLD_NFE, jit=False)
    pipe = WarmStartPipeline(model_fn=torch_fn, draft=td, path=WarmStartPath(t0=t0),
                             cold_nfe=COLD_NFE, vocab_size=V, seq_len=SEQ, device="cpu")
    for seed in (1, 2):
        xj, rj = jpipe.generate(jax.random.key(seed), NUM)
        xt, rt = pipe.generate(prng.key(seed), NUM)
        assert xt.dtype == torch.int32 and xt.shape == (NUM, SEQ)
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
        assert dataclasses.asdict(rt) == dataclasses.asdict(rj)
    assert pipe.sampler() is pipe.sampler()
    assert pipe.sampler().nfe == rt.warm_nfe


def test_pipeline_charges_the_measured_draft_cost(models):
    """After ``calibrate_cost_ratio`` the report's draft_cost_ratio is the
    measured one (on the CPU here: only the accounting is checked)."""
    _, torch_fn = _model_fns(models)
    _, td = _drafts(models, "lstm")
    path = WarmStartPath(t0=0.8)
    refine = make_refine_step_fn(models["model"], models["model"].cfg, path)
    x = torch.from_numpy(_x_init(1))
    t = torch.full((NUM,), 0.8)
    rep = td.calibrate_cost_ratio(lambda: refine(prng.key(0), x, t, 1 / COLD_NFE),
                                  rng=prng.key(1), num=NUM, seq_len=SEQ, iters=2)
    assert rep.batch == NUM and rep.seq_len == SEQ and rep.iters == 2
    assert rep.cost_ratio == rep.draft_time_s / rep.nfe_time_s > 0
    assert td.cost_ratio == rep.cost_ratio
    pipe = WarmStartPipeline(model_fn=torch_fn, draft=td, path=path, cold_nfe=COLD_NFE,
                             vocab_size=V, seq_len=SEQ, device="cpu")
    _, report = pipe.generate(prng.key(2), NUM)
    assert report.draft_cost_ratio == rep.cost_ratio
    assert report.effective_speedup == COLD_NFE / (report.warm_nfe + rep.cost_ratio)
    direct = measure_cost_ratio(lambda: x, lambda: x, batch=NUM, seq_len=SEQ, iters=1)
    assert direct.as_dict()["iters"] == 1


@pytest.mark.parametrize("bad", ["num_steps", "fused_block"])
def test_guarantee_violation_raised_alike(models, bad):
    """A sampler whose evaluation count is not ``warm_nfe(cold_nfe, t0)``
    fails the gate on both sides: twice the steps, or fused blocks."""
    jax_fn, torch_fn = _model_fns(models)
    kw = ({"num_steps": 2 * COLD_NFE} if bad == "num_steps"
          else {"num_steps": COLD_NFE, "fused_block": 2})
    jpipe = JaxPipeline(model_fn=jax_fn, draft=None, path=JaxPath(t0=0.5), cold_nfe=COLD_NFE,
                        vocab_size=V, seq_len=SEQ)
    jpipe._sampler = JaxSampler(path=JaxPath(t0=0.5), jit=False, **kw)
    pipe = WarmStartPipeline(model_fn=torch_fn, draft=None, path=WarmStartPath(t0=0.5),
                             cold_nfe=COLD_NFE, vocab_size=V, seq_len=SEQ, device="cpu")
    pipe._sampler = EulerSampler(path=WarmStartPath(t0=0.5), **kw)
    with pytest.raises(JaxGuaranteeViolation):
        jpipe.generate(jax.random.key(0), NUM)
    with pytest.raises(GuaranteeViolation):
        pipe.generate(prng.key(0), NUM)


def test_refine_steps_match_jax(models):
    """``make_refine_step`` (params passed in) and ``make_refine_step_fn``
    (the model holds its weights) against JAX's on one step."""
    jm, params, model = models["jm"], models["params"], models["model"]
    x0 = _x_init(8)
    t = np.full((NUM,), 0.75, np.float32)
    h = np.float32(1 / COLD_NFE)
    jstep = jax_make_refine_step(lambda p, x, tt: jm.dfm_apply(p, x, tt), JaxPath(t0=0.75))
    want = np.asarray(jstep(params, jax.random.key(6), jnp.asarray(x0), jnp.asarray(t), h))
    step = make_refine_step(lambda p, x, tt: p.dfm_apply(x, tt), WarmStartPath(t0=0.75))
    args = (prng.key(6), torch.from_numpy(x0), torch.from_numpy(t), torch.tensor(h))
    with torch.no_grad():
        np.testing.assert_array_equal(step(model, *args).numpy(), want)
        jfn = jax_make_refine_step_fn(jm, jm.cfg, JaxPath(t0=0.75))
        want_fn = np.asarray(jfn(params, jax.random.key(6), jnp.asarray(x0), jnp.asarray(t), h))
        np.testing.assert_array_equal(
            make_refine_step_fn(model, model.cfg, WarmStartPath(t0=0.75))(*args).numpy(),
            want_fn)
    with pytest.raises(NotImplementedError):
        make_refine_step_fn(model, model.cfg, WarmStartPath(t0=0.75), extras={"a": 1})


def test_noise_helpers_match_jax():
    np.testing.assert_array_equal(uniform_noise(prng.key(3), (5, 7), V).numpy(),
                                  np.asarray(jax_uniform_noise(jax.random.key(3), (5, 7), V)))
    assert cold_start_path(1e-3) == WarmStartPath(t0=0.0, eps=1e-3)
    m = mask_noise((2, 3), 26)
    assert m.dtype == torch.int32 and m.shape == (2, 3) and bool((m == 26).all())


def test_pipeline_and_drafts_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the default device is usable here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WarmStartPipeline(model_fn=None, draft=None, path=WarmStartPath(), cold_nfe=4,
                          vocab_size=V, seq_len=SEQ)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CorruptionDraft(data=np.zeros((2, 2), np.int32), vocab_size=V)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LSTMModel(LSTMConfig(vocab_size=V, hidden=8)).init(0)
