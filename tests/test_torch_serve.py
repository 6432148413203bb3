"""The port's one-shot serving path against the JAX package's: schedules,
drafts, ``WarmStartServer.serve`` tokens and report counts (with a fixed
draft and with the KV-cached AR draft engine), the guarantee gate, device
defaults, and the import boundary of the port."""

import ast
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _flatten
from repro.configs.dfm_dit import smoke_config as jax_smoke_config
from repro.configs.dfm_dit import tiny_config as jax_tiny_config
from repro.drafting import ARDraftEngine as JaxARDraftEngine
from repro.drafting import TransformerDraftAdapter as JaxTransformerDraftAdapter
from repro.core.paths import WarmStartPath as JaxPath
from repro.core.sampler import refine_schedule as jax_refine_schedule
from repro.kernels.ws_step import make_ws_step_fn as jax_make_ws_step_fn
from repro.models import build_model as jax_build_model
from repro.serving.drafts import (
    corruption_draft as jax_corruption_draft, uniform_draft as jax_uniform_draft,
)
from repro.serving.engine import WarmStartServer as JaxWarmStartServer
from repro_torch import prng
from repro_torch.configs.dfm_dit import smoke_config, tiny_config
from repro_torch.convert import jax_params_to_torch
from repro_torch.core import sampler
from repro_torch.core.guarantees import GuaranteeViolation, require_guarantee, warm_nfe
from repro_torch.core.paths import WarmStartPath
from repro_torch.drafting import ARDraftEngine, TransformerDraftAdapter
from repro_torch.kernels.ws_step import make_ws_step_fn
from repro_torch.models import Model
from repro_torch.serving import WarmStartServer, corruption_draft, uniform_draft

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEQ, NUM, COLD_NFE, T0 = 32, 4, 16, 0.8


@pytest.mark.parametrize("t0,cold_nfe", [(0.8, 16), (0.8, 64), (0.0, 7), (0.55, 10),
                                         (1 - 1e-12, 32), (0.9375, 16)])
def test_refine_schedule_array_equal(t0, cold_nfe):
    n = warm_nfe(cold_nfe, t0)
    ts_j, hs_j = jax_refine_schedule(t0, 1.0 / cold_nfe, n)
    ts_t, hs_t = sampler.refine_schedule(t0, 1.0 / cold_nfe, n)
    np.testing.assert_array_equal(ts_j, ts_t)
    np.testing.assert_array_equal(hs_j, hs_t)
    assert ts_t.dtype == hs_t.dtype == np.float32


def test_refine_loop_inputs_keys_match_jax_split():
    keys, ts, hs = sampler.refine_loop_inputs(prng.key(4), T0, 1 / COLD_NFE, 4)
    want = jax.random.key_data(jax.random.split(jax.random.key(4), 4))
    np.testing.assert_array_equal(keys.numpy(), np.asarray(want).astype(np.int64))
    assert ts.dtype == hs.dtype == torch.float32 and ts.shape == (4,)


def test_drafts_match_jax():
    keys_j = jax.random.split(jax.random.key(21), NUM)
    keys_t = prng.split(prng.key(21), NUM)
    np.testing.assert_array_equal(np.asarray(jax_uniform_draft(27)(keys_j, SEQ)),
                                  uniform_draft(27, device="cpu")(keys_t, SEQ).numpy())
    data = np.random.default_rng(0).integers(0, 27, (9, 40)).astype(np.int32)
    want = jax_corruption_draft(data, 27, corruption=0.3)(keys_j, SEQ)
    got = corruption_draft(data, 27, corruption=0.3, device="cpu")(keys_t, SEQ)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    with pytest.raises(ValueError):
        corruption_draft(data, 27, device="cpu")(keys_t, 41)


@pytest.fixture(scope="module")
def servers_setup():
    jm = jax_build_model(jax_smoke_config())
    params = jm.init(jax.random.key(0))
    model = Model(smoke_config(), device="cpu")
    model.load_state_dict(jax_params_to_torch(_flatten(params)), strict=True)
    draft = np.random.default_rng(3).integers(0, 27, (NUM, SEQ)).astype(np.int32)
    return jm, params, model, draft


@pytest.mark.parametrize("fused_step", [True, False])
def test_serve_matches_jax(servers_setup, fused_step):
    """``fused_step``: ws_step as step_fn (``launch/serve.py --fused-step``,
    the card's main path); otherwise the plain Euler update with
    ``jax.random.gumbel`` noise."""
    jm, params, model, draft = servers_setup
    jpath, path = JaxPath(t0=T0), WarmStartPath(t0=T0)
    jserver = JaxWarmStartServer(
        flow_model=jm, flow_cfg=jm.cfg, flow_params=params,
        draft_generate=lambda rng, num: jnp.asarray(draft), path=jpath, cold_nfe=COLD_NFE,
        step_fn=jax_make_ws_step_fn(jpath) if fused_step else None)
    server = WarmStartServer(
        flow_model=model, flow_cfg=model.cfg,
        draft_generate=lambda rng, num: torch.from_numpy(draft.copy()), path=path,
        cold_nfe=COLD_NFE, step_fn=make_ws_step_fn(path, device="cpu") if fused_step else None,
        device="cpu")
    x_j, rep_j = jserver.serve(jax.random.key(11), NUM)
    x_t, rep_t = server.serve(prng.key(11), NUM)
    np.testing.assert_array_equal(np.asarray(x_j), x_t.numpy())
    for k in ("nfe", "backbone_evals", "cold_nfe", "fused_block"):
        assert rep_t[k] == rep_j[k]
    assert rep_t["nfe"] == rep_t["backbone_evals"] == 4
    assert set(rep_t) == set(rep_j)
    assert rep_t["speedup_report"].warm_nfe == rep_j["speedup_report"].warm_nfe


@pytest.mark.parametrize("fused_block", [1, 2])
def test_serve_refine_graph_keys_and_eager_path(servers_setup, monkeypatch, fused_block):
    """The refine goes through the graph cache keyed (num, seq_len,
    n_steps, fused_block), as JAX jits the loop per shape: repeated serves
    share a key, another num does not; the graphed path equals the eager
    yardstick and JAX's serve."""
    from repro_torch.graphs import GraphCache

    jm, params, model, draft = servers_setup
    keys = []

    def call(self, key, fn, *inputs):
        keys.append(key)
        return fn(*inputs)

    monkeypatch.setattr(GraphCache, "__call__", call)
    path = WarmStartPath(t0=T0)
    server = WarmStartServer(
        flow_model=model, flow_cfg=model.cfg, fused_block=fused_block,
        draft_generate=lambda rng, num: torch.from_numpy(draft[:num].copy()), path=path,
        cold_nfe=COLD_NFE, device="cpu")
    if fused_block == 1:
        jserver = JaxWarmStartServer(
            flow_model=jm, flow_cfg=jm.cfg, flow_params=params, path=JaxPath(t0=T0),
            draft_generate=lambda rng, num: jnp.asarray(draft[:num]), cold_nfe=COLD_NFE)
        np.testing.assert_array_equal(np.asarray(jserver.serve(jax.random.key(11), NUM)[0]),
                                      server.serve(prng.key(11), NUM)[0].numpy())
    else:
        server.serve(prng.key(11), NUM)
    server.serve(prng.key(12), NUM)
    server.serve(prng.key(13), NUM - 1)
    n = warm_nfe(COLD_NFE, T0)
    assert keys == [(NUM, SEQ, n, fused_block)] * 2 + [(NUM - 1, SEQ, n, fused_block)]
    rk, ts, hs = sampler.refine_loop_inputs(prng.key(14), T0, 1 / COLD_NFE, n)
    x0 = torch.from_numpy(draft.copy())
    with torch.inference_mode():
        assert torch.equal(server._refine_loop(rk, x0, ts, hs),
                           server._refine_loop_eager(rk, x0, ts, hs))


def test_serve_with_row_keyed_draft_and_argmax_final(servers_setup):
    _, _, model, _ = servers_setup
    draft = uniform_draft(27, device="cpu")
    server = WarmStartServer(
        flow_model=model, flow_cfg=model.cfg,
        draft_generate=lambda rng, num: draft(prng.split(rng, num), SEQ),
        path=WarmStartPath(t0=T0), cold_nfe=COLD_NFE, device="cpu")
    x, rep = server.serve(prng.key(0), NUM)
    assert x.shape == (NUM, SEQ) and x.dtype == torch.int32
    assert int(x.min()) >= 0 and int(x.max()) < 27
    assert rep["nfe"] == warm_nfe(COLD_NFE, T0)
    # argmax_final: the last step is the backbone's argmax
    keys, ts, hs = sampler.refine_loop_inputs(prng.key(1), T0, 1 / COLD_NFE, 2)
    x0 = draft(prng.split(prng.key(2), 2), SEQ)
    with torch.no_grad():
        out = sampler.scan_refine_loop(model.dfm_apply, sampler.make_euler_one_step(
            WarmStartPath(t0=T0)), x0, keys, ts, hs, argmax_final=True)
        one = sampler.scan_refine_loop(model.dfm_apply, sampler.make_euler_one_step(
            WarmStartPath(t0=T0)), x0, keys[:1], ts[:1], hs[:1])
        last = torch.argmax(model.dfm_apply(one, ts[1].expand(2)), -1).to(torch.int32)
    torch.testing.assert_close(out, last)


def test_serve_with_ar_draft_matches_jax(servers_setup):
    """The paper's pipeline: a 2-layer causal transformer drafts each row
    after a shared 3-token prompt (KV-cached engine, draft kernels' plain
    versions here), then the DiT refines. Three serves: tokens equal JAX's,
    report counts equal, the prefix is computed once and reused twice."""
    jm, params, model, _ = servers_setup
    kw = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=2, d_ff=64)
    jdm = jax_build_model(jax_tiny_config().replace(**kw))
    dparams = jdm.init(jax.random.key(1))
    dmodel = Model(tiny_config().replace(**kw), device="cpu")
    dmodel.load_state_dict(jax_params_to_torch(_flatten(dparams)), strict=True)
    prompt = np.tile(np.random.default_rng(2).integers(0, 27, 3).astype(np.int32), (NUM, 1))
    max_len = 3 + SEQ - 1
    jeng = JaxARDraftEngine(JaxTransformerDraftAdapter(model=jdm), dparams, max_len=max_len)
    eng = ARDraftEngine(TransformerDraftAdapter(model=dmodel, decode_impl="kernel"),
                        max_len=max_len)
    jpath, path = JaxPath(t0=T0), WarmStartPath(t0=T0)
    jserver = JaxWarmStartServer(
        flow_model=jm, flow_cfg=jm.cfg, flow_params=params,
        draft_generate=lambda rng, num: jeng.generate_rows(
            jax.random.split(rng, num), SEQ, prompt=jnp.asarray(prompt)),
        path=jpath, cold_nfe=COLD_NFE, step_fn=jax_make_ws_step_fn(jpath))
    server = WarmStartServer(
        flow_model=model, flow_cfg=model.cfg,
        draft_generate=lambda rng, num: eng.generate_rows(
            prng.split(rng, num), SEQ, prompt=torch.from_numpy(prompt)),
        path=path, cold_nfe=COLD_NFE, step_fn=make_ws_step_fn(path, device="cpu"),
        device="cpu")
    for seed in (11, 12, 13):
        x_j, rep_j = jserver.serve(jax.random.key(seed), NUM)
        x_t, rep_t = server.serve(prng.key(seed), NUM)
        np.testing.assert_array_equal(np.asarray(x_j), x_t.numpy())
        for k in ("nfe", "backbone_evals", "cold_nfe", "fused_block"):
            assert rep_t[k] == rep_j[k]
    assert eng.stats.as_dict() == jeng.stats.as_dict() == {
        "prefill_computes": 1, "prefill_reuses": 2, "decode_dispatches": 3,
        "tokens_generated": 3 * NUM * SEQ}


def test_guarantee_violation_on_wrong_count(servers_setup, monkeypatch):
    with pytest.raises(GuaranteeViolation):
        require_guarantee(COLD_NFE, T0, warm_nfe(COLD_NFE, T0) + 1)
    require_guarantee(COLD_NFE, T0, 4)
    _, _, model, draft = servers_setup
    server = WarmStartServer(
        flow_model=model, flow_cfg=model.cfg,
        draft_generate=lambda rng, num: torch.from_numpy(draft.copy()),
        path=WarmStartPath(t0=T0), cold_nfe=COLD_NFE, device="cpu")
    # a loop that takes one step fewer than guaranteed must trip the gate
    from repro_torch.core import guarantees
    from repro_torch.serving import engine
    monkeypatch.setattr(engine, "guarantees", types.SimpleNamespace(
        warm_nfe=lambda c, t: guarantees.warm_nfe(c, t) - 1,
        require_guarantee=guarantees.require_guarantee,
        speedup_report=guarantees.speedup_report))
    with pytest.raises(GuaranteeViolation):
        server.serve(prng.key(0), NUM)


def test_fused_block_is_not_ported(servers_setup):
    """Ported since the scheduler slice: ``fused_block = 2`` serves through
    ``ws_fused`` and equals the JAX server's tokens and counts (the name is
    the one this test had when the kernel was missing)."""
    jm, params, model, draft = servers_setup
    jpath, path = JaxPath(t0=T0), WarmStartPath(t0=T0)
    jserver = JaxWarmStartServer(
        flow_model=jm, flow_cfg=jm.cfg, flow_params=params,
        draft_generate=lambda rng, num: jnp.asarray(draft), path=jpath, cold_nfe=COLD_NFE,
        fused_block=2)
    server = WarmStartServer(flow_model=model, flow_cfg=model.cfg,
                             draft_generate=lambda rng, num: torch.from_numpy(draft.copy()),
                             path=path, cold_nfe=COLD_NFE, fused_block=2, device="cpu")
    x_j, rep_j = jserver.serve(jax.random.key(12), NUM)
    x_t, rep_t = server.serve(prng.key(12), NUM)
    np.testing.assert_array_equal(np.asarray(x_j), x_t.numpy())
    assert (rep_t["nfe"], rep_t["backbone_evals"]) == (rep_j["nfe"], rep_j["backbone_evals"])
    assert (rep_t["nfe"], rep_t["backbone_evals"]) == (4, 2)
    with pytest.raises(ValueError, match="fused_fn"):
        sampler.scan_refine_loop(None, None, torch.zeros(1, 2), None, torch.zeros(2),
                                 torch.zeros(2), fused_block=2)


def test_entry_points_default_to_cuda_and_raise_without_it(servers_setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    _, _, model, draft = servers_setup
    path = WarmStartPath(t0=T0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(smoke_config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_ws_step_fn(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        uniform_draft(27)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WarmStartServer(flow_model=model, flow_cfg=model.cfg,
                        draft_generate=lambda rng, num: torch.from_numpy(draft),
                        path=path, cold_nfe=COLD_NFE)


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    assert [f.name for f in examples] == [
        "image_refinement_torch.py", "quickstart_torch.py", "serve_pipeline_torch.py",
        "text_generation_torch.py"]
    package = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files = package + examples + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    walked = {f.relative_to(ROOT / "src" / "repro_torch").as_posix() for f in package}
    assert {"data/__init__.py", "data/moons.py", "data/images.py", "data/text.py",
            "models/lstm.py", "core/draft.py", "core/pipeline.py",
            "drafting/quality.py", "core/losses.py", "core/coupling.py",
            "optim/adamw.py", "optim/adafactor.py", "optim/schedule.py",
            "training/state.py", "training/train_step.py", "training/trainer.py",
            "checkpoint/io.py", "launch/train.py", "configs/__init__.py",
            "drafting/policy.py", "drafting/bandit.py", "graphs.py",
            "drafting/distill.py", "obs/export.py", "launch/serve.py",
            "configs/starcoder2_3b.py", "configs/minitron_4b.py",
            "configs/command_r_plus_104b.py", "configs/gemma3_1b.py",
            "configs/zamba2_2_7b.py", "configs/xlstm_1_3b.py", "models/ssm.py",
            "models/xlstm.py", "configs/whisper_medium.py", "models/encdec.py"} <= walked
    offenders = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "repro"):
                offenders.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not offenders, offenders
