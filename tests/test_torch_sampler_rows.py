"""The port's row-keyed sampler against the JAX package's: per-row
schedules (array-equal), the row-keyed Euler step (the ``ws_step``
per-row mode's plain version), and the masked per-row refine loop at
``fused_block`` K = 1, 2, 3 on the smoke DiT, plus the one-shot server at
K = 3.

Tolerance: tokens equal. The plain per-row step computes what JAX's
``make_euler_one_step_rows`` computes, op for op, and the K > 1 loops go
through ``ws_fused``'s plain version against the TPU kernel in interpret
mode; a disagreement could only come from a near tie between two scores
(the two packages' ``log`` may differ by one ulp), which these seeded
inputs do not meet."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _flatten
from repro.configs.dfm_dit import smoke_config as jax_smoke_config
from repro.core import sampler as jsampler
from repro.core.paths import WarmStartPath as JaxPath
from repro.kernels import make_ws_fused_fn as jax_make_ws_fused_fn
from repro.models import build_model as jax_build_model
from repro.serving.engine import WarmStartServer as JaxWarmStartServer
from repro_torch import prng
from repro_torch.configs.dfm_dit import smoke_config
from repro_torch.convert import jax_params_to_torch
from repro_torch.core import sampler
from repro_torch.core.paths import WarmStartPath
from repro_torch.kernels import make_ws_fused_fn
from repro_torch.kernels.ws_step import ws_step_rows
from repro_torch.models import Model
from repro_torch.serving import WarmStartServer

T0_SETS = [[0.8], [0.8, 0.8, 0.8], [0.5, 0.8, 0.9, 0.8], [0.0, 0.99, 0.55],
           [0.75, 0.8125, 0.9375]]


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread for these smoke-size models: the suite runs in
    several worker processes at once, where torch's default of a thread a
    core makes each small op wait on the others' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("t0_rows", T0_SETS)
@pytest.mark.parametrize("cold_nfe", [16, 20])
def test_refine_schedule_rows_array_equal(t0_rows, cold_nfe):
    for want, got in zip(jsampler.refine_schedule_rows(t0_rows, 1.0 / cold_nfe, cold_nfe),
                         sampler.refine_schedule_rows(t0_rows, 1.0 / cold_nfe, cold_nfe)):
        assert want.dtype == got.dtype
        np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("t0_rows", T0_SETS)
@pytest.mark.parametrize("k", [1, 2])
def test_distill_schedule_rows_array_equal(t0_rows, k):
    for want, got in zip(jsampler.distill_schedule_rows(t0_rows, k),
                         sampler.distill_schedule_rows(t0_rows, k)):
        assert want.dtype == got.dtype
        np.testing.assert_array_equal(want, got)


def test_schedule_validation_matches_jax():
    for fn, args in ((sampler.refine_schedule_rows, ([[0.5]], 0.1, 10)),
                     (sampler.distill_schedule_rows, ([0.5], 0)),
                     (sampler.distill_schedule_rows, ([1.0], 1))):
        with pytest.raises(ValueError):
            fn(*args)


@pytest.mark.parametrize("v", [5, 27, 300])
def test_row_keyed_step_matches_jax(v):
    b, n = 4, 9
    rng = np.random.default_rng(v)
    logits = (3 * rng.standard_normal((b, n, v))).astype(np.float32)
    x = rng.integers(0, v, (b, n)).astype(np.int32)
    t = np.array([0.5, 0.8, 0.85, 0.9], np.float32)
    h = np.array([1 / 16, 1 / 16, 0.0, 1 / 16], np.float32)
    jk, tk = jax.random.split(jax.random.key(v), b), prng.split(prng.key(v), b)
    want = jsampler.make_euler_one_step_rows(JaxPath(0.0))(
        jk, jnp.asarray(logits), jnp.asarray(x), jnp.asarray(t), jnp.asarray(h))
    got = sampler.make_euler_one_step_rows(WarmStartPath(0.0))(
        tk, torch.from_numpy(logits), torch.from_numpy(x), torch.from_numpy(t),
        torch.from_numpy(h))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    np.testing.assert_array_equal(got[2].numpy(), x[2])              # h = 0: frozen
    probs = sampler.euler_step_probs(torch.from_numpy(logits), torch.from_numpy(x),
                                     torch.from_numpy(t), torch.from_numpy(h),
                                     WarmStartPath(0.0))
    np.testing.assert_array_equal(
        np.asarray(jsampler.categorical_from_probs_rows(jk, jnp.asarray(probs.numpy()))),
        sampler.categorical_from_probs_rows(tk, probs).numpy())


def test_row_keyed_step_refuses_2_pow_32_noise_elements():
    logits = torch.zeros(1).expand(1, 1 << 16, 1 << 16)
    with pytest.raises(NotImplementedError, match="2\\*\\*32"):
        ws_step_rows(prng.split(prng.key(0), 1), logits, torch.zeros(1, 1 << 16), 0.5, 0.1,
                     WarmStartPath(0.0))


@pytest.fixture(scope="module")
def dit():
    jm = jax_build_model(jax_smoke_config())
    params = jm.init(jax.random.key(0))
    model = Model(smoke_config(), device="cpu")
    model.load_state_dict(jax_params_to_torch(_flatten(params)), strict=True)
    return jm, params, model


@pytest.mark.parametrize("k", [1, 2, 3])
def test_scan_refine_loop_rows_matches_jax(dit, k):
    """Rows at t0 0.5 / 0.8 / 0.9 (8, 4 and 2 steps of cold_nfe 16): a
    masked loop whose rows enter at their own step, keyed per row."""
    jm, params, model = dit
    b, n, cold = 3, 16, 16
    x = np.random.default_rng(k).integers(0, 27, (b, n)).astype(np.int32)
    ts, hs, active, key_idx, nfe_rows = jsampler.refine_schedule_rows(
        [0.5, 0.8, 0.9], 1.0 / cold, cold)
    assert list(nfe_rows) == [8, 4, 2]
    jkeys = jax.random.split(jax.random.key(7), b)
    tkeys = prng.split(prng.key(7), b)
    want = jsampler.scan_refine_loop_rows(
        lambda xt, tb: jm.dfm_apply(params, xt, tb),
        jsampler.make_euler_one_step_rows(JaxPath(0.0)), jnp.asarray(x), jkeys,
        jnp.asarray(ts), jnp.asarray(hs), jnp.asarray(active), jnp.asarray(key_idx),
        fused_block=k,
        fused_fn=jax_make_ws_fused_fn(JaxPath(0.0), interpret=True) if k > 1 else None)
    with torch.inference_mode():
        got = sampler.scan_refine_loop_rows(
            model.dfm_apply, sampler.make_euler_one_step_rows(WarmStartPath(0.0)),
            torch.from_numpy(x), tkeys, ts, hs, active, key_idx, fused_block=k,
            fused_fn=make_ws_fused_fn(WarmStartPath(0.0)) if k > 1 else None)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_server_fused_block_3_matches_jax(dit):
    jm, params, model = dit
    draft = np.random.default_rng(3).integers(0, 27, (2, 16)).astype(np.int32)
    jserver = JaxWarmStartServer(
        flow_model=jm, flow_cfg=jm.cfg, flow_params=params,
        draft_generate=lambda rng, num: jnp.asarray(draft), path=JaxPath(t0=0.5), cold_nfe=14,
        fused_block=3)
    server = WarmStartServer(flow_model=model, flow_cfg=model.cfg,
                             draft_generate=lambda rng, num: torch.from_numpy(draft.copy()),
                             path=WarmStartPath(t0=0.5), cold_nfe=14, fused_block=3,
                             device="cpu")
    x_j, rep_j = jserver.serve(jax.random.key(4), 2)
    x_t, rep_t = server.serve(prng.key(4), 2)
    np.testing.assert_array_equal(np.asarray(x_j), x_t.numpy())
    assert (rep_t["nfe"], rep_t["backbone_evals"]) == (rep_j["nfe"], rep_j["backbone_evals"]) \
        == (7, 3)
