"""The port's drafting policies against the JAX package's on the CPU: the
quality probe (single- and multi-time) on the smoke DiT, the corruption-tier
t0 calibration, ``bin_t0``, ``AdaptiveT0Policy`` and ``BanditT0Policy``
(selection, rewards, arm tables and snapshots restored across the two
packages), the split masked per-row refine loop against the loop it
replaced, and the LSTM draft's graph yardstick.

Tolerances: probe scores and calibration anchor scores within 1e-5 abs
(float32 backbones that sum in another order); everything else exact: the
anchors' t0s, binned t0s, arm choices, counts, values, snapshots, tokens.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.drafting as JD
import repro_torch.drafting as TD
from repro.checkpoint.io import _flatten
from repro.configs.dfm_dit import smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro_torch import prng
from repro_torch.configs.dfm_dit import smoke_config
from repro_torch.convert import jax_params_to_torch
from repro_torch.core.paths import WarmStartPath
from repro_torch.core.sampler import (
    _pad_blocks, make_euler_one_step_rows, refine_schedule_rows, scan_refine_loop_rows,
)
from repro_torch.kernels.ws_fused import make_ws_fused_fn
from repro_torch.models import LSTMConfig, LSTMModel, Model

SCORE_TOL = 1e-5


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
def dit():
    jm = jax_build_model(jax_smoke_config())
    params = jm.init(jax.random.key(0))
    model = Model(smoke_config(), device="cpu")
    model.load_state_dict(jax_params_to_torch(_flatten(params)), strict=True)
    return jm, params, model


def tokens(b, n, seed, vocab=27):
    return np.random.default_rng(seed).integers(0, vocab, (b, n)).astype(np.int32)


# -- the probe and the calibration ----------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(t_probe=0.3, temperature=0.7),
                                dict(probe_times=(0.3, 0.5, 0.7))])
def test_quality_scorer_matches_jax(dit, kw):
    jm, params, model = dit
    jscore = JD.make_quality_scorer(jm.dfm_apply, params, **kw)
    tscore = TD.make_quality_scorer(model.dfm_apply, device="cpu", **kw)
    for b, n, seed in ((3, 16, 0), (5, 9, 1)):
        x = tokens(b, n, seed)
        want = np.asarray(jscore(x))
        got = tscore(x)
        assert got.dtype == torch.float32 and tuple(got.shape) == (b,)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SCORE_TOL)
        np.testing.assert_allclose(tscore(torch.from_numpy(x)).numpy(), want, rtol=0,
                                   atol=SCORE_TOL)


@pytest.mark.parametrize("kw", [dict(probe_times=()), dict(probe_times=(0.3, 1.0)),
                                dict(t_probe=0.0)])
def test_quality_scorer_refuses_what_jax_refuses(dit, kw):
    jm, params, model = dit
    msgs = []
    for fn in (lambda: JD.make_quality_scorer(jm.dfm_apply, params, **kw),
               lambda: TD.make_quality_scorer(model.dfm_apply, device="cpu", **kw)):
        with pytest.raises(ValueError) as err:
            fn()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("probe_times", [None, (0.3, 0.5, 0.7)])
def test_fit_t0_calibration_matches_jax(dit, probe_times):
    jm, params, model = dit
    data = tokens(40, 16, 7)
    kw = dict(num_per_tier=6, seed=3)
    jcal = JD.fit_t0_calibration(
        JD.make_quality_scorer(jm.dfm_apply, params, probe_times=probe_times), data, 27, **kw)
    tcal = TD.fit_t0_calibration(
        TD.make_quality_scorer(model.dfm_apply, probe_times=probe_times, device="cpu"), data,
        27, device="cpu", **kw)
    assert tcal.t0s == jcal.t0s
    assert (tcal.t0_floor, tcal.t0_ceil) == (jcal.t0_floor, jcal.t0_ceil)
    np.testing.assert_allclose(tcal.scores, jcal.scores, rtol=0, atol=SCORE_TOL)
    s = np.linspace(-4.0, -2.0, 41)
    np.testing.assert_array_equal(
        TD.T0Calibration(jcal.scores, jcal.t0s, jcal.t0_floor, jcal.t0_ceil).t0_for_scores(s),
        jcal.t0_for_scores(s))


@pytest.mark.parametrize("args", [((0.1,), (0.5,)), ((0.2, 0.1), (0.5, 0.9)),
                                  ((0.1, 0.2), (0.5, 0.9), 0.5, 1.0)])
def test_t0_calibration_refuses_what_jax_refuses(args):
    msgs = []
    for C in (JD.T0Calibration, TD.T0Calibration):
        with pytest.raises(ValueError) as err:
            C(*args)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# -- bin_t0 and the calibrated policy -------------------------------------------------

def bin_cases():
    """The edge cases of the JAX suite (tests/test_adaptive_t0.py): plain
    snaps, the floor clamp, grid points at small widths, t0 near 1."""
    cases = [(0.87, 0.1, 0.0), (0.8, 0.1, 0.0), (0.55, 0.1, 0.5), (0.3, 0.1, 0.5),
             (0.87, 0.0, 0.0), (0.3 + 5011 * 1e-4, 1e-4, 0.3)]
    for floor in (0.0, 0.3, 0.5):
        for width in (1e-4, 1e-3, 0.05, 0.1):
            for k in (1, 7, 5011, 4999):
                t0 = floor + k * width
                if 0.0 <= t0 < 1.0:
                    cases.append((t0, width, floor))
    cases += [(1.0 - 1e-12, w, 0.0) for w in (0.05, 0.1, 0.25)]
    return cases


def test_bin_t0_equals_jax_bit_for_bit():
    for t0, width, floor in bin_cases():
        got = TD.bin_t0(t0, width=width, floor=floor)
        want = JD.bin_t0(t0, width=width, floor=floor)
        assert got == want and TD.bin_t0(got, width=width, floor=floor) == \
            JD.bin_t0(want, width=width, floor=floor), (t0, width, floor)


def jax_scorer(toks):
    return jnp.asarray(toks, jnp.float32).mean(axis=-1) / 10.0


def torch_scorer(toks):
    return torch.as_tensor(np.asarray(toks)).float().mean(dim=-1) / 10.0


CAL = dict(scores=(0.1, 0.9), t0s=(0.5, 0.9), t0_floor=0.5, t0_ceil=0.9)


def test_adaptive_policy_matches_jax():
    toks = tokens(16, 8, 2, vocab=11)
    pols = [P.AdaptiveT0Policy(scorer=s, calibration=C(**CAL), bin_width=0.1, t0_floor=0.55)
            for P, C, s in ((JD, JD.T0Calibration, jax_scorer),
                            (TD, TD.T0Calibration, torch_scorer))]
    (js, jt), (ts, tt) = (p.scores_and_t0(toks) for p in pols)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tt, jt)
    assert pols[1].t0_for_request(toks) == pols[0].t0_for_request(toks)


# -- the bandit -----------------------------------------------------------------------

def bandits(**kw):
    kw.setdefault("bin_width", 0.1)
    return (JD.BanditT0Policy(scorer=jax_scorer, calibration=JD.T0Calibration(**CAL), **kw),
            TD.BanditT0Policy(scorer=torch_scorer, calibration=TD.T0Calibration(**CAL), **kw))


def drive(pol, rounds=4):
    """A fixed sequence of selections, rewards and accepts; the arms chosen."""
    scores = np.linspace(0.05, 0.95, 12)
    chosen = []
    for i in range(rounds):
        t0s = pol.select(8 * (1 + i % 2), scores)
        chosen.append(t0s.tolist())
        for s, t0 in zip(scores, t0s):
            pol.update(8 * (1 + i % 2), float(s), float(t0),
                       quality_score=float(0.2 + 0.7 * s), cost_norm=float(t0) / 2)
        pol.observe_accept(8, 0.9)
    return chosen


@pytest.mark.parametrize("kw", [dict(), dict(exploration="epsilon", epsilon=0.3, seed=7),
                                dict(exploration="epsilon", epsilon=0.0, cost_weight=0.2),
                                dict(ucb_c=1.5, prior_weight=1.0, accept_score=0.4)])
def test_bandit_matches_jax(kw):
    jb, tb = bandits(**kw)
    assert drive(tb) == drive(jb)
    assert tb.arm_stats() == jb.arm_stats()
    assert json.dumps(tb.snapshot()) == json.dumps(jb.snapshot())
    assert tb.accept_score == jb.accept_score
    toks = tokens(6, 8, 3, vocab=11)
    (js, jt), (ts, tt) = jb.scores_and_t0(toks), tb.scores_and_t0(toks)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tt, jt)
    assert tb.reward(quality_score=0.6, cost_norm=0.3) == \
        jb.reward(quality_score=0.6, cost_norm=0.3)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_bandit_snapshot_restores_across_packages(direction):
    """A snapshot (through JSON) from either package restores in the other:
    the arm table equals, and the exploration RNG stream goes on alike."""
    kw = dict(exploration="epsilon", epsilon=0.3, seed=7)
    jb, tb = bandits(**kw)
    src = jb if direction == "jax_to_port" else tb
    drive(src)
    snap = json.loads(json.dumps(src.snapshot()))
    jfresh, tfresh = bandits(exploration="epsilon", epsilon=0.3, seed=999)
    dst = tfresh if direction == "jax_to_port" else jfresh
    dst.restore(snap)
    assert dst.arm_stats() == src.arm_stats()
    scores = np.linspace(0.1, 0.9, 16)
    np.testing.assert_array_equal(dst.select(8, scores), src.select(8, scores))
    assert dst.snapshot() == src.snapshot()


def test_bandit_refusals_match_jax():
    for kw in (dict(exploration="thompson"), dict(bin_width=0.0), dict(epsilon=1.5)):
        msgs = []
        for B, C, s in ((JD.BanditT0Policy, JD.T0Calibration, jax_scorer),
                        (TD.BanditT0Policy, TD.T0Calibration, torch_scorer)):
            with pytest.raises(ValueError) as err:
                B(scorer=s, calibration=C(**CAL), **kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    jb, tb = bandits()
    for dst in (jb, tb):
        with pytest.raises(ValueError, match="version"):
            dst.restore(dict(tb.snapshot(), version=99))
        with pytest.raises(ValueError, match="grid"):
            dst.restore(dict(tb.snapshot(), bin_width=0.05))


def test_bandit_metrics_match_jax():
    from repro.obs import MetricsRegistry as JaxRegistry
    from repro_torch.obs import MetricsRegistry

    (jb, tb), regs = bandits(), (JaxRegistry(), MetricsRegistry())
    jb.bind_metrics(regs[0])
    tb.bind_metrics(regs[1])
    drive(jb, 2)
    drive(tb, 2)
    assert regs[1].snapshot() == regs[0].snapshot()


# -- the split per-row refine loop ----------------------------------------------------

def old_scan_refine_loop_rows(logits_fn, one_step, x_init, flow_keys, ts, hs, active,
                              key_idx, *, fused_block=1, fused_fn=None):
    """The loop as it was before its split (host branch on ``act[i].all()``)."""
    dev = x_init.device
    fk = prng.key_data(flow_keys).cpu()
    ts = torch.as_tensor(np.asarray(ts), dtype=torch.float32)
    hs = torch.as_tensor(np.asarray(hs), dtype=torch.float32)
    key_idx = torch.as_tensor(np.asarray(key_idx), dtype=torch.int64)
    n = ts.shape[0]
    x = x_init
    if fused_block > 1:
        k = min(fused_block, n)
        nb = -(-n // k)
        bts = _pad_blocks(ts, nb * k, n, 1.0).reshape((nb, k) + tuple(ts.shape[1:])).to(dev)
        bhs = _pad_blocks(hs, nb * k, n, 0.0).reshape((nb, k) + tuple(hs.shape[1:])).to(dev)
        bidx = _pad_blocks(key_idx, nb * k, n, 0).reshape((nb, k) + tuple(key_idx.shape[1:]))
        bkeys = prng.fold_in(fk[None, None], bidx).to(dev)
        for i in range(nb):
            logits = logits_fn(x, bts[i, 0])
            x = fused_fn(bkeys[i], logits, x, bts[i], bhs[i])
        return x
    act = np.asarray(active, dtype=bool)
    step_keys = prng.fold_in(fk[None], key_idx).to(dev)
    ts, hs = ts.to(dev), hs.to(dev)
    act_d = torch.as_tensor(act).to(dev)
    for i in range(n):
        logits = logits_fn(x, ts[i])
        x_next = one_step(step_keys[i], logits, x, ts[i], hs[i])
        x = x_next if act[i].all() else torch.where(act_d[i][:, None], x_next, x)
    return x


@pytest.mark.parametrize("fused_block", [1, 2, 3])
@pytest.mark.parametrize("row_t0s", [(0.8, 0.8, 0.8, 0.8), (0.5, 0.8, 0.85, 0.9)])
def test_split_refine_loop_equals_the_old_one(dit, fused_block, row_t0s):
    _, _, model = dit
    path = WarmStartPath(t0=0.0)
    one_step = make_euler_one_step_rows(path)
    fused_fn = make_ws_fused_fn(path) if fused_block > 1 else None
    x0 = torch.from_numpy(tokens(4, 16, 5))
    flow_keys = prng.split(prng.key(11), 4)
    sched = refine_schedule_rows(row_t0s, 1.0 / 20, 20)[:4]
    with torch.no_grad():
        got = scan_refine_loop_rows(model.dfm_apply, one_step, x0, flow_keys, *sched,
                                    fused_block=fused_block, fused_fn=fused_fn)
        want = old_scan_refine_loop_rows(model.dfm_apply, one_step, x0, flow_keys, *sched,
                                         fused_block=fused_block, fused_fn=fused_fn)
    assert torch.equal(got, want)


# -- the LSTM draft -------------------------------------------------------------------

def test_lstm_generate_equals_its_eager_yardstick_and_jax():
    from repro.models.lstm import LSTMConfig as JaxLSTMConfig
    from repro.models.lstm import LSTMModel as JaxLSTMModel
    from repro_torch.convert import jax_lstm_params_to_torch

    cfg = dict(vocab_size=11, hidden=16, num_layers=2, embed_dim=8)
    jm = JaxLSTMModel(JaxLSTMConfig(**cfg))
    jp = jm.init(jax.random.key(0))
    tm = LSTMModel(LSTMConfig(**cfg))
    tp = jax_lstm_params_to_torch(_flatten(jp), device="cpu")
    for temperature, bos in ((1.0, 0), (0.7, 3)):
        got = tm.generate(tp, prng.key(4), 3, 12, temperature, bos)
        assert torch.equal(got, tm._generate_eager(tp, prng.key(4), 3, 12, temperature, bos))
        want = np.asarray(jm.generate(jp, jax.random.key(4), 3, 12, temperature, bos))
        np.testing.assert_array_equal(got.numpy(), want)
    assert len(tm.graphs) == 0          # the CPU runs the loop eagerly
