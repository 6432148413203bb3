"""The port's scheduler in its policy modes against the JAX package's on the
CPU: the adaptive-t0 scoring pre-pass, ``per_row_t0``, ``speculative``
accept/reject and the bandit, through ``serve_requests`` and
``serve_stream`` (on a fake stream clock), on the same requests. Tokens,
t0s, per-row t0s, NFE, micro-batches and every report section are equal
(host timings left out); the JAX suite's invariants (``tests/test_adaptive_t0.py``,
``tests/test_speculative.py``) hold on the port.

The flow is a gather, the drafts the packages' ``uniform_draft`` (equal bit
for bit) and the probe a fixed function of the tokens (the mean token over
10, exact in float32 at these lengths), so the scores, and with them every
t0 and accept decision, are equal. The bandit's rewards are priced by the
cost model's measured seconds: both sides get the same fixed price
(``cost_for_nfe``) so their arms learn alike. One test runs the smoke DiT's
own probe (``make_quality_scorer``) on both sides. Tolerance: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.drafting as JD
import repro.serving as J
import repro_torch.drafting as TD
import repro_torch.serving as T
from repro.checkpoint.io import _flatten
from repro.configs.dfm_dit import smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro_torch.configs.dfm_dit import smoke_config
from repro_torch.convert import jax_params_to_torch
from repro_torch.core.guarantees import warm_nfe
from repro_torch.models import Model

V = 11
W = (2.0 * np.random.default_rng(1).standard_normal((V, V))).astype(np.float32)
HOST_TIMING = {"draft_time_s", "flow_time_s", "wall_time_s", "overlap_efficiency",
               "requests_per_s", "samples_per_s", "prepass_time_s"}
PKG = {J: JD, T: TD}


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread for these smoke-size models: the suite runs in
    several worker processes at once, where torch's default of a thread a
    core makes each small op wait on the others' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class JaxGatherFlow:
    def dfm_apply(self, params, x, t, extras=None):
        return jnp.asarray(W)[x] * (1.0 + t)[:, None, None]


class TorchGatherFlow:
    device = torch.device("cpu")

    def dfm_apply(self, x, t):
        return torch.from_numpy(W)[x.long()] * (1.0 + t)[:, None, None]


class FakeClock:
    def __init__(self):
        self.t, self.sleeps = 0.0, []

    def time(self):
        return self.t

    def sleep(self, dt):
        self.sleeps.append(dt)
        self.t += dt


def jax_scorer(toks):
    return jnp.asarray(toks, jnp.float32).mean(axis=-1) / 10.0


def torch_scorer(toks):
    toks = toks if isinstance(toks, torch.Tensor) else torch.from_numpy(np.asarray(toks))
    return toks.float().mean(dim=-1) / 10.0


SCORER = {J: jax_scorer, T: torch_scorer}


def calib(S):
    return PKG[S].T0Calibration(scores=(0.1, 0.9), t0s=(0.5, 0.9), t0_floor=0.5, t0_ceil=0.9)


def policy(S, bin_width=0.1):
    return PKG[S].AdaptiveT0Policy(scorer=SCORER[S], calibration=calib(S), bin_width=bin_width)


def bandit(S, **kw):
    kw.setdefault("bin_width", 0.1)
    return PKG[S].BanditT0Policy(scorer=SCORER[S], calibration=calib(S), **kw)


def fixed_price(nfe, key=None):
    """The cost model's price of ``nfe`` steps, pinned: 10 ms a step."""
    return 0.01 * nfe


def make(S, draft_fn=None, **kw):
    kw = {"cold_nfe": 20, "default_t0": 0.8, **kw}
    if S is J:
        sched = J.WarmStartScheduler(flow_model=JaxGatherFlow(), flow_params={},
                                     draft_fn=draft_fn or J.uniform_draft(V), **kw)
    else:
        sched = T.WarmStartScheduler(flow_model=TorchGatherFlow(),
                                     draft_fn=draft_fn or T.uniform_draft(V, device="cpu"),
                                     device="cpu", **kw)
    sched.cost_model.cost_for_nfe = fixed_price
    return sched


def _strip(d):
    if isinstance(d, dict):
        return {k: _strip(v) for k, v in d.items() if k not in HOST_TIMING}
    if isinstance(d, list):
        return [_strip(v) for v in d]
    return d


def result_view(res):
    return {rid: (np.asarray(r.tokens).tolist(), r.nfe, r.t0, r.bucket_len, r.micro_batch,
                  tuple(r.row_t0s)) for rid, r in res.items()}


def stream_view(items):
    return [(c.request_id, np.asarray(c.tokens).tolist(), c.nfe, c.t0, c.bucket_len,
             c.micro_batch, tuple(c.row_t0s), c.status, c.flush_reason, c.latency_s)
            for c in items]


def both(fn):
    """``fn(S)`` on both packages; asserts the views equal and returns the port's."""
    jout, tout = fn(J), fn(T)
    assert tout[0] == jout[0]
    assert _strip(tout[1]) == _strip(jout[1])
    return tout


REQS = [dict(seq_len=8, num_samples=2, seed=i) for i in range(6)]


def split_threshold():
    """An accept_score between the smallest and the largest request-minimum
    score of REQS: some requests accept, some reject (JAX's own split)."""
    mins = []
    for r in REQS:
        keys, _ = T.scheduler._derive_row_keys(np.full((r["num_samples"],), r["seed"]),
                                               np.arange(r["num_samples"]))
        x = T.uniform_draft(V, device="cpu")(keys, 8)
        mins.append(float(torch_scorer(x).min()))
    assert max(mins) > min(mins)
    return (min(mins) + max(mins)) / 2.0


def serve_batch(S, reqs=REQS, **kw):
    sched = make(S, **kw)
    for r in reqs:
        sched.submit(**r)
    res, rep = sched.run()
    return result_view(res), rep


# -- the adaptive-t0 pre-pass (tests/test_adaptive_t0.py) -----------------------------

def test_adaptive_t0_end_to_end_matches_jax():
    def run(S):
        sched = make(S, t0_policy=policy(S))
        for i in range(5):
            sched.submit(seq_len=8 + i, num_samples=1 + (i % 2), seed=10 + i)
        sched.submit(seq_len=8, seed=99, t0=0.75)       # an override: never scored
        res, rep = sched.run()
        return result_view(res), rep

    view, rep = both(run)
    assert rep["adaptive_t0"] and rep["policy"]["scored_requests"] == 5
    assert sum(rep["policy"]["t0_histogram"].values()) == 5
    for rid, (_, nfe, t0, *_rest) in view.items():
        assert nfe == warm_nfe(20, t0) and (0.5 <= t0 <= 0.9 or t0 == 0.75)
    assert view[5][2] == 0.75


@pytest.mark.parametrize("extra", [[], [(9, 2, 77), (6, 1, 88)]])
def test_adaptive_t0_output_invariant_to_packing(extra):
    """Same request -> same (t0, nfe, tokens) whatever its neighbours, in
    both packages."""
    def run(S):
        sched = make(S, t0_policy=policy(S), max_rows=8)
        sched.submit(seq_len=12, num_samples=3, seed=5)
        for L, n, s in extra:
            sched.submit(seq_len=L, num_samples=n, seed=s)
        res, rep = sched.run()
        return result_view(res), rep

    view, _ = both(run)
    alone = result_view(make(T, t0_policy=policy(T), max_rows=8).serve_requests(
        [T.ServeRequest(request_id=0, seq_len=12, num_samples=3, seed=5)])[0])
    assert view[0] == alone[0]


def test_pre_pass_drafts_once_per_bucket_and_never_in_the_draft_stage():
    """draft_fn runs once per bucket in the pre-pass (rows padded to the row
    quantum) and never again in the draft stage, batch and stream."""
    base = T.uniform_draft(V, device="cpu")
    calls = []

    def counting(keys, seq_len):
        calls.append((int(keys.shape[0]), seq_len))
        return base(keys, seq_len)

    sched = make(T, t0_policy=policy(T), draft_fn=counting)
    for i in range(4):
        sched.submit(seq_len=12, seed=i)
    sched.submit(seq_len=5, num_samples=3, seed=9)
    sched.run()
    assert calls == [(4, 8), (4, 16)]
    calls.clear()
    reqs = [T.ServeRequest(request_id=i, seq_len=12, seed=i) for i in range(5)]
    items = list(make(T, t0_policy=policy(T), draft_fn=counting).serve_stream(reqs))
    assert calls == [(8, 16)] and len(items) == 5


# -- speculative accept/reject (tests/test_speculative.py) ----------------------------

@pytest.mark.parametrize("spec", [False, True])
def test_speculative_batch_path_matches_jax(spec):
    thr = split_threshold()
    view, rep = both(lambda S: serve_batch(S, t0_policy=policy(S), speculative=spec,
                                           accept_score=thr))
    if spec:
        s = rep["speculative"]
        assert s["enabled"] and 0 < s["accepted"] < len(REQS)
        assert s["accept_rate"] == s["accepted"] / s["eligible"]
        assert s["min_accepted_score"] >= thr


def test_rejected_requests_bit_identical_and_accepted_are_the_drafts():
    """JAX's invariant on the port: a rejected request serves exactly as with
    speculation off; an accepted one ships its drafts, cut to its length,
    with nfe 0, every row's score at or above the threshold."""
    thr = split_threshold()
    off, _ = serve_batch(T, t0_policy=policy(T), speculative=False, accept_score=thr)
    on, _ = serve_batch(T, t0_policy=policy(T), speculative=True, accept_score=thr)
    accepted = 0
    for rid, r in enumerate(REQS):
        toks, nfe, t0, blen, mb, _ = on[rid]
        if nfe == 0:
            accepted += 1
            keys, _ = T.scheduler._derive_row_keys(np.full((r["num_samples"],), r["seed"]),
                                                   np.arange(r["num_samples"]))
            drafts = T.uniform_draft(V, device="cpu")(keys, blen).numpy()
            assert mb == -1 and toks == drafts[:, :r["seq_len"]].tolist()
            assert (torch_scorer(np.asarray(toks)) >= thr).all()
        else:
            assert on[rid] == off[rid]
    assert 0 < accepted < len(REQS)


def test_explicit_t0_requests_never_accepted_as_in_jax():
    def run(S):
        sched = make(S, t0_policy=policy(S), speculative=True, accept_score=-100.0)
        sched.submit(seq_len=8, seed=1)
        sched.submit(seq_len=8, seed=2, t0=0.75)
        res, rep = sched.run()
        return result_view(res), rep

    view, rep = both(run)
    assert view[0][1] == 0 and view[1][1] == warm_nfe(20, 0.75)
    assert rep["speculative"]["eligible"] == 1


def test_speculative_requires_policy_and_threshold_as_in_jax():
    for S in (J, T):
        with pytest.raises(ValueError, match="needs a t0_policy"):
            make(S, speculative=True)
        sched = make(S, t0_policy=policy(S), speculative=True)
        assert sched.accept_score == PKG[S].default_accept_score(calib(S)) == 0.9


@pytest.mark.parametrize("spec", [False, True])
def test_speculative_stream_matches_jax(spec):
    thr = split_threshold()

    def run(S):
        sched = make(S, t0_policy=policy(S), speculative=spec, accept_score=thr)
        reqs = [S.ServeRequest(request_id=i, **r) for i, r in enumerate(REQS)]
        items = list(sched.serve_stream(reqs, clock=FakeClock()))
        return stream_view(items), sched.stream_report

    items, rep = both(run)
    assert rep["conservation"]["balanced"]
    assert rep["completed"] + rep["accepted_draft"] == len(REQS)
    if spec:
        assert rep["accepted_draft"] == rep["speculative"]["accepted"] > 0
        assert rep["speculative"]["min_accepted_score"] >= thr


def test_stream_equals_batch_under_speculation():
    thr = split_threshold()
    batch, _ = serve_batch(T, t0_policy=policy(T), speculative=True, accept_score=thr)
    sched = make(T, t0_policy=policy(T), speculative=True, accept_score=thr)
    reqs = [T.ServeRequest(request_id=i, **r) for i, r in enumerate(REQS)]
    for c in sched.serve_stream(reqs):
        assert (np.asarray(c.tokens).tolist(), c.nfe, c.t0) == batch[c.request_id][:3]


def test_cancelled_accepted_request_resolves_cancelled_as_in_jax():
    def run(S):
        sched = make(S, t0_policy=policy(S), speculative=True, accept_score=-100.0)
        clock = FakeClock()
        q = S.AdmissionQueue(clock=clock)
        q.cancel(q.submit(seq_len=8, num_samples=2, seed=1))
        q.submit(seq_len=8, num_samples=2, seed=2)
        q.close()
        return stream_view(list(sched.serve_stream(source=q, clock=clock))), \
            sched.stream_report

    items, rep = both(run)
    assert [i[7] for i in items] == ["cancelled", "accepted_draft"]
    assert rep["conservation"]["balanced"] and rep["terminal"]["accepted_draft"] == 1


def test_oversize_request_scored_chunk_by_chunk_as_in_jax():
    """An oversize request without a t0 is drafted and scored chunk by chunk
    at admission; every chunk gets the request-level minimum t0."""
    def run(S):
        sched = make(S, t0_policy=policy(S), max_rows=8)
        reqs = [S.ServeRequest(request_id=0, seq_len=9, num_samples=19, seed=4),
                S.ServeRequest(request_id=1, seq_len=6, num_samples=2, seed=5)]
        return stream_view(list(sched.serve_stream(reqs, clock=FakeClock()))), \
            sched.stream_report

    items, rep = both(run)
    (big,) = [i for i in items if i[0] == 0]
    assert rep["split_requests"] == 1 and len(big[1]) == 19 and big[2] == warm_nfe(20, big[3])


# -- per-row t0 -----------------------------------------------------------------------

def test_per_row_t0_matches_jax_and_serves_rows_at_own_depth():
    view, rep = both(lambda S: serve_batch(S, [dict(seq_len=8, num_samples=4, seed=3)],
                                           t0_policy=policy(S), per_row_t0=True))
    toks, nfe, t0, _, _, row_t0s = view[0]
    assert len(row_t0s) == 4 and t0 == min(row_t0s) and nfe == warm_nfe(20, t0)
    assert rep["mean_request_nfe"] == pytest.approx(np.mean([warm_nfe(20, t)
                                                             for t in row_t0s]))
    # each row equals that row served alone at its own t0
    for i, t0_row in enumerate(row_t0s):
        solo, _ = make(T).serve_requests([T.ServeRequest(
            request_id=0, seq_len=8, num_samples=1, seed=3, t0=t0_row, sample_offset=i)])
        assert solo[0].tokens[0].tolist() == toks[i]


def test_per_row_t0_stream_matches_jax():
    def run(S):
        sched = make(S, t0_policy=policy(S), per_row_t0=True, max_rows=8)
        reqs = [S.ServeRequest(request_id=i, seq_len=6 + 3 * i, num_samples=1 + i % 3,
                               seed=20 + i) for i in range(5)]
        return stream_view(list(sched.serve_stream(reqs, slo_ms=1e6, clock=FakeClock()))), \
            sched.stream_report

    items, _ = both(run)
    assert any(len(set(i[6])) > 1 for i in items)        # rows at different depths


# -- the bandit behind the scheduler --------------------------------------------------

@pytest.mark.parametrize("per_row", [False, True])
def test_bandit_scheduler_matches_jax_and_rewards_flow(per_row):
    """Rewards from the verify probe land in the served arms: pulls = priors
    + rows refined; the arm table equals JAX's (prices pinned)."""
    pols = {}

    def run(S):
        pols[S] = bandit(S, exploration="epsilon", epsilon=0.0)
        sched = make(S, t0_policy=pols[S], per_row_t0=per_row)
        for i in range(8):
            sched.submit(seq_len=8, num_samples=1, seed=i)
        res, rep = sched.run()
        return result_view(res), rep

    _, rep = both(run)
    stats = rep["bandit"]
    pulled = sum(a["count"] for ctx in stats.values() for a in ctx["arms"].values())
    assert pulled == pytest.approx(len(stats) * pols[T].prior_weight + 8)
    assert pols[T].snapshot() == pols[J].snapshot()


def test_bandit_stream_with_speculation_matches_jax():
    thr = split_threshold()

    def run(S):
        pol = bandit(S, exploration="ucb")
        sched = make(S, t0_policy=pol, per_row_t0=True, speculative=True, accept_score=thr,
                     max_rows=8)
        reqs = [S.ServeRequest(request_id=i, **r) for i, r in enumerate(REQS)]
        items = list(sched.serve_stream(reqs, clock=FakeClock()))
        rep = dict(sched.stream_report, snapshot=pol.snapshot())
        return stream_view(items), rep

    items, rep = both(run)
    assert rep["bandit"] and 0 < rep["accepted_draft"] < len(REQS)


# -- the smoke DiT's own probe --------------------------------------------------------

def test_smoke_dit_probe_policy_scheduler_matches_jax():
    """The real probe (``make_quality_scorer`` on the smoke DiT, both
    packages on the same weights) behind ``AdaptiveT0Policy`` with
    ``per_row_t0`` and ``speculative``: the same t0s, accepts and tokens."""
    jm = jax_build_model(jax_smoke_config())
    params = jm.init(jax.random.key(0))
    model = Model(smoke_config(), device="cpu")
    model.load_state_dict(jax_params_to_torch(_flatten(params)), strict=True)
    vocab = smoke_config().vocab_size
    jscore = JD.make_quality_scorer(jm.dfm_apply, params)
    tscore = TD.make_quality_scorer(model.dfm_apply, device="cpu")
    cal = dict(scores=(-3.4, -3.2), t0s=(0.5, 0.9), t0_floor=0.5, t0_ceil=0.9)
    spec = [(16, 2, None), (14, 3, None), (6, 3, 0.5), (12, 1, None)]

    def run(S):
        score = jscore if S is J else tscore
        pol = PKG[S].AdaptiveT0Policy(scorer=score, calibration=PKG[S].T0Calibration(**cal),
                                      bin_width=0.1)
        draft = J.uniform_draft(vocab) if S is J else T.uniform_draft(vocab, device="cpu")
        kw = dict(cold_nfe=16, default_t0=0.8, max_rows=8, t0_policy=pol, per_row_t0=True,
                  speculative=True, accept_score=-3.3)
        if S is J:
            sched = J.WarmStartScheduler(flow_model=jm, flow_params=params, draft_fn=draft,
                                         **kw)
        else:
            sched = T.WarmStartScheduler(flow_model=model, draft_fn=draft, device="cpu", **kw)
        reqs = [S.ServeRequest(request_id=i, seq_len=L, num_samples=n, seed=40 + i, t0=t0)
                for i, (L, n, t0) in enumerate(spec)]
        res, rep = sched.serve_requests(reqs)
        return result_view(res), rep

    view, rep = both(run)
    assert rep["policy"]["scored_requests"] == 3
