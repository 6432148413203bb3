"""The port's continuous-batching scheduler against the JAX package's on the
CPU: ``serve_requests`` and ``serve_stream`` give the same tokens, the same
micro-batches and compile keys, NFE, ``jit_cache`` section, terminal and
conservation ledgers and (on the fake stream clock) the same latencies,
deadlines and flush reasons, for the same requests. Timing fields measured
on the host clock (``draft_time_s``, ``flow_time_s``, rates) are left out.

The flow model of most tests is a gather (``W[x] * (1 + t)``), computed
identically by both packages, so the scenarios run fast; one test serves
the smoke DiT drafted by a smoke-size AR engine. Drafts are the packages'
``uniform_draft``s, which agree bit for bit. Tolerance: tokens equal.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as J
import repro_torch.serving as T
from repro.checkpoint.io import _flatten
from repro.configs.dfm_dit import smoke_config as jax_smoke_config
from repro.configs.dfm_dit import tiny_config as jax_tiny_config
from repro.drafting import ARDraftEngine as JaxARDraftEngine
from repro.drafting import TransformerDraftAdapter as JaxTransformerDraftAdapter
from repro.models import build_model as jax_build_model
from repro_torch.configs.dfm_dit import smoke_config, tiny_config
from repro_torch.convert import jax_params_to_torch
from repro_torch.drafting import ARDraftEngine, TransformerDraftAdapter
from repro_torch.models import Model

V = 11
W = (2.0 * np.random.default_rng(0).standard_normal((V, V))).astype(np.float32)
HOST_TIMING = {"draft_time_s", "flow_time_s", "wall_time_s", "overlap_efficiency",
               "requests_per_s", "samples_per_s"}


class JaxGatherFlow:
    def dfm_apply(self, params, x, t, extras=None):
        return jnp.asarray(W)[x] * (1.0 + t)[:, None, None]


class TorchGatherFlow:
    device = torch.device("cpu")

    def dfm_apply(self, x, t):
        return torch.from_numpy(W)[x.long()] * (1.0 + t)[:, None, None]


JAX_DRAFT = J.uniform_draft(V)


class FakeClock:
    """Deterministic stream clock: time() advances only through sleep()."""

    def __init__(self):
        self.t, self.sleeps = 0.0, []

    def time(self):
        return self.t

    def sleep(self, dt):
        self.sleeps.append(dt)
        self.t += dt


_SCHEDULERS = {}


def make(S, fresh=False, **kw):
    """The package ``S``'s scheduler over the gather flow and a uniform draft.

    Schedulers are shared between tests with the same arguments (the JAX one
    compiles per instance and compile key, seconds each), both packages' in
    the same order, so their compile-key ledgers stay alike; ``fresh`` gives
    a new one, for runs whose flushes read the measured cost model."""
    kw = {"cold_nfe": 20, "default_t0": 0.8, "max_rows": 8, **kw}
    key = (S.__name__, repr(sorted(kw.items())))
    if not fresh and key in _SCHEDULERS:
        sched = _SCHEDULERS[key]
        sched._dispatch_fault_hook = None
        sched.retry_policy = S.DispatchRetryPolicy()
        return sched
    if S is J:
        sched = J.WarmStartScheduler(flow_model=JaxGatherFlow(), flow_params={},
                                     draft_fn=JAX_DRAFT, **kw)
    else:
        sched = T.WarmStartScheduler(flow_model=TorchGatherFlow(),
                                     draft_fn=T.uniform_draft(V, device="cpu"), device="cpu",
                                     **kw)
    if not fresh:
        _SCHEDULERS[key] = sched
    return sched


def _strip(d):
    if isinstance(d, dict):
        return {k: _strip(v) for k, v in d.items() if k not in HOST_TIMING}
    if isinstance(d, list):
        return [_strip(v) for v in d]
    return d


def assert_batch_equal(jres, jrep, tres, trep):
    assert set(jres) == set(tres)
    for rid, a in jres.items():
        b = tres[rid]
        np.testing.assert_array_equal(np.asarray(a.tokens), b.tokens)
        assert (a.nfe, a.t0, a.bucket_len, a.micro_batch, a.row_t0s) == \
            (b.nfe, b.t0, b.bucket_len, b.micro_batch, b.row_t0s)
    assert set(jrep) == set(trep)
    assert _strip(jrep) == _strip(trep)


def stream_view(items):
    out = []
    for c in items:
        d = {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}
        d["tokens"] = np.asarray(d["tokens"]).tolist()
        out.append(d)
    return out


def requests(S, spec, **extra):
    return [S.ServeRequest(request_id=i, seq_len=L, num_samples=n, seed=100 + 7 * i, t0=t0,
                           **extra)
            for i, (L, n, t0) in enumerate(spec)]


# buckets 8 and 16, t0 0.8 and 0.5: three micro-batches at max_rows 8
MIXED = [(5, 2, None), (12, 3, None), (8, 1, 0.5), (7, 2, None), (14, 5, None)]


@pytest.mark.parametrize("kw", [dict(), dict(fused_block=2)])
def test_serve_requests_matches_jax(kw):
    out = []
    for S in (J, T):
        sched = make(S, **kw)
        first = sched.serve_requests(requests(S, MIXED))
        second = sched.serve_requests(requests(S, MIXED))     # all compile keys hit
        out.append((first, second))
    (j1, j2), (t1, t2) = out
    assert_batch_equal(*j1, *t1)
    assert_batch_equal(*j2, *t2)
    assert t2[1]["jit_cache"]["misses"] == 0
    assert t2[1]["jit_cache"]["hits"] == t2[1]["num_micro_batches"]


def test_heterogeneous_row_t0s_share_a_masked_micro_batch_as_in_jax():
    """``t0_bin_width > 0``: rows of different t0 (per request and per row)
    refine in one micro-batch, each entering the masked loop at its own
    step and spending exactly its own NFE."""
    def reqs(S):
        return [S.ServeRequest(request_id=0, seq_len=8, num_samples=3, seed=5, t0=0.8,
                               row_t0s=(0.8, 0.85, 0.9)),
                S.ServeRequest(request_id=1, seq_len=8, num_samples=2, seed=6, t0=0.75),
                S.ServeRequest(request_id=2, seq_len=6, num_samples=1, seed=7, t0=0.7)]

    res = [make(S, t0_bin_width=0.5).serve_requests(reqs(S)) for S in (J, T)]
    assert_batch_equal(*res[0], *res[1])
    (mb,) = res[1][1]["batches"]
    assert mb["t0_spans"] == [0.8, 0.75, 0.7] and mb["nfe"] == 6
    assert res[1][1]["mean_request_nfe"] == pytest.approx((np.mean([4, 3, 2]) + 5 + 6) / 3)


# -- streaming scenarios: each runs identically on both packages ------------------------

def sc_mixed(S, clock):
    """Mixed lengths and t0s, one oversize request split into chunks and
    reassembled, SLO attainment over a generous budget."""
    sched = make(S)
    spec = MIXED + [(9, 19, None)]
    return sched, list(sched.serve_stream(requests(S, spec), slo_ms=1e7, clock=clock))


def sc_fused(S, clock):
    sched = make(S, fused_block=2)
    return sched, list(sched.serve_stream(requests(S, MIXED), clock=clock))


def sc_cancel_queued(S, clock):
    reqs = [S.ServeRequest(request_id=i, seq_len=8, num_samples=2, seed=50 + i,
                           cancel_token=S.CancelToken()) for i in range(4)]
    reqs[2].cancel_token.cancel()
    sched = make(S, max_rows=16)
    return sched, list(sched.serve_stream(reqs, clock=clock))


def sc_cancel_filling(S, clock):
    q = S.AdmissionQueue(clock=clock)
    q.submit(seq_len=8, seed=1)
    assert q.cancel(q.submit(seq_len=8, seed=2))
    q.close()
    sched = make(S, max_rows=16)
    return sched, list(sched.serve_stream(source=q, clock=clock))


def sc_cancel_after_packing(S, clock):
    reqs = [S.ServeRequest(request_id=i, seq_len=8, num_samples=2, seed=70 + i,
                           cancel_token=S.CancelToken()) for i in range(3)]
    sched = make(S, max_rows=16)
    sched._dispatch_fault_hook = lambda mb, attempt: reqs[1].cancel_token.cancel()
    return sched, list(sched.serve_stream(reqs, clock=clock))


def sc_timeout_filling(S, clock):
    q = S.AdmissionQueue(clock=clock)
    q.submit(seq_len=8, seed=1, timeout_s=0.01)
    q.submit(seq_len=8, seed=2)
    sched = make(S, max_rows=16)
    stream = sched.serve_stream(source=q, idle_timeout_s=0.05, clock=clock)
    first = next(stream)
    q.close()
    return sched, [first] + list(stream)


def sc_timeout_after_packing(S, clock):
    reqs = [S.ServeRequest(request_id=0, seq_len=8, seed=5, timeout_s=0.5, arrival_s=1e-9),
            S.ServeRequest(request_id=1, seq_len=8, seed=6)]
    sched = make(S, max_rows=16)
    sched._dispatch_fault_hook = lambda mb, attempt: clock.sleep(1.0)
    return sched, list(sched.serve_stream(reqs, clock=clock))


def sc_shed(S, clock):
    q = S.AdmissionQueue(max_depth=2, clock=clock)
    q.submit(seq_len=8, seed=1, priority="best_effort")
    q.submit(seq_len=8, seed=2, priority="best_effort")
    q.submit(seq_len=8, seed=3, priority="premium")
    with pytest.raises(S.QueueFull):
        q.submit(seq_len=8, seed=4, priority="best_effort")
    q.close()
    with pytest.raises(S.QueueClosed):
        q.submit(seq_len=8, seed=5)
    sched = make(S, max_rows=16)
    return sched, list(sched.serve_stream(source=q, clock=clock))


def sc_priority(S, clock):
    q = S.AdmissionQueue(clock=clock)
    q.submit(seq_len=8, seed=1, priority="best_effort")
    q.submit(seq_len=8, seed=2, priority="premium")
    q.submit(seq_len=8, seed=3, priority="standard")
    q.close()
    sched = make(S, max_rows=16)
    return sched, list(sched.serve_stream(source=q, slo_ms=1e6, clock=clock))


def sc_transient_fault(S, clock):
    sched = make(S, max_rows=16)
    sched.retry_policy = S.DispatchRetryPolicy(max_retries=2, backoff_base_s=0.07)

    def hook(mb, attempt):
        if attempt == 0:
            raise RuntimeError("transient device fault")

    sched._dispatch_fault_hook = hook
    reqs = [S.ServeRequest(request_id=i, seq_len=8, seed=90 + i) for i in range(2)]
    return sched, list(sched.serve_stream(reqs, clock=clock))


def sc_persistent_fault(S, clock):
    sched = make(S, max_rows=16)
    sched.retry_policy = S.DispatchRetryPolicy(max_retries=1, backoff_base_s=0.01)

    def hook(mb, attempt):
        if mb.bucket_len == 32:
            raise RuntimeError("persistent fault")

    sched._dispatch_fault_hook = hook
    reqs = [S.ServeRequest(request_id=0, seq_len=8, seed=1),
            S.ServeRequest(request_id=1, seq_len=30, seed=2),
            S.ServeRequest(request_id=2, seq_len=8, seed=3)]
    return sched, list(sched.serve_stream(reqs, clock=clock))


def sc_slo_deadline(S, clock):
    q = S.AdmissionQueue(clock=clock)
    q.submit(seq_len=8, num_samples=1, seed=3)
    sched = make(S, fresh=True, max_rows=16)
    stream = sched.serve_stream(source=q, slo_ms=100.0, idle_timeout_s=10.0, clock=clock)
    first = next(stream)
    q.close()
    return sched, [first] + list(stream)


def sc_full_then_drain(S, clock):
    q = S.AdmissionQueue(clock=clock)
    for i in range(5):
        q.submit(seq_len=8, seed=i)
    sched = make(S, max_rows=4)
    stream = sched.serve_stream(source=q, idle_timeout_s=1e9, clock=clock)
    first = next(stream)
    q.close()
    return sched, [first] + list(stream)


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_mixed, sc_fused, sc_cancel_queued, sc_cancel_filling, sc_cancel_after_packing,
    sc_timeout_filling, sc_timeout_after_packing, sc_shed, sc_priority, sc_transient_fault,
    sc_persistent_fault, sc_slo_deadline, sc_full_then_drain)}
EXPECT = {
    "mixed": {"completed": 6, "split_requests": 1},
    "cancel_queued": {"cancelled": 1, "completed": 3},
    "cancel_filling": {"cancelled": 1, "completed": 1},
    "cancel_after_packing": {"cancelled": 1, "completed": 2},
    "timeout_filling": {"timed_out": 1, "completed": 1},
    "timeout_after_packing": {"timed_out": 1, "completed": 1},
    "shed": {"shed": 1, "completed": 2},
    "transient_fault": {"completed": 2, "retries": 1},
    "persistent_fault": {"failed": 1, "completed": 2, "retries": 1},
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_serve_stream_matches_jax(name):
    runs = []
    for S in (J, T):
        clock = FakeClock()
        sched, items = SCENARIOS[name](S, clock)
        runs.append((stream_view(items), sched.stream_report, clock.sleeps))
    (jitems, jrep, jsleeps), (titems, trep, tsleeps) = runs
    assert titems == jitems
    assert set(trep) == set(jrep)
    assert _strip(trep) == _strip(jrep)
    assert tsleeps == jsleeps
    assert trep["conservation"]["balanced"]
    for key, n in EXPECT.get(name, {}).items():
        got = (trep["dispatch"]["retries"] if key == "retries"
               else trep["split_requests"] if key == "split_requests"
               else trep["terminal"][key] if key != "completed" else trep["completed"])
        assert got == n, (key, got)


def test_stream_equals_batch_and_is_pack_and_overlap_invariant():
    reqs = requests(T, MIXED)
    batch, _ = make(T).serve_requests(reqs)
    streamed = {c.request_id: c for c in make(T).serve_stream(reqs)}
    serial, _ = make(T, overlap=False).serve_requests(reqs)
    for rid, r in batch.items():
        np.testing.assert_array_equal(streamed[rid].tokens, r.tokens)
        np.testing.assert_array_equal(serial[rid].tokens, r.tokens)
        alone, _ = make(T).serve_requests([reqs[rid]])
        np.testing.assert_array_equal(alone[rid].tokens, r.tokens)


def test_batch_path_requeues_on_dispatch_failure_and_stays_retryable():
    sched = make(T, retry_policy=T.DispatchRetryPolicy(max_retries=1, backoff_base_s=0.0))
    ids = [sched.submit(seq_len=8, seed=i) for i in range(3)]

    def boom(mb, attempt):
        raise RuntimeError("device fell over")

    sched._dispatch_fault_hook = boom
    with pytest.raises(T.DispatchFailure) as err:
        sched.run()
    assert err.value.attempts == 2 and sched._c_dispatch_retries.value == 1
    assert [r.request_id for r in sched._queue] == ids
    sched._dispatch_fault_hook = None
    results, _ = sched.run()
    assert set(results) == set(ids)


# the drafting-policies keywords, ported: their cases below check JAX's behaviour
POLICY_KEYWORDS = ("t0_policy", "speculative", "per_row_t0", "accept_score")
DISTILLED_KEYWORDS = ("distilled_model", "distilled_params", "distilled_nfe",
                      "distilled_accept_score", "pair_buffer")


def check_policy_keyword_as_jax(kw):
    """Both constructors on ``kw`` raise the same ValueError, or build
    schedulers with the same policy settings."""
    outs = []
    for S in (J, T):
        try:
            sched = make(S, fresh=True, **kw)
        except ValueError as err:
            outs.append(("ValueError", str(err)))
        else:
            outs.append((sched.per_row_t0, sched.speculative, sched.accept_score,
                         sched.t0_bin_width, sched._bandit_mode, sched.t0_policy is None))
    assert outs[0] == outs[1]
    return outs[1]


def check_distilled_keyword_as_jax(kw):
    """Both constructors on ``kw`` raise the same ValueError, or build
    schedulers with the same distilled-tier settings."""
    outs = []
    for S in (J, T):
        try:
            sched = make(S, fresh=True, **kw)
        except ValueError as err:
            outs.append(("ValueError", str(err)))
        else:
            outs.append((sched.distilled_model is None, sched.distilled_nfe,
                         sched.distilled_accept_score,
                         sched.pair_buffer is kw.get("pair_buffer")))
    assert outs[0] == outs[1]
    return outs[1]


@pytest.mark.parametrize("kw,match", [
    (dict(t0_policy=object()), "t0_policy"), (dict(speculative=True), "speculative"),
    (dict(distilled_model=object()), "distilled"), (dict(pair_buffer=object()), "pair_buffer"),
    (dict(mesh=object()), "mesh")])
def test_unported_features_raise(kw, match):
    """Keywords of slices still to port (``mesh``) raise NotImplementedError
    naming them; ``t0_policy`` and ``speculative`` are ported and behave as
    JAX's (a duck-typed policy builds; ``speculative`` without a policy
    raises JAX's ValueError), and so are the distilled tier's (a head
    without a policy raises JAX's ValueError; a pair buffer is kept)."""
    if match in POLICY_KEYWORDS:
        got = check_policy_keyword_as_jax(kw)
        assert (got[0] == "ValueError") == (match == "speculative")
        return
    if match in ("distilled", "pair_buffer"):
        got = check_distilled_keyword_as_jax(kw)
        assert (got[0] == "ValueError") == (match == "distilled")
        return
    with pytest.raises(NotImplementedError, match=match):
        make(T, **kw)


# JAX's constructor keywords of the policy and distilled-tier slices, at
# their defaults
JAX_DEFAULTS = dict(per_row_t0=False, accept_score=None, distilled_params=None,
                    distilled_nfe=1, distilled_accept_score=None)


@pytest.mark.parametrize("name", sorted(JAX_DEFAULTS))
def test_jax_keywords_are_taken_at_their_defaults(name):
    """Each of these keywords, passed at JAX's default, builds the scheduler
    that the JAX package builds with it (same keyword, same default)."""
    sched = make(T, fresh=True, **{name: JAX_DEFAULTS[name]})
    assert isinstance(sched, T.WarmStartScheduler)
    jax_param = inspect.signature(J.WarmStartScheduler.__init__).parameters[name]
    port_param = inspect.signature(T.WarmStartScheduler.__init__).parameters[name]
    assert jax_param.default == port_param.default == JAX_DEFAULTS[name]


@pytest.mark.parametrize("kw,slice_name", [
    (dict(per_row_t0=True), "the drafting-policies slice"),
    (dict(accept_score=0.5), "the drafting-policies slice"),
    (dict(distilled_params=object()), "the distilled-tier slice"),
    (dict(distilled_nfe=2), "the distilled-tier slice"),
    (dict(distilled_accept_score=0.5), "the distilled-tier slice"),
    (dict(distilled_model=object()), "the distilled-tier slice"),
    (dict(pair_buffer=object()), "the distilled-tier slice")])
def test_unported_keywords_name_their_slice(kw, slice_name):
    """Keywords of slices still to port name their slice; those of the
    drafting-policies and distilled-tier slices are ported and build what
    JAX builds (a head without a policy, or a K other than 1 or 2 with one,
    raises JAX's ValueError)."""
    (name,) = kw
    if name in POLICY_KEYWORDS:
        assert check_policy_keyword_as_jax(kw)[:3] == (
            name == "per_row_t0", False, kw.get("accept_score"))
        return
    if name in DISTILLED_KEYWORDS:
        got = check_distilled_keyword_as_jax(kw)
        assert (got[0] == "ValueError") == (name == "distilled_model")
        if name != "distilled_model":
            assert got[1:3] == (kw.get("distilled_nfe", 1), kw.get("distilled_accept_score"))
        return
    with pytest.raises(NotImplementedError, match=name.split("_")[0]) as err:
        make(T, fresh=True, **kw)
    assert slice_name in str(err.value)


def test_submit_rejects_unservable_requests_as_jax_does():
    for S in (J, T):
        sched = make(S, max_bucket=16)
        with pytest.raises(ValueError):
            sched.submit(seq_len=17)
        with pytest.raises(ValueError):
            sched.submit(seq_len=8, num_samples=9)
        with pytest.raises(ValueError):
            sched.submit(seq_len=8, tier="distilled")
        assert sched._queue == []


def test_entry_point_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.WarmStartScheduler(flow_model=TorchGatherFlow(), draft_fn=None, cold_nfe=4,
                             default_t0=0.5)


def test_smoke_dit_with_ar_draft_matches_jax():
    """The paper's pipeline at smoke size: a 2-layer causal transformer
    drafts (KV-cached engine, BOS prompt), the smoke DiT refines; requests of
    two buckets, two t0s, one fused-block run."""
    jm = jax_build_model(jax_smoke_config())
    params = jm.init(jax.random.key(0))
    model = Model(smoke_config(), device="cpu")
    model.load_state_dict(jax_params_to_torch(_flatten(params)), strict=True)
    kw = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=2, d_ff=64)
    jdm = jax_build_model(jax_tiny_config().replace(**kw))
    dparams = jdm.init(jax.random.key(1))
    dmodel = Model(tiny_config().replace(**kw), device="cpu")
    dmodel.load_state_dict(jax_params_to_torch(_flatten(dparams)), strict=True)
    jeng = JaxARDraftEngine(JaxTransformerDraftAdapter(model=jdm), dparams, max_len=16)
    eng = ARDraftEngine(TransformerDraftAdapter(model=dmodel, decode_impl="kernel"), max_len=16)
    spec = [(16, 2, None), (14, 1, None), (6, 3, 0.5)]
    common = dict(cold_nfe=16, default_t0=0.8, max_rows=8)
    jsched = J.WarmStartScheduler(flow_model=jm, flow_params=params,
                                  draft_fn=jeng.as_draft_fn(), **common)
    tsched = T.WarmStartScheduler(flow_model=model, draft_fn=eng.as_draft_fn(), device="cpu",
                                  **common)
    assert_batch_equal(*jsched.serve_requests(requests(J, spec)),
                       *tsched.serve_requests(requests(T, spec)))
    jrep = [c for c in jsched.serve_stream(requests(J, spec))]
    trep = [c for c in tsched.serve_stream(requests(T, spec))]
    assert [np.asarray(c.tokens).tolist() for c in trep] == \
        [np.asarray(c.tokens).tolist() for c in jrep]
