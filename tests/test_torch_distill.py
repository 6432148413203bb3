"""The port's distilled tier against the JAX package's on the CPU: the pair
buffer, the distilled head (``dfm_apply``, ``train_distilled``, its
checkpoints both ways), the DISTILL_STREAM keys, and the scheduler's batch
and stream paths with the tier on (``tests/test_distill.py``'s scenarios on
its ``ToyFlow`` and ``fake_scorer``, the streams on a fake clock).

Both sides get the same inputs from a numpy seed, the head the JAX init
carried across by ``convert.jax_distilled_params_to_torch``. Tolerances:
the head's logits and trained params within 1e-5; buffer rows, key words,
checkpoints, tokens, statuses, NFE, reports (host timings left out),
counters and compile keys exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.drafting as JD
import repro.obs as JO
import repro.serving as J
import repro_torch.drafting as TD
import repro_torch.obs as TO
import repro_torch.serving as T
from repro.serving.scheduler import _derive_distill_keys as jax_distill_keys
from repro_torch.convert import DISTILLED_LEAVES, jax_distilled_params_to_torch
from repro_torch.core.guarantees import warm_nfe
from repro_torch.serving.scheduler import _derive_distill_keys

V = 11
HOST_TIMING = {"draft_time_s", "flow_time_s", "wall_time_s", "overlap_efficiency",
               "requests_per_s", "samples_per_s", "prepass_time_s", "queue_wait_s"}
PKG = {J: JD, T: TD}
PKG_OBS = {J: JO, T: TO}
REQS = [dict(seq_len=8, num_samples=2, seed=i) for i in range(6)]


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread for these smoke-size models: the suite runs in
    several worker processes at once, where torch's default of a thread a
    core makes each small op wait on the others' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class JaxToyFlow:
    def dfm_apply(self, params, x, t, extras=None):
        return jnp.zeros(x.shape + (V,)).at[..., 2].set(30.0)


class TorchToyFlow:
    device = torch.device("cpu")

    def dfm_apply(self, x, t):
        out = torch.zeros(tuple(x.shape) + (V,))
        out[..., 2] = 30.0
        return out


def jax_scorer(toks):
    return jnp.asarray(toks, jnp.float32).mean(axis=-1) / 10.0


def torch_scorer(toks):
    toks = toks if isinstance(toks, torch.Tensor) else torch.from_numpy(np.asarray(toks))
    return toks.float().mean(dim=-1) / 10.0


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def time(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


def policy(S):
    calib = PKG[S].T0Calibration(scores=(0.1, 0.9), t0s=(0.5, 0.9), t0_floor=0.5, t0_ceil=0.9)
    return PKG[S].AdaptiveT0Policy(scorer=jax_scorer if S is J else torch_scorer,
                                   calibration=calib, bin_width=0.1)


_JAX_HEAD = JD.DistilledRefiner(vocab_size=V)
_HEAD_PARAMS = {k: np.asarray(v) for k, v in _JAX_HEAD.init(jax.random.key(42)).items()}


def head(S):
    """The untrained head of ``tests/test_distill.py`` (a near copier, so the
    gate scores vary by request), the port's carried across from JAX's. New
    arrays each call: JAX's training step donates its params."""
    if S is J:
        return _JAX_HEAD, {k: jnp.asarray(v) for k, v in _HEAD_PARAMS.items()}
    return (TD.DistilledRefiner(vocab_size=V),
            jax_distilled_params_to_torch(_HEAD_PARAMS, device="cpu"))


def make(S, *, with_head=False, **kw):
    kw = {"cold_nfe": 20, "default_t0": 0.8, "t0_policy": policy(S), **kw}
    if with_head:
        model, params = head(S)
        kw.update(distilled_model=model, distilled_params=params)
    if S is J:
        return J.WarmStartScheduler(flow_model=JaxToyFlow(), flow_params={},
                                    draft_fn=J.uniform_draft(V), **kw)
    return T.WarmStartScheduler(flow_model=TorchToyFlow(),
                                draft_fn=T.uniform_draft(V, device="cpu"), device="cpu", **kw)


def _strip(d):
    if isinstance(d, dict):
        return {k: _strip(v) for k, v in d.items() if k not in HOST_TIMING}
    if isinstance(d, list):
        return [_strip(v) for v in d]
    return d


def counters(sched):
    """Every counter but the admission queue's (labelled by a process-wide
    queue number; the reports carry its ledger)."""
    return {k: v for k, v in sched.metrics.counter_deltas({}).items()
            if not k.startswith("admission.")}


def batch_view(S, reqs, **kw):
    sched = make(S, **kw)
    for r in reqs:
        sched.submit(**r)
    res, rep = sched.run()
    view = {rid: (np.asarray(r.tokens).tolist(), r.nfe, r.t0, r.bucket_len, r.micro_batch,
                  tuple(r.row_t0s)) for rid, r in res.items()}
    return view, rep, counters(sched), sorted(map(str, sched._compiled))


def stream_view(S, reqs, tracer=None, **kw):
    sched = make(S, **kw, **({} if tracer is None else {"tracer": tracer}))
    items = list(sched.serve_stream([S.ServeRequest(request_id=i, **r)
                                     for i, r in enumerate(reqs)], clock=FakeClock()))
    view = [(c.request_id, np.asarray(c.tokens).tolist(), c.nfe, c.t0, c.bucket_len,
             c.micro_batch, tuple(c.row_t0s), c.status, c.flush_reason, c.latency_s)
            for c in items]
    return view, sched.stream_report, counters(sched), sorted(map(str, sched._compiled))


def both(fn, *args, **kw):
    """``fn`` on both packages: views, reports, counters and compile keys
    equal; returns the port's."""
    jout, tout = fn(J, *args, **kw), fn(T, *args, **kw)
    assert tout[0] == jout[0]
    assert _strip(tout[1]) == _strip(jout[1])
    assert tout[2] == jout[2]
    assert tout[3] == jout[3]
    return tout


def distilled(reqs, routed):
    return [dict(r, tier="distilled") if i in routed else dict(r) for i, r in enumerate(reqs)]


def floor_between(reqs, routed, **kw):
    """A quality floor halfway between the two middle distinct minimum row
    scores of the routed requests' distilled outputs (served with the floor
    open), so requests both pass and fall back. The outputs are at the
    bucket length (8), so the result tokens are the rows the gate scores."""
    view, *_ = batch_view(T, distilled(reqs, routed), with_head=True,
                          distilled_accept_score=-100.0, **kw)
    vals = sorted({float(torch_scorer(np.asarray(view[i][0])).min()) for i in routed})
    assert len(vals) >= 2, vals
    mid = len(vals) // 2
    return (vals[mid - 1] + vals[mid]) / 2.0


# -- the pair buffer, the head, training and checkpoints ------------------------------

def test_pair_buffer_rows_stats_and_batches_match_jax():
    rng = np.random.default_rng(0)
    bufs = {S: PKG[S].PairBuffer(capacity=12) for S in (J, T)}
    for n, b in [(4, 6), (8, 5), (4, 7), (16, 3), (8, 4)]:
        d = rng.integers(0, V, (b, n)).astype(np.int32)
        x = rng.integers(0, V, (b, n)).astype(np.int32)
        t0 = rng.uniform(0.3, 0.9, b)
        mask = rng.uniform(size=b) < 0.8
        assert bufs[J].add_batch(d, x, t0, mask=mask) == bufs[T].add_batch(d, x, t0, mask=mask)
    assert bufs[T].stats() == bufs[J].stats() and bufs[T].stats()["evicted"] > 0
    snaps = {S: b.snapshot() for S, b in bufs.items()}
    assert sorted(snaps[T]) == sorted(snaps[J])
    for n in snaps[J]:
        for a, b in zip(snaps[T][n], snaps[J][n]):
            np.testing.assert_array_equal(a, b)
    order = {S: list(b.batches(3, rng=np.random.default_rng(5))) for S, b in bufs.items()}
    assert len(order[T]) == len(order[J])
    for bt, bj in zip(order[T], order[J]):
        for a, b in zip(bt, bj):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="t0_rows"):
        bufs[T].add_batch(np.zeros((2, 3)), np.zeros((2, 3)), np.zeros(3))


def test_dfm_apply_matches_jax():
    rng = np.random.default_rng(1)
    toks = rng.integers(0, V, (5, 8)).astype(np.int32)
    t = rng.uniform(0.2, 0.95, 5).astype(np.float32)
    jm, jp = head(J)
    tm, tp = head(T)
    # a head whose every leaf is non-trivial (JAX's init zeroes the biases)
    jp = {k: v + 0.05 * rng.standard_normal(np.shape(v)).astype(np.float32)
          for k, v in jp.items()}
    tp = jax_distilled_params_to_torch({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    want = np.asarray(jm.dfm_apply(jp, jnp.asarray(toks), jnp.asarray(t)))
    got = tm.dfm_apply(tp, torch.from_numpy(toks), torch.from_numpy(t)).numpy()
    assert got.shape == (5, 8, V)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    init = tm.init(3, device="cpu")
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: tuple(np.shape(v)) for k, v in jp.items()}
    assert sorted(init) == list(DISTILLED_LEAVES)


def _buffers(seed=2):
    rng = np.random.default_rng(seed)
    bufs = {S: PKG[S].PairBuffer() for S in (J, T)}
    for n, b in [(8, 20), (16, 9)]:
        d = rng.integers(0, V, (b, n)).astype(np.int32)
        x = np.where(rng.uniform(size=(b, n)) < 0.3, 2, d).astype(np.int32)
        t0 = rng.uniform(0.5, 0.9, b)
        for buf in bufs.values():
            buf.add_batch(d, x, t0)
    return bufs


def test_train_distilled_matches_jax():
    bufs = _buffers()
    jp = head(J)[1]
    tp = head(T)[1]
    jparams, jrep = JD.train_distilled(head(J)[0], bufs[J], key=jax.random.key(0), params=jp,
                                       epochs=2, batch_size=16, seed=4)
    tparams, trep = TD.train_distilled(head(T)[0], bufs[T], params=tp, epochs=2,
                                       batch_size=16, seed=4, device="cpu")
    assert (trep.steps, trep.pairs, trep.epochs) == (jrep.steps, jrep.pairs, jrep.epochs)
    assert trep.steps == 6              # (16 + 4 rows at 8, 9 at 16) x 2 epochs
    for k in DISTILLED_LEAVES:
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), atol=1e-5,
                                   rtol=0, err_msg=k)
        assert not tparams[k].requires_grad
    for f in ("first_loss", "final_loss", "final_agreement"):
        assert getattr(trep, f) == pytest.approx(getattr(jrep, f), abs=1e-5)
    # the given params are copied, not trained in place
    np.testing.assert_array_equal(tp["w1"].numpy(), _HEAD_PARAMS["w1"])
    with pytest.raises(ValueError, match="empty"):
        TD.train_distilled(head(T)[0], TD.PairBuffer(), device="cpu")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_round_trip_across_packages(tmp_path, writer):
    jm, jp = head(J)
    tm, tp = head(T)
    jp = {k: v + 0.01 * np.arange(np.size(v), dtype=np.float32).reshape(np.shape(v))
          for k, v in jp.items()}
    tp = jax_distilled_params_to_torch({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    d = tmp_path / "head"
    assert not TD.distilled_checkpoint_exists(d) and not JD.distilled_checkpoint_exists(d)
    if writer == "jax":
        JD.save_distilled(str(d), jp, step=7)
        got = TD.restore_distilled(d, tm, device="cpu")
        for k in DISTILLED_LEAVES:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(jp[k]))
            assert got[k].shape == tp[k].shape
    else:
        TD.save_distilled(d, tp, step=7)
        got = JD.restore_distilled(str(d), jm)
        for k in DISTILLED_LEAVES:
            np.testing.assert_array_equal(np.asarray(got[k]), tp[k].numpy())
        again = TD.restore_distilled(d, tm, device="cpu")
        for k in DISTILLED_LEAVES:
            assert torch.equal(again[k], tp[k])
    assert TD.distilled_checkpoint_exists(d)


def test_distill_keys_match_jax():
    seeds = np.array([0, 1, 7, 2**31 - 1, 0, 0], np.int32)
    idx = np.array([0, 3, 1, 5, -1, -4], np.int32)
    want = np.asarray(jax.random.key_data(jax_distill_keys(jnp.asarray(seeds),
                                                           jnp.asarray(idx))))
    got = _derive_distill_keys(seeds, idx).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_constructor_takes_the_distilled_keywords_as_jax():
    model, params = head(T)
    with pytest.raises(ValueError, match="distilled_model"):
        make(T).submit(seq_len=8, tier="distilled")
    with pytest.raises(ValueError, match="t0_policy"):
        make(T, t0_policy=None, with_head=True)
    with pytest.raises(ValueError, match="distilled_nfe"):
        make(T, with_head=True, distilled_nfe=3)
    with pytest.raises(NotImplementedError, match="mesh"):
        make(T, mesh=object())
    sched = make(T, with_head=True, pair_buffer=TD.PairBuffer())
    assert sched.distilled_accept_score == sched.accept_score == 0.9


# -- the scheduler: the four scenarios ------------------------------------------------

def test_batch_distilled_served_behind_a_splitting_floor_and_harvest():
    """Scenario 1 on the batch path, with a pair buffer attached: every
    guaranteed refine (here the fallbacks' round) harvests the same rows on
    both sides, and the harvested refined rows hold the served tokens."""
    routed = set(range(6))
    thr = floor_between(REQS, routed)
    bufs = {}

    def run(S):
        bufs[S] = PKG[S].PairBuffer()
        return batch_view(S, distilled(REQS, routed), with_head=True, pair_buffer=bufs[S],
                          distilled_accept_score=thr)

    view, rep, _, keys = both(run)
    d = rep["distilled"]
    assert d["requests"] == 6 and 0 < d["served"] < 6 and d["served"] + d["fallbacks"] == 6
    assert d["min_served_score"] >= thr
    assert any(key.endswith("'distilled')") for key in keys)
    fell_back = []
    for rid, (toks, nfe, t0, *_) in view.items():
        if nfe == 1:
            assert float(torch_scorer(np.asarray(toks)).min()) >= thr
        else:
            assert nfe == warm_nfe(20, t0)
            fell_back += [tuple(t) for t in toks]
    assert bufs[T].stats() == bufs[J].stats() and len(bufs[T]) == len(fell_back)
    snap = bufs[T].snapshot()
    for n, arrs in bufs[J].snapshot().items():
        for a, b in zip(snap[n], arrs):
            np.testing.assert_array_equal(a, b)
    assert set(fell_back) <= {tuple(r) for _, x, _ in snap.values() for r in x}


def test_all_fall_back_bit_identical_to_all_guaranteed():
    """Scenario 2: floor +100, every distilled request falls back; the stream
    equals JAX's and an all-guaranteed stream (tokens, NFE, t0, statuses),
    and so does the batch path."""
    on, rep, *_ = both(stream_view, distilled(REQS, set(range(6))), with_head=True,
                       distilled_accept_score=100.0)
    off = stream_view(T, REQS)[0]
    assert rep["distilled"]["fallbacks"] == 6 and rep["terminal"]["distilled"] == 0
    assert rep["conservation"]["balanced"] and rep["num_requests"] == 6
    assert {i[0]: i[1:4] + (i[7],) for i in on} == {i[0]: i[1:4] + (i[7],) for i in off}
    b_on, b_rep, *_ = batch_view(T, distilled(REQS, set(range(6))), with_head=True,
                                 distilled_accept_score=100.0)
    b_off = batch_view(T, REQS)[0]
    assert b_rep["distilled"]["fallbacks"] == 6 and b_rep["distilled"]["served"] == 0
    assert {r: v[:3] for r, v in b_on.items()} == {r: v[:3] for r, v in b_off.items()}


def test_guaranteed_untouched_by_interleaved_distilled_traffic():
    """Scenario 3: guaranteed tokens with distilled traffic interleaved equal
    the guaranteed requests served alone."""
    routed = {1, 3, 5}
    mixed, *_ = both(stream_view, distilled(REQS, routed), with_head=True,
                     distilled_accept_score=-100.0)
    alone = stream_view(T, [r for i, r in enumerate(REQS) if i not in routed])[0]
    mixed_tok = {i[0]: i[1] for i in mixed}
    # alone, the guaranteed requests are numbered 0..2 in submission order
    for j, rid in enumerate(i for i in range(6) if i not in routed):
        assert mixed_tok[rid] == [i for i in alone if i[0] == j][0][1]
    assert all(i[7] == "distilled" for i in mixed if i[0] in routed)


def test_stream_everything_on_matches_jax(tmp_path):
    """Scenario 4: the distilled tier (K = 2), speculative accept and the
    tracer in one stream, on both sides. Unlike ``tests/test_distill.py``'s
    everything-on test, which routes the odd requests but splits its floor
    over all six requests' minima (so that no routed request falls below
    it, and its ``fallbacks > 0`` fails), the floor here is split over the
    routed requests' own minima: the even ones, since the odd ones' minima
    are all equal. Both outcomes then occur, on both sides."""
    routed = {0, 2, 4}
    thr = floor_between(REQS, routed, distilled_nfe=2)
    tracers = {}

    def run(S):
        tracers[S] = PKG_OBS[S].SpanTracer()
        return stream_view(S, distilled(REQS, routed), tracer=tracers[S], with_head=True,
                           speculative=True, accept_score=0.25, distilled_nfe=2,
                           distilled_accept_score=thr)

    items, rep, *_ = both(run)
    d = rep["distilled"]
    assert d["served"] > 0 and d["fallbacks"] > 0 and d["min_served_score"] >= thr
    assert rep["conservation"]["balanced"] and sum(rep["terminal"].values()) == 6
    assert rep["accepted_draft"] > 0
    assert all(i[2] == 2 for i in items if i[7] == "distilled")
    # the guaranteed half equals the same stream with the tier off
    off = {i[0]: i for i in stream_view(T, REQS, speculative=True, accept_score=0.25)[0]}
    for i in items:
        if i[0] not in routed:
            assert i[1:3] + (i[7],) == off[i[0]][1:3] + (off[i[0]][7],)
    docs = {}
    for S in (J, T):
        docs[S] = PKG_OBS[S].write_chrome_trace(str(tmp_path / f"{S.__name__}.json"), tracers[S])
        assert PKG_OBS[S].validate_trace(docs[S], expected_requests=6) == []
    fb = [e for e in docs[T]["traceEvents"] if e.get("name") == "request_fallback"]
    assert len(fb) == d["fallbacks"]
    structure = {S: [(e["ph"], e["name"], e.get("tid"), e.get("id"),
                      e.get("args", {}).get("status")) for e in docs[S]["traceEvents"]]
                 for S in (J, T)}
    assert structure[T] == structure[J]


def test_oversize_distilled_request_downgrades():
    """As ``tests/test_distill.py`` holds JAX's: a distilled request that must
    split serves guaranteed, its sibling distilled."""
    sched = make(T, with_head=True, max_rows=4, distilled_accept_score=-100.0)
    reqs = [T.ServeRequest(request_id=0, seq_len=8, num_samples=6, seed=3, tier="distilled"),
            T.ServeRequest(request_id=1, seq_len=8, num_samples=2, seed=4, tier="distilled")]
    items = {c.request_id: c for c in sched.serve_stream(reqs, clock=FakeClock())}
    rep = sched.stream_report
    assert (items[0].status, items[0].chunks, items[0].nfe) == \
        ("completed", 2, warm_nfe(20, items[0].t0))
    assert (items[1].status, items[1].nfe) == ("distilled", 1)
    assert rep["distilled"]["oversize_downgrades"] == 1 and rep["conservation"]["balanced"]
