"""The port's request batcher against the JAX package's on seeded random
request sets: ``pack_requests``, ``split_request``, ``FillingBucket`` and
the helpers give exactly the same micro-batches, chunks and decisions, and
the scheduler's per-row key derivation gives JAX's key words, negative
padding indices included."""

import dataclasses

import jax
import numpy as np
import pytest

from repro.serving import batcher as jb
from repro.serving.scheduler import _derive_row_keys as jax_derive_row_keys
from repro_torch.serving import batcher as tb
from repro_torch.serving.scheduler import _derive_row_keys


def _requests(mod, seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t0 = [None, 0.5, 0.8, 0.85, 0.9][int(rng.integers(0, 5))]
        rows = int(rng.integers(1, 9))
        row_t0s = ()
        if t0 is not None and rng.random() < 0.3:
            row_t0s = tuple(float(v) for v in rng.choice([t0, t0 + 0.02, t0 + 0.05], rows))
            row_t0s = tuple(sorted(row_t0s))
            t0 = min(row_t0s)
        out.append(mod.ServeRequest(
            request_id=i, seq_len=int(rng.integers(1, 100)), num_samples=rows,
            seed=int(rng.integers(0, 2 ** 31)), t0=t0, row_t0s=row_t0s,
            priority=str(rng.choice(jb.PRIORITY_CLASSES)),
            arrival_s=float(rng.random()), timeout_s=None))
    return out


def _fields(req):
    return {f.name: getattr(req, f.name) for f in dataclasses.fields(req)
            if f.name != "cancel_token"}


def _mb(mb):
    return (mb.bucket_len, mb.t0, mb.n_steps, mb.padded_rows, mb.t0_spans, mb.row_t0_spans,
            mb.tier, mb.compile_key, mb.rows, tuple(mb.row_t0s), tuple(mb.row_mask),
            tuple((s.request.request_id, s.row_offset, s.rows) for s in mb.spans))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kw", [
    dict(t0_bin_width=0.0), dict(t0_bin_width=0.1),
    dict(t0_bin_width=0.05, max_rows=16, row_quantum=8, min_bucket=16),
    dict(max_rows=24, row_quantum=4, row_multiple=3, max_bucket=128),
])
def test_pack_requests_matches_jax(seed, kw):
    args = dict(cold_nfe=20, default_t0=0.8, **kw)
    want = jb.pack_requests(_requests(jb, seed), **args)
    got = tb.pack_requests(_requests(tb, seed), **args)
    assert [_mb(m) for m in got] == [_mb(m) for m in want]


@pytest.mark.parametrize("max_rows,unit", [(8, 4), (16, 4), (12, 3), (7, 1)])
def test_split_request_matches_jax(max_rows, unit):
    ids_j, ids_t = iter(range(1000, 2000)), iter(range(1000, 2000))
    for n, row_t0s in ((40, ()), (9, ()), (13, tuple(0.5 + 0.01 * i for i in range(13)))):
        kw = dict(request_id=5, seq_len=12, num_samples=n, seed=9,
                  t0=min(row_t0s) if row_t0s else 0.7, row_t0s=row_t0s)
        want = jb.split_request(jb.ServeRequest(**kw), max_rows=max_rows, unit=unit,
                                alloc_id=lambda: next(ids_j))
        got = tb.split_request(tb.ServeRequest(**kw), max_rows=max_rows, unit=unit,
                               alloc_id=lambda: next(ids_t))
        assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert tb.usable_rows(max_rows, unit) == jb.usable_rows(max_rows, unit)


def test_filling_bucket_decisions_match_jax():
    def drive(mod):
        rng = np.random.default_rng(4)
        fb, log = mod.FillingBucket(16), []
        for i in range(30):
            tok = mod.CancelToken()
            req = mod.ServeRequest(request_id=i, seq_len=12, num_samples=int(rng.integers(1, 5)),
                                   seed=i, arrival_s=0.01 * i, cancel_token=tok,
                                   timeout_s=0.05 if i % 7 == 3 else None)
            if i % 5 == 4:
                tok.cancel()
            log.append(fb.would_overflow(req.num_samples, max_rows=16, unit=4))
            fb.add(req, deadline_s=None if i % 3 else 0.01 * i + 0.2)
            now = 0.01 * i + 0.005
            log.append((fb.state, fb.rows, fb.oldest_deadline_s, fb.flush_decision(
                now, est_latency_s=0.02, idle_timeout_s=0.03, max_rows=16, unit=4)))
            if i % 4 == 3:
                log.append([(r.request_id, s) for r, s in fb.prune(now + 0.1)])
            if i % 10 == 9:
                log.append([r.request_id for r in fb.flush()])
                fb = mod.FillingBucket(16)
        return log

    assert drive(tb) == drive(jb)


@pytest.mark.parametrize("seq_len", [1, 7, 8, 9, 63, 64, 65, 200])
def test_helpers_match_jax(seq_len):
    assert tb.bucket_seq_len(seq_len, min_bucket=8) == jb.bucket_seq_len(seq_len, min_bucket=8)
    assert tb.pad_rows(seq_len, 4) == jb.pad_rows(seq_len, 4)
    for t0 in (0.0, 0.3, 0.8, 0.85, 1 - 1e-12):
        for w in (0.0, 0.1, 1e-4):
            assert tb.t0_bin(t0, w) == jb.t0_bin(t0, w)
    for cls in jb.PRIORITY_CLASSES:
        assert tb.priority_rank(cls) == jb.priority_rank(cls)
    assert (tb.TERMINAL_STATUSES, tb.TIERS, tb.PRIORITY_CLASSES) == \
        (jb.TERMINAL_STATUSES, jb.TIERS, jb.PRIORITY_CLASSES)
    assert (tb.DRAFT_STREAM, tb.FLOW_STREAM, tb.DISTILL_STREAM) == \
        (jb.DRAFT_STREAM, jb.FLOW_STREAM, jb.DISTILL_STREAM)


@pytest.mark.parametrize("kw", [dict(seed=-1), dict(num_samples=0), dict(t0=1.0),
                                dict(priority="gold"), dict(tier="cheap"),
                                dict(timeout_s=0.0), dict(row_t0s=(0.5,), t0=0.6)])
def test_serve_request_validation_matches_jax(kw):
    args = dict(request_id=0, seq_len=4, **kw)
    with pytest.raises(ValueError):
        jb.ServeRequest(**args)
    with pytest.raises(ValueError):
        tb.ServeRequest(**args)


def test_derive_row_keys_match_jax_including_negative_padding_indices():
    seeds = np.array([0, 1, 7, 2 ** 31 - 1, 0, 0, 0, 123456], np.int32)
    idx = np.array([0, 3, 1, 5, -1, -2, -8, 2 ** 31 - 1], np.int32)
    jd, jf = jax_derive_row_keys(seeds, idx)
    d, f = _derive_row_keys(seeds, idx)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jax.random.key_data(jd), np.int64))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jax.random.key_data(jf), np.int64))
    # a padding row's stream never equals a real row's of the same seed
    assert not (f[4:7, None] == f[None, :4]).all(-1).any()
