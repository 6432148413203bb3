"""The port's observability copies against the JAX package's: the same
sequence of operations on a metrics registry and a span tracer gives the
same snapshots, deltas, sums, text dumps and records (timestamps aside),
and metric keys round-trip through ``parse_metric_key``."""

import json

import numpy as np
import pytest

from repro import obs as jax_obs
from repro_torch import obs


def _drive_registry(mod, ops):
    reg = mod.MetricsRegistry()
    snaps = []
    for op, name, value, labels in ops:
        if op == "counter":
            reg.counter(name, **labels).inc(value)
        elif op == "gauge_set":
            reg.gauge(name, **labels).set(value)
        elif op == "gauge_add":
            reg.gauge(name, **labels).add(value)
        elif op == "hist":
            reg.histogram(name, buckets=(0.5, 1, 2, 4), **labels).observe(value)
        else:
            snaps.append(reg.snapshot())
    return reg, snaps


def _ops(seed):
    rng = np.random.default_rng(seed)
    names = ["serve.terminal", "jit_cache.per_key", "admission.offered", "serve.flush"]
    ops = []
    for _ in range(200):
        kind = rng.choice(["counter", "gauge_set", "gauge_add", "hist", "snap"],
                          p=[0.5, 0.15, 0.1, 0.2, 0.05])
        labels = {}
        if rng.random() < 0.7:
            labels["status"] = str(rng.choice(["completed", "shed", "failed"]))
        if rng.random() < 0.4:
            labels["key"] = "x".join(str(int(v)) for v in rng.integers(1, 64, 3))
        ops.append((str(kind), str(rng.choice(names)), int(rng.integers(1, 5))
                    if kind == "counter" else float(rng.normal() * 3), labels))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_sequence_matches_jax(seed):
    ops = _ops(seed)
    jreg, jsnaps = _drive_registry(jax_obs, ops)
    reg, snaps = _drive_registry(obs, ops)
    assert snaps == jsnaps
    assert reg.snapshot() == jreg.snapshot()
    base = snaps[0] if snaps else None
    assert reg.counter_deltas(base) == jreg.counter_deltas(base)
    assert reg.sum_counters("serve.terminal", status="shed") == \
        jreg.sum_counters("serve.terminal", status="shed")
    assert reg.render_text() == jreg.render_text()


def test_dump_json_matches_jax(tmp_path):
    ops = _ops(3)
    jreg, _ = _drive_registry(jax_obs, ops)
    reg, _ = _drive_registry(obs, ops)
    jreg.dump_json(str(tmp_path / "j.json"))
    reg.dump_json(str(tmp_path / "t.json"))
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    json.loads((tmp_path / "t.json").read_text())


@pytest.mark.parametrize("name,labels", [
    ("jit_cache.hits", {}),
    ("jit_cache.per_key", {"key": "16x4x4", "kind": "hit"}),
    ("serve.terminal", {"status": "completed", "priority": "premium"}),
    ("serve.slo_total", {"priority": "standard", "served": False}),
    ("admission.shed_by_class", {"queue": "q3", "priority": "best_effort"}),
])
def test_metric_key_round_trips(name, labels):
    key = obs.metric_key(name, labels)
    assert key == jax_obs.metric_key(name, labels)
    assert obs.parse_metric_key(key) == jax_obs.parse_metric_key(key)
    assert obs.parse_metric_key(key) == (name, {k: str(v) for k, v in labels.items()})


def _drive_tracer(mod, capacity):
    tr = mod.SpanTracer(capacity=capacity)
    for i in range(7):
        with tr.span("refine", track="refine_dispatch", bucket=8 * (i + 1)) as sp:
            sp["cache"] = "hit" if i % 2 else "miss"
        tr.instant("request_terminal", track="terminal", flow_id=i, flow_ph="f",
                   status="completed")
    return tr


@pytest.mark.parametrize("capacity", [4, 64])
def test_tracer_records_match_jax(capacity):
    jtr, tr = _drive_tracer(jax_obs, capacity), _drive_tracer(obs, capacity)

    def strip(recs):
        return [(r.name, r.track, r.ph, r.args, r.flow_id, r.flow_ph) for r in recs]

    assert strip(tr.records()) == strip(jtr.records())
    assert (len(tr), tr.emitted, tr.dropped) == (len(jtr), jtr.emitted, jtr.dropped)
    null = obs.NullTracer()
    with null.span("x") as sp:
        sp["a"] = 1
    null.instant("y")
    assert null.records() == [] and len(null) == 0
