"""The port's Chrome-trace export (``repro_torch.obs.export``) against the
JAX package's on the same span records, and the serve launcher
(``repro_torch.launch.serve``): its flags against the JAX launcher's, and
its distilled tier end to end on the CPU at a small size. Exact."""

import argparse
import json

import numpy as np
import pytest
import torch

import repro.obs as JO
import repro_torch.obs as TO
from repro_torch.launch import serve


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread for these smoke-size models: the suite runs in
    several worker processes at once, where torch's default of a thread a
    core makes each small op wait on the others' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def records(O, seed=0):
    """Span records of a small serve: admissions, packing, a fallback hop,
    spans on several tracks (one unknown to the export's track order) and
    terminals, one request left without its terminal."""
    rng = np.random.default_rng(seed)
    out = []
    t = 0.0
    for rid in range(5):
        t += float(rng.uniform(0.001, 0.01))
        out.append(O.SpanRecord("request_admitted", "admission", t, ph="i",
                                args={"request_id": rid}, flow_id=rid, flow_ph="s"))
    for rid in range(5):
        t += float(rng.uniform(0.001, 0.01))
        out.append(O.SpanRecord("request_packed", "flush", t, ph="i",
                                args={"request_id": rid, "bucket": 8}, flow_id=rid,
                                flow_ph="t"))
    for name, track in [("draft", "draft_worker"), ("refine", "refine_dispatch"),
                        ("distill", "refine_dispatch"), ("scoring_prepass", "scoring"),
                        ("draft", "draft_worker"), ("custom", "my_track")]:
        t += float(rng.uniform(0.001, 0.01))
        out.append(O.SpanRecord(name, track, t, dur=float(rng.uniform(0.001, 0.05)),
                                args={"rows": int(rng.integers(1, 9))}))
    out.append(O.SpanRecord("request_fallback", "flush", t + 0.01, ph="i",
                            args={"request_id": 2, "score": -3.5}, flow_id=2, flow_ph="t"))
    for rid in range(4):
        t += float(rng.uniform(0.001, 0.01))
        out.append(O.SpanRecord("request_terminal", "terminal", t, ph="i",
                                args={"request_id": rid, "status": "completed"},
                                flow_id=rid, flow_ph="f"))
    return out


def test_trace_events_and_breakdown_match_jax():
    jev, tev = JO.to_trace_events(records(JO)), TO.to_trace_events(records(TO))
    assert tev == jev
    assert {e["args"]["name"] for e in tev if e["ph"] == "M"} >= {"my_track", "terminal"}
    assert TO.stage_breakdown({"traceEvents": tev}) == JO.stage_breakdown({"traceEvents": jev})
    assert TO.stage_breakdown(tev) == JO.stage_breakdown(jev)
    assert [r["name"] for r in TO.stage_breakdown(tev)][0] in ("refine", "distill", "draft",
                                                               "scoring_prepass", "custom")


@pytest.mark.parametrize("expected", [None, 4, 5])
def test_write_load_validate_match_jax(tmp_path, expected):
    docs = {}
    for name, O in (("jax", JO), ("torch", TO)):
        path = str(tmp_path / f"{name}.json")
        doc = O.write_chrome_trace(path, records(O, seed=1), metadata={"mode": "stream"})
        docs[name] = (doc, O.load_trace(path), O.validate_trace(O.load_trace(path), expected))
    assert docs["torch"][:2] == docs["jax"][:2]
    assert docs["torch"][0] == docs["torch"][1]
    assert docs["torch"][2] == docs["jax"][2]
    # request 4 was admitted and never ended; 5 chains is one too many
    assert docs["torch"][2] and any("request 4" in p for p in docs["torch"][2])
    broken = json.loads(json.dumps(docs["torch"][0]))
    first = next(i for i, e in enumerate(broken["traceEvents"]) if e["ph"] != "M")
    del broken["traceEvents"][first]["ts"]
    assert TO.validate_trace(broken) == JO.validate_trace(broken) != []
    assert TO.validate_trace({}) == JO.validate_trace({}) == ["traceEvents missing or not a list"]


def _jax_parser():
    """The JAX launcher's parser (its ``main`` builds it inline): ``main`` run
    until it parses, then stopped."""
    from repro.launch import serve as jax_serve

    class Parsed(Exception):
        pass

    def capture(self, args=None, namespace=None):
        raise Parsed(self)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = capture
    try:
        jax_serve.main()
    except Parsed as got:
        return got.args[0]
    finally:
        argparse.ArgumentParser.parse_args = orig
    raise AssertionError("the JAX launcher never parsed its arguments")


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, getattr(a, "choices", None))
            for a in parser._actions if a.dest != "help"}


def test_launcher_flags_are_jax_flags_plus_device():
    jax_flags = _flags(_jax_parser())
    port = vars(serve.parse_args([]))
    port_flags = {k: v for k, v in port.items() if k != "device"}
    assert port_flags == {k: v[1] for k, v in jax_flags.items()}
    assert port["device"] == "cuda"
    parser_actions = {}
    orig = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        parser_actions.update(_flags(self))
        return orig(self, args, namespace)

    argparse.ArgumentParser.parse_args = capture
    try:
        serve.parse_args([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    assert {k: v for k, v in parser_actions.items() if k != "device"} == jax_flags


def test_launcher_distilled_tier_checks_on_the_cpu(tmp_path, capsys):
    """The launcher's distilled tier at a small size: harvest, train, the
    two-pass floor, the stream with the tracer, ``--check-distilled``
    passing, a valid trace and a metrics snapshot; a head saved by the first
    run is restored by the second (batch path)."""
    trace, metrics, ckpt = (str(tmp_path / n) for n in ("t.json", "m.json", "head"))
    common = ["--device", "cpu", "--scheduler", "--draft", "ar-kv", "--tier", "distilled",
              "--check-distilled", "--train-steps", "2", "--num", "4", "--seq-len", "8",
              "--cold-nfe", "8", "--distill-ckpt", ckpt]
    serve.main(common + ["--stream", "--trace-out", trace, "--metrics-out", metrics])
    out = capsys.readouterr().out
    assert "check-distilled: OK" in out and "distilled head saved" in out
    doc = TO.load_trace(trace)
    assert TO.validate_trace(doc, expected_requests=4) == []
    fallbacks = [e for e in doc["traceEvents"] if e.get("name") == "request_fallback"]
    assert 0 < len(fallbacks) < 4
    assert "counters" in json.load(open(metrics))
    serve.main(common)
    out = capsys.readouterr().out
    assert "distilled head restored" in out and "check-distilled: OK" in out
