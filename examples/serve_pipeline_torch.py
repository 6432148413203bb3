"""Batched warm-start serving on the port, the torch twin of
``examples/serve_pipeline.py``: the one-shot WarmStartServer engine (draft
-> DFM flow refine, the refine one CUDA graph replay on the card) with
per-request-batch guarantee reports, then the continuous-batching
WarmStartScheduler serving a mixed-size request stream through bucketed
micro-batches with the draft/refine stages overlapped, an overload stanza
(depth-bounded admission queue shedding lowest-priority-first,
cancellation, and per-request timeouts, with exact terminal-status
conservation), a telemetry stanza (live metrics-delta lines mid-stream +
an end-of-run per-stage span breakdown from the `repro_torch.obs` tracer),
and finally the drafting subsystem: KV-cached row-keyed AR drafts +
measured cost ratio + per-request quality-adaptive t0.

Run:  PYTHONPATH=src python examples/serve_pipeline_torch.py [--device cpu] [--steps 250]
(or the launcher: PYTHONPATH=src python -m repro_torch.launch.serve)
"""

import argparse
import threading
import time

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.base import RunConfig
from repro_torch.configs.dfm_dit import tiny_config
from repro_torch.core import CorruptionDraft, KNNRefinementCoupling, WarmStartPath, pair_iterator
from repro_torch.core.guarantees import speedup_report
from repro_torch.data import TEXT_VOCAB, SyntheticCorpus, decode
from repro_torch.drafting import (
    AdaptiveT0Policy, ARDraftEngine, LSTMDraftAdapter, fit_t0_calibration,
    make_quality_scorer,
)
from repro_torch.models import LSTMConfig, LSTMModel, build_model
from repro_torch.obs import PeriodicMetricsLogger, SpanTracer, stage_breakdown, to_trace_events
from repro_torch.optim import AdamW
from repro_torch.serving import (
    AdmissionQueue, QueueFull, WarmStartScheduler, WarmStartServer, corruption_draft,
)
from repro_torch.training import Trainer

SEQ = 48
COLD_NFE = 40
T0 = 0.8
STEPS = 250
LSTM_STEPS = 120


def tensors(tree):
    """The tensors of a parameter tree (nested dicts and lists), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [t for x in items for t in tensors(x)]


def train_lstm(lstm, lparams, data, steps, batch, lr, rng, device, log_every=0):
    """``steps`` AdamW steps on ``lstm.loss`` over random corpus rows (the
    JAX twin's ``value_and_grad`` loop), the parameters updated in place."""
    leaves = {str(i): [p.requires_grad_()] for i, p in enumerate(tensors(lparams))}
    opt = AdamW(learning_rate=lr)
    ostate = opt.init(leaves)
    for i in range(steps):
        idx = rng.integers(0, data.shape[0], size=batch)
        loss = lstm.loss(lparams, torch.from_numpy(data[idx]).to(device))
        grads = torch.autograd.grad(loss, [ps[0] for ps in leaves.values()])
        _, ostate = opt.update({k: [g] for k, g in zip(leaves, grads)}, ostate, leaves)
        if log_every and (i + 1) % log_every == 0:
            print(f"   lstm step {i + 1}: nll={float(loss):.3f}")
    for ps in leaves.values():
        ps[0].requires_grad_(False)
    return lparams


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    device = args.device

    corpus = SyntheticCorpus(seed=0)
    data = corpus.sequences(2048, SEQ, seed=1)
    rng = np.random.default_rng(0)

    cfg = tiny_config(vocab_size=TEXT_VOCAB, seq_len=SEQ)
    model = build_model(cfg, device=device, seed=0)

    # corruption draft plays the lightweight-model role for a fast demo
    draft = CorruptionDraft(data=data, vocab_size=TEXT_VOCAB, corruption=0.25, device=device)
    drafts = draft.generate(prng.key(1), 1024).cpu().numpy()
    src, tgt = KNNRefinementCoupling(k=2, k_inject=2).build(data, drafts, rng)

    print("training WS-DFM flow model ...")
    run = RunConfig(total_steps=args.steps, batch_size=32, learning_rate=1e-3,
                    warmup_steps=20, log_every=100, t0=T0)
    trainer = Trainer(model, cfg, run, path=WarmStartPath(t0=T0))
    state = trainer.init_state()
    state = trainer.fit(state, pair_iterator(src, tgt, 32, rng),
                        log_fn=lambda i, m: print(f"  step {i}: ce={m['ce']:.3f}"))

    server = WarmStartServer(
        flow_model=model, flow_cfg=cfg,
        draft_generate=lambda key, num: draft.generate(key, num),
        path=WarmStartPath(t0=T0), cold_nfe=COLD_NFE, device=device,
    )

    for batch_id, batch_size in enumerate((4, 8, 16)):
        out, report = server.serve(prng.key(100 + batch_id), batch_size)
        rep = report["speedup_report"]
        print(f"\nrequest batch {batch_id} (n={batch_size}): "
              f"nfe={report['nfe']}/{report['cold_nfe']} "
              f"guaranteed=x{rep.guaranteed_factor:.1f} "
              f"draft={report['draft_time_s']*1e3:.0f}ms "
              f"flow={report['flow_time_s']*1e3:.0f}ms")
        print("  sample:", decode(out[0].cpu().numpy()))

    # --- continuous batching: mixed-size request stream -------------------
    # a SpanTracer records every pipeline stage (the default is a no-op
    # NullTracer); the scheduler's MetricsRegistry is always on: the
    # stream reports below are derived from it
    print("\ncontinuous-batching scheduler (mixed seq lens, t0 overrides) ...")
    tracer = SpanTracer(capacity=16384)
    sched = WarmStartScheduler(
        flow_model=model,
        draft_fn=corruption_draft(data, TEXT_VOCAB, corruption=0.25, device=device),
        cold_nfe=COLD_NFE, default_t0=T0, max_rows=16,
        max_bucket=32,   # largest pow2 the SEQ=48 model's positions cover
        tracer=tracer, device=device,
    )
    sizes = np.random.default_rng(7)
    for i in range(12):
        sched.submit(seq_len=int(sizes.integers(8, 33)),
                     num_samples=int(sizes.integers(1, 4)),
                     seed=1000 + i,
                     t0=None if i % 3 else 0.9)
    results, rep = sched.run()
    print(f"  {rep['num_requests']} requests -> {rep['num_micro_batches']} "
          f"micro-batches, {rep['requests_per_s']:.2f} req/s, "
          f"overlap_eff={rep['overlap_efficiency']:.2f}, "
          f"jit cache {rep['jit_cache']}")
    for rid in sorted(results)[:3]:
        r = results[rid]
        print(f"  [{rid}] nfe={r.nfe} t0={r.t0} bucket={r.bucket_len}: "
              f"{decode(r.tokens[0])}")

    # --- streaming + SLO-aware admission ----------------------------------
    # same engine, but results are YIELDED as each micro-batch finishes
    # (bit-identical tokens to the batch path), while an AdmissionQueue
    # keeps accepting requests mid-serve; partial buckets flush when a
    # request's latency SLO would otherwise be blown
    print("\nstreaming serve (5s SLO, open admission) ...")
    queue = AdmissionQueue()
    arr = np.random.default_rng(8)

    def replay():
        for i in range(8):
            time.sleep(float(arr.exponential(0.02)))
            queue.submit(seq_len=int(arr.integers(8, 33)), seed=2000 + i)
        queue.close()

    # periodic telemetry: counter-delta lines from the live registry
    # while the stream is in flight (what --metrics-interval-s prints)
    mlog = PeriodicMetricsLogger(sched.metrics, interval_s=0.5,
                                 sink=lambda line: print(f"  {line}"))
    mlog.start()
    producer = threading.Thread(target=replay)
    producer.start()
    for res in sched.serve_stream(source=queue, slo_ms=5000.0, idle_timeout_s=0.01):
        print(f"  [{res.request_id}] latency={res.latency_s * 1e3:.0f}ms "
              f"slo_met={res.slo_met} flush={res.flush_reason}: "
              f"{decode(res.tokens[0])}")
    producer.join()
    mlog.stop()
    srep = sched.stream_report
    print(f"  first result {srep['time_to_first_result_s'] * 1e3:.0f}ms "
          f"after first admission, p95 latency "
          f"{srep['latency_s']['p95'] * 1e3:.0f}ms, SLO attainment "
          f"{srep['slo_attainment']:.0%}, flushes {srep['flush_reasons']}")

    # --- overload hardening: bounded admission + priorities + timeouts ----
    # the same stream loop under pressure: a depth-bounded AdmissionQueue
    # sheds lowest-priority-first when bursts overflow it, a premium
    # request is never shed before a best_effort one, one request is
    # cancelled mid-flight and one carries a tight timeout: every
    # admitted request resolves to exactly ONE terminal status
    # (completed / shed / cancelled / timed_out / failed) in the report
    print("\noverload demo (queue depth 4, mixed priorities, cancel+timeout) ...")
    queue = AdmissionQueue(max_depth=4)
    classes = ("premium", "standard", "best_effort")

    def overload_replay():
        cancel_me = None
        for i in range(16):          # burst: no pacing, overflow the queue
            try:
                # cancel/timeout targets are premium so shedding (which
                # never touches premium first) can't steal the demo
                rid = queue.submit(
                    seq_len=int(arr.integers(8, 33)), seed=3000 + i,
                    priority=classes[i % 3],
                    timeout_s=0.001 if i == 6 else None)  # 6 -> TIMED_OUT
                if i == 3:
                    cancel_me = rid
            except QueueFull:
                pass                 # rejected: counted in the ledger
        if cancel_me is not None:
            queue.cancel(cancel_me)  # -> CANCELLED, siblings bit-identical
        queue.close()

    producer = threading.Thread(target=overload_replay)
    producer.start()
    for res in sched.serve_stream(source=queue, slo_ms=5000.0, idle_timeout_s=0.01):
        tail = "" if res.status == "completed" else f" -> {res.status.upper()}"
        print(f"  [{res.request_id}] {res.priority}{tail}")
    producer.join()
    srep = sched.stream_report
    cons = srep["conservation"]
    print(f"  admission {srep['admission']}")
    print(f"  terminal {srep['terminal']} "
          f"(conservation {'OK' if cons['balanced'] else 'BROKEN'})")
    for cls, crep in srep["by_class"].items():
        att = crep["slo_attainment"]
        print(f"  {cls}: completed={crep['completed']} shed={crep['shed']} "
              f"attainment={'-' if att is None else format(att, '.0%')}")

    # --- telemetry: per-stage breakdown from the recorded spans -----------
    # every request above (completed, shed, timed out, cancelled) carries
    # a complete admission->terminal flow chain in these records
    print("\ntelemetry (spans recorded across the streaming demos) ...")
    for row in stage_breakdown(to_trace_events(tracer.records())):
        print(f"  {row['track']:>15s}/{row['name']:<16s} n={row['count']:<3d} "
              f"total={row['total_ms']:7.1f}ms mean={row['mean_ms']:6.1f}ms")
    n_chains = sum(1 for r in tracer.records() if r.name == "request_terminal")
    print(f"  {tracer.emitted} records ({n_chains} request chains, "
          f"{tracer.dropped} dropped); write a Perfetto-loadable file "
          f"with repro_torch.launch.serve --trace-out trace.json")

    # --- drafting subsystem: AR-KV drafts + adaptive t0 -------------------
    print("\ndrafting subsystem (KV-cached AR drafts, quality-adaptive t0) ...")
    # a small LSTM draft model, briefly trained on the corpus
    lstm = LSTMModel(LSTMConfig(vocab_size=TEXT_VOCAB, hidden=96, num_layers=1, embed_dim=48))
    lparams = train_lstm(lstm, lstm.init(7, device=device), data, LSTM_STEPS, 16, 1e-2, rng,
                         device)
    engine = ARDraftEngine(LSTMDraftAdapter(model=lstm, params=lparams), max_len=32)

    # measured (not assumed) draft cost against one backbone NFE
    draft_model = CorruptionDraft(data=data[:, :32], vocab_size=TEXT_VOCAB, corruption=0.25,
                                  device=device)
    probe_x = torch.zeros((8, 32), dtype=torch.int32, device=device)
    probe_t = torch.full((8,), T0, dtype=torch.float32, device=device)

    def one_nfe():
        with torch.no_grad():
            return model.dfm_apply(probe_x, probe_t)

    cost = draft_model.calibrate_cost_ratio(one_nfe, rng=prng.key(3), num=8, seq_len=32)
    rep_measured = speedup_report(COLD_NFE, T0, draft_cost_ratio=draft_model.cost_ratio)
    print(f"  measured draft cost_ratio={cost.cost_ratio:.3f} NFE -> "
          f"effective speedup {rep_measured.effective_speedup:.2f}x "
          f"(guaranteed {rep_measured.guaranteed_factor:.2f}x)")

    # quality-adaptive per-request t0, calibrated from the corruption
    # tiers; the tier floor equals the training t0 (T0) so every served
    # t >= T0 stays in-distribution for this flow model
    scorer = make_quality_scorer(model.dfm_apply, device=device)
    calib = fit_t0_calibration(scorer, data[:, :32], TEXT_VOCAB,
                               tiers=((0.05, 0.9), (0.3, 0.85), (0.6, T0)), device=device)
    policy = AdaptiveT0Policy(scorer=scorer, calibration=calib)
    sched = WarmStartScheduler(
        flow_model=model, draft_fn=engine.as_draft_fn(),
        cold_nfe=COLD_NFE, default_t0=T0, max_rows=16, max_bucket=32,
        t0_policy=policy, device=device,
    )
    for i in range(10):
        sched.submit(seq_len=int(sizes.integers(8, 33)),
                     num_samples=1, seed=2000 + i)     # t0=None -> adaptive
    results, rep = sched.run()
    print(f"  adaptive t0 histogram: {rep['policy']['t0_histogram']}")
    print(f"  mean NFE {rep['mean_request_nfe']:.1f} "
          f"(fixed worst-tier t0={calib.t0_floor} would cost "
          f"{speedup_report(COLD_NFE, calib.t0_floor).warm_nfe})")
    print(f"  draft engine stats: {engine.stats.as_dict()}")
    for rid in sorted(results)[:3]:
        r = results[rid]
        print(f"  [{rid}] t0={r.t0:.2f} nfe={r.nfe}: {decode(r.tokens[0])}")


if __name__ == "__main__":
    main()
