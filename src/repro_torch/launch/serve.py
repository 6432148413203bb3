"""Serving launcher: ``python -m repro_torch.launch.serve --t0 0.8 --num 8``

Torch port of the JAX package's ``launch/serve.py``, with the same flags
plus ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).
It trains a tiny draft LSTM (1 x 128) and the ``tiny_config`` DFM denoiser
on the synthetic corpus in-process (nothing is downloaded) and serves a
request set through the one-shot ``WarmStartServer``, or through
``WarmStartScheduler`` with ``--scheduler``, printing the guarantee
report.

Drafting modes:
  --draft ar-kv   drafts through the KV-cached row-keyed ``ARDraftEngine``
                  (pack-invariant) instead of the batch-keyed LSTM adapter;
  --t0 auto       per-request adaptive t0 from the quality probe and its
                  calibration (implies --scheduler);
  --t0 bandit     the contextual bandit over the calibrated t0 grid
                  (implies --scheduler);
  --speculative   requests whose every row clears the acceptance probe ship
                  their drafts with 0 refine NFE (needs --t0 auto/bandit;
                  auto is enabled when neither was asked for).

The distilled tier (implies --scheduler and an adaptive --t0 policy):
  --tier distilled          serve the set as ``tier="distilled"`` requests:
                            a few-step self-distilled head (trained on the
                            (draft, refined, t0) pairs of a guaranteed
                            warm-up pass, or restored from --distill-ckpt)
                            serves each request at NFE = K in {1, 2} behind
                            a probe-score quality floor; a request that
                            misses it falls back to the guaranteed path;
  --distill-ckpt DIR        restore the head from DIR if it holds a
                            checkpoint, else train one and save it there;
  --distilled-nfe K         the head's steps (1 or 2);
  --distilled-accept-score  the floor; default: two-pass calibration (pass 1
                            serves with the floor open and takes the median
                            split of the per-request minimum probe scores);
  --check-distilled         exit non-zero unless the tier served > 0, the
                            floor fell back > 0, the ledger conserved every
                            admission, and the distilled NFE is <= 2.

Streaming (implies --scheduler): --stream, --slo-ms, --arrival-rate (a
Poisson arrival replay), --queue-depth, --timeout-ms, --priority.

Telemetry (implies --scheduler): --trace-out F.json writes a Chrome
trace-event file (Perfetto) of the pipeline's spans and each request's
admission-to-terminal flow; --metrics-out dumps the metrics registry;
--metrics-interval-s prints live counter deltas while streaming.
"""

from __future__ import annotations

import argparse
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.base import RunConfig
from repro_torch.configs.dfm_dit import tiny_config
from repro_torch.core.coupling import KNNRefinementCoupling, pair_iterator
from repro_torch.core.paths import WarmStartPath
from repro_torch.data import TEXT_VOCAB, SyntheticCorpus, decode
from repro_torch.models import build_model
from repro_torch.models.lstm import LSTMConfig, LSTMModel
from repro_torch.optim.adamw import AdamW
from repro_torch.serving import WarmStartScheduler, WarmStartServer, batch_keyed_draft
from repro_torch.training import Trainer


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--t0", default="0.8",
                    help="warm-start time in [0,1), 'auto' for per-request quality-adaptive "
                         "t0, or 'bandit' for the online contextual-bandit policy")
    ap.add_argument("--speculative", action="store_true",
                    help="speculative draft-and-verify: accept requests whose every row's "
                         "probe score clears the acceptance threshold with zero refine steps "
                         "(implies --scheduler and an adaptive --t0 policy)")
    ap.add_argument("--accept-score", type=float, default=None,
                    help="speculative acceptance threshold on the probe score (default: the "
                         "calibration's top anchor)")
    ap.add_argument("--tier", choices=("guaranteed", "distilled"), default="guaranteed",
                    help="request class to serve: 'distilled' routes the set through the "
                         "few-step distilled head behind its quality floor (implies "
                         "--scheduler and an adaptive --t0 policy)")
    ap.add_argument("--distill-ckpt", default=None, metavar="DIR",
                    help="distilled-head checkpoint dir: restore from it when present, else "
                         "train on harvested pairs and save to it")
    ap.add_argument("--distilled-nfe", type=int, default=1,
                    help="distilled refiner steps K (1 or 2)")
    ap.add_argument("--distilled-accept-score", type=float, default=None,
                    help="probe-score quality floor for the distilled tier (default: two-pass "
                         "median-split calibration over the request set)")
    ap.add_argument("--check-distilled", action="store_true",
                    help="gate mode: exit non-zero unless the distilled tier served > 0, fell "
                         "back > 0, conserved every admission, and shipped at NFE <= 2")
    ap.add_argument("--per-row-t0", action="store_true",
                    help="per-row adaptive t0: rows of one request enter the shared refine "
                         "at their own calibrated step instead of the request-min t0")
    ap.add_argument("--cold-nfe", type=int, default=32)
    ap.add_argument("--num", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--train-steps", type=int, default=150)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fused-step", action="store_true",
                    help="use the ws_step kernel as the one-shot server's Euler step")
    ap.add_argument("--scheduler", action="store_true",
                    help="serve a mixed-size request stream through the continuous-batching "
                         "WarmStartScheduler instead of the one-shot WarmStartServer")
    ap.add_argument("--draft", choices=("lstm", "ar-kv"), default="lstm",
                    help="draft stage: 'lstm' = batch-keyed LSTM.generate adapter (demo), "
                         "'ar-kv' = row-keyed KV-cached ARDraftEngine (pack-invariant)")
    ap.add_argument("--stream", action="store_true",
                    help="stream results through the SLO-aware admission loop "
                         "(serve_stream) instead of end-of-run batch serving; implies "
                         "--scheduler")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="per-request latency SLO in ms (streaming mode): partial buckets "
                         "flush when a deadline would blow")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson arrival replay rate in requests/s for --stream (0 = admit "
                         "everything up front)")
    ap.add_argument("--queue-depth", type=int, default=0,
                    help="bound the streaming admission queue at this many requests: "
                         "overflow sheds the lowest priority class (or rejects) "
                         "(0 = unbounded)")
    ap.add_argument("--timeout-ms", type=float, default=0.0,
                    help="per-request latency budget in ms for --stream: an expired request "
                         "resolves TIMED_OUT (0 = no timeout)")
    ap.add_argument("--priority", choices=("premium", "standard", "best_effort"),
                    default="standard",
                    help="priority class for the streamed requests")
    ap.add_argument("--trace-out", default=None, metavar="trace.json",
                    help="record pipeline spans and per-request flow arrows and write a "
                         "Chrome trace-event JSON here (https://ui.perfetto.dev); implies "
                         "--scheduler")
    ap.add_argument("--trace-capacity", type=int, default=65536,
                    help="span ring-buffer capacity for --trace-out (oldest records evict "
                         "beyond it)")
    ap.add_argument("--metrics-out", default=None, metavar="metrics.json",
                    help="dump the metrics registry snapshot to this JSON file at the end of "
                         "the run; implies --scheduler")
    ap.add_argument("--metrics-interval-s", type=float, default=0.0,
                    help="print a live '[metrics t=..]' counter-delta line every this many "
                         "seconds while serving (0 = off; streaming mode)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def train_lstm(lstm: LSTMModel, data: np.ndarray, rng: np.random.Generator, steps: int,
               device) -> dict:
    """The draft LSTM (1 x 128, init seed 7) trained ``steps`` AdamW steps
    (lr 1e-2) of 16 corpus rows on the next-token loss."""
    params = lstm.init(7, device=device)
    leaves = lstm._leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    groups = {str(i): [leaf] for i, leaf in enumerate(leaves)}
    opt = AdamW(learning_rate=1e-2)
    state = opt.init(groups)
    loss = torch.zeros(())
    for _ in range(steps):
        idx = rng.integers(0, data.shape[0], size=16)
        loss = lstm.loss(params, torch.from_numpy(data[idx]).to(device))
        grads = torch.autograd.grad(loss, leaves)
        _, state = opt.update({str(i): [g] for i, g in enumerate(grads)}, state, groups)
    for leaf in leaves:
        leaf.requires_grad_(False)
    print(f"draft LSTM trained, final loss={float(loss.detach()):.3f}")
    return params


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    dev = args.device

    if (args.trace_out or args.metrics_out) and not args.scheduler:
        print("--trace-out/--metrics-out imply --scheduler; enabling it")
        args.scheduler = True
    if args.check_distilled and args.tier != "distilled":
        print("--check-distilled implies --tier distilled; enabling it")
        args.tier = "distilled"
    t0_mode = str(args.t0).lower()
    if args.speculative and t0_mode not in ("auto", "bandit"):
        print("--speculative needs an adaptive t0 policy; enabling --t0 auto")
        t0_mode = "auto"
    if args.tier == "distilled" and t0_mode not in ("auto", "bandit"):
        print("--tier distilled needs an adaptive t0 policy (the quality floor scores under "
              "it); enabling --t0 auto")
        t0_mode = "auto"
    t0_auto = t0_mode in ("auto", "bandit")
    if (t0_auto or args.stream) and not args.scheduler:
        print(f"--{f't0 {t0_mode}' if t0_auto else 'stream'} implies --scheduler; enabling it")
        args.scheduler = True
    # adaptive serving may go as shallow as the calibration floor (the worst
    # tier's target t0): train the flow path there; fixed-t0 serving trains at
    # the served t0
    if t0_auto:
        from repro_torch.drafting.quality import DEFAULT_TIERS
        t0_train = min(t0 for _, t0 in DEFAULT_TIERS)
    else:
        t0_train = float(args.t0)

    cfg = tiny_config(vocab_size=TEXT_VOCAB, seq_len=args.seq_len)
    model = build_model(cfg, device=dev, seed=0)
    corpus = SyntheticCorpus(seed=args.seed)
    data = corpus.sequences(2048, args.seq_len, seed=1)
    rng = np.random.default_rng(args.seed)

    # the draft LSTM (the paper's §4.2 draft role)
    lstm = LSTMModel(LSTMConfig(vocab_size=TEXT_VOCAB, hidden=128, num_layers=1, embed_dim=64))
    lparams = train_lstm(lstm, data, rng, args.train_steps, dev)

    # WS-DFM pairs: LSTM drafts refined by kNN into the corpus
    drafts = lstm.generate(lparams, prng.key(3), 512, args.seq_len).cpu().numpy()
    coupling = KNNRefinementCoupling(k=2, k_inject=2, max_candidates=2048)
    src, tgt = coupling.build(data, drafts, rng)
    run = RunConfig(total_steps=args.train_steps, batch_size=32, t0=t0_train,
                    learning_rate=1e-3, log_every=50)
    trainer = Trainer(model, cfg, run, path=WarmStartPath(t0=t0_train))
    state = trainer.init_state()
    trainer.fit(state, pair_iterator(src, tgt, 32, rng),
                log_fn=lambda i, m: print(f"  flow step {i}: {m['ce']:.3f}"))

    if not args.scheduler:
        serve_one_shot(args, model, cfg, lstm, lparams)
        return

    # the largest pow2 bucket the flow model's positions cover
    max_bucket = 1 << (args.seq_len.bit_length() - 1)
    if args.draft == "ar-kv":
        from repro_torch.drafting import ARDraftEngine, LSTMDraftAdapter

        engine = ARDraftEngine(LSTMDraftAdapter(model=lstm, params=lparams), max_len=max_bucket)
        draft_fn = engine.as_draft_fn()
        print("draft stage: KV-cached row-keyed ARDraftEngine (pack-invariant, "
              "cross-micro-batch cache reuse)")
    else:
        engine = None
        draft_fn = batch_keyed_draft(lambda key, num, L: lstm.generate(lparams, key, num, L))
        print("note: LSTM draft is batch-keyed (batch_keyed_draft) — outputs are "
              "reproducible for a fixed packing but not invariant to micro-batch composition; "
              "use --draft ar-kv for request-seeded serving")
    t0_policy = None
    if t0_auto:
        from repro_torch.drafting import (
            AdaptiveT0Policy, BanditT0Policy, fit_t0_calibration, make_quality_scorer,
        )

        scorer = make_quality_scorer(model.dfm_apply, device=dev)
        calib = fit_t0_calibration(scorer, data[:, :max_bucket], TEXT_VOCAB, seed=args.seed,
                                   device=dev)
        if t0_mode == "bandit":
            t0_policy = BanditT0Policy(scorer=scorer, calibration=calib, seed=args.seed)
            print("t0 policy: contextual bandit over the calibrated grid (online verify-step "
                  "reward)")
        else:
            t0_policy = AdaptiveT0Policy(scorer=scorer, calibration=calib)
        print(f"adaptive t0 calibration: scores {calib.scores} -> t0 {calib.t0s}")
    tracer = None
    if args.trace_out:
        from repro_torch.obs import SpanTracer
        tracer = SpanTracer(capacity=args.trace_capacity)
    rng_sizes = np.random.default_rng(args.seed + 1)
    sizes = [int(rng_sizes.integers(max_bucket // 2, max_bucket + 1)) for _ in range(args.num)]
    sched_kw = dict(
        flow_model=model, draft_fn=draft_fn, cold_nfe=args.cold_nfe,
        default_t0=t0_train if t0_auto else float(args.t0),
        min_bucket=min(8, max_bucket), max_bucket=max_bucket, t0_policy=t0_policy,
        per_row_t0=args.per_row_t0, speculative=args.speculative,
        accept_score=args.accept_score, device=dev)
    distilled_kw = {}
    if args.tier == "distilled":
        # full-bucket requests: the gate scores the packed bucket rows, so at
        # seq_len == bucket the calibration scores exactly what the gate does
        sizes = [max_bucket] * args.num
        distilled_kw = distilled_tier(args, sched_kw, sizes, t0_policy)
    sched = WarmStartScheduler(**sched_kw, tracer=tracer, **distilled_kw)
    if args.speculative:
        print(f"speculative accept threshold: score >= {sched.accept_score:.3f}")

    if args.stream:
        rep = serve_stream(args, sched, sizes, engine)
    else:
        rep = serve_batch(args, sched, sizes, engine, t0_auto)
    write_telemetry(args, sched, tracer, t0_mode)
    if args.check_distilled:
        check_distilled(rep, stream=args.stream)


def distilled_tier(args, sched_kw: dict, sizes, t0_policy) -> dict:
    """The distilled head (restored, or trained on the pairs a guaranteed
    warm-up pass over the same requests harvests) and its quality floor
    (given, or calibrated in a first pass with the floor open: the median
    split of the per-request minimum probe scores)."""
    from repro_torch.drafting import (
        DistilledRefiner, PairBuffer, distilled_checkpoint_exists, restore_distilled,
        save_distilled, train_distilled,
    )
    from repro_torch.drafting.quality import to_host

    dmodel = DistilledRefiner(vocab_size=TEXT_VOCAB)
    if args.distill_ckpt and distilled_checkpoint_exists(args.distill_ckpt):
        dparams = restore_distilled(args.distill_ckpt, dmodel, device=args.device)
        print(f"distilled head restored from {args.distill_ckpt}")
    else:
        buf = PairBuffer()
        harvest = WarmStartScheduler(**sched_kw, pair_buffer=buf)
        for i, L in enumerate(sizes):
            harvest.submit(seq_len=L, num_samples=1, seed=100 + i, t0=None)
        harvest.run()
        dparams, drep = train_distilled(dmodel, buf, key=13, epochs=8, device=args.device)
        print(f"distilled head trained on {drep.pairs} harvested pairs: loss "
              f"{drep.first_loss:.3f} -> {drep.final_loss:.3f}, agreement "
              f"{drep.final_agreement:.2f}")
        if args.distill_ckpt:
            save_distilled(args.distill_ckpt, dparams, step=drep.steps)
            print(f"distilled head saved to {args.distill_ckpt}")
    gate = args.distilled_accept_score
    if gate is None:
        # pass 1, the floor wide open: same seeds and packing as the real pass
        probe = WarmStartScheduler(**sched_kw, distilled_model=dmodel, distilled_params=dparams,
                                   distilled_nfe=args.distilled_nfe,
                                   distilled_accept_score=-1e9)
        prids = [probe.submit(seq_len=L, num_samples=1, seed=100 + i, t0=None,
                              tier="distilled") for i, L in enumerate(sizes)]
        pres, _ = probe.run()
        mins = sorted(float(to_host(t0_policy.scorer(pres[rid].tokens)).min())
                      for rid in prids)
        if mins[0] == mins[-1]:
            gate = mins[0]
            print(f"warning: every request scored {gate:.3f} under the distilled head; the "
                  "quality floor cannot split this set")
        else:
            mid = len(mins) // 2
            gate = (mins[mid - 1] + mins[mid]) / 2.0
        print(f"distilled quality floor calibrated: score >= {gate:.3f} (min scores "
              f"{mins[0]:.3f}..{mins[-1]:.3f})")
    return dict(distilled_model=dmodel, distilled_params=dparams,
                distilled_nfe=args.distilled_nfe, distilled_accept_score=gate)


def check_distilled(rep: dict, *, stream: bool) -> None:
    """--check-distilled: the tier must have served, fallen back, conserved
    every admission and shipped at NFE <= 2; raises SystemExit(1) if not."""
    d = rep.get("distilled") or {}
    fails = []
    if not d.get("enabled"):
        fails.append("distilled tier not enabled")
    if d.get("served", 0) <= 0:
        fails.append("distilled served 0 requests")
    if d.get("fallbacks", 0) <= 0:
        fails.append("quality floor never fell back")
    if d.get("nfe", 99) > 2:
        fails.append(f"distilled NFE {d.get('nfe')} > 2")
    if stream:
        if not rep["conservation"]["balanced"]:
            fails.append("conservation ledger unbalanced")
        if rep["terminal"]["distilled"] != d.get("served"):
            fails.append("terminal ledger != distilled served")
    elif d.get("served", 0) + d.get("fallbacks", 0) != d.get("requests", -1):
        fails.append("served + fallbacks != distilled requests")
    print(f"check-distilled: {'FAILED' if fails else 'OK'}"
          + "".join(f"\n  - {f}" for f in fails))
    if fails:
        raise SystemExit(1)


def write_telemetry(args, sched, tracer, t0_mode: str) -> None:
    """Write the trace and the metrics snapshot at the end of a run."""
    if args.trace_out:
        from repro_torch.obs import stage_breakdown, write_chrome_trace
        trace = write_chrome_trace(args.trace_out, tracer,
                                   metadata={"mode": "stream" if args.stream else "batch",
                                             "t0": t0_mode, "num": args.num})
        print(f"\ntrace: {len(trace['traceEvents'])} events -> {args.trace_out} (dropped "
              f"{tracer.dropped} spans; open in ui.perfetto.dev)")
        rows = stage_breakdown(trace)
        if rows:
            print("per-stage time breakdown:")
            for r in rows:
                print(f"  {r['track']:>15s}/{r['name']:<16s} n={r['count']:<4d} "
                      f"total={r['total_ms']:8.1f}ms mean={r['mean_ms']:6.1f}ms "
                      f"max={r['max_ms']:6.1f}ms")
    if args.metrics_out:
        sched.metrics.dump_json(args.metrics_out)
        print(f"metrics: registry snapshot -> {args.metrics_out}")


def serve_stream(args, sched, sizes, engine) -> dict:
    """The set through ``serve_stream`` from a producer thread (an open-loop
    Poisson replay with ``--arrival-rate``); returns the stream report."""
    from repro_torch.serving import ACCEPTED_DRAFT, COMPLETED, DISTILLED, AdmissionQueue, QueueFull

    queue = AdmissionQueue(max_depth=args.queue_depth or None, metrics=sched.metrics)
    mlogger = None
    if args.metrics_interval_s > 0:
        from repro_torch.obs import PeriodicMetricsLogger
        mlogger = PeriodicMetricsLogger(sched.metrics, interval_s=args.metrics_interval_s)
        mlogger.start()
    timeout_s = (args.timeout_ms / 1e3) if args.timeout_ms else None
    rng_arr = np.random.default_rng(args.seed + 2)

    def replay():
        for i, L in enumerate(sizes):
            if args.arrival_rate > 0:
                time.sleep(float(rng_arr.exponential(1.0 / args.arrival_rate)))
            try:
                queue.submit(seq_len=L, num_samples=1, seed=100 + i, t0=None,
                             priority=args.priority, timeout_s=timeout_s, tier=args.tier)
            except QueueFull:
                pass            # counted in the admission ledger
        queue.close()

    producer = threading.Thread(target=replay, daemon=True)
    producer.start()
    print(f"\nstreaming {args.num} requests (arrival rate {args.arrival_rate or 'inf'} req/s, "
          f"SLO {args.slo_ms or '-'} ms, class {args.priority}, queue depth "
          f"{args.queue_depth or 'unbounded'}, timeout {args.timeout_ms or '-'} ms):")
    for res in sched.serve_stream(source=queue, slo_ms=args.slo_ms, idle_timeout_s=0.02):
        if res.status in (ACCEPTED_DRAFT, DISTILLED):
            print(f"  [{res.request_id}] {res.status.upper()} nfe={res.nfe} "
                  f"latency={res.latency_s * 1e3:.0f}ms  {decode(np.asarray(res.tokens[0]))}")
            continue
        if res.status != COMPLETED:
            print(f"  [{res.request_id}] {res.status.upper()} ({res.priority}, latency "
                  f"{res.latency_s * 1e3:.0f}ms)")
            continue
        slo = "" if res.slo_met is None else f" slo={'OK' if res.slo_met else 'MISS'}"
        print(f"  [{res.request_id}] t0={res.t0:.2f} nfe={res.nfe} bucket={res.bucket_len} "
              f"mb={res.micro_batch} flush={res.flush_reason} "
              f"latency={res.latency_s * 1e3:.0f}ms{slo}  {decode(np.asarray(res.tokens[0]))}")
    producer.join()
    if mlogger is not None:
        mlogger.stop()
    rep = sched.stream_report
    lat = rep["latency_s"]
    att = rep["slo_attainment"]
    print(f"\nstream: {rep['completed'] + rep['accepted_draft'] + rep['distilled_served']} "
          f"results ({rep['accepted_draft']} accepted drafts, {rep['distilled_served']} "
          f"distilled) in {rep['num_micro_batches']} micro-batches, first result at "
          f"{rep['time_to_first_result_s']:.3f}s, latency p50/p95/p99 = "
          f"{lat['p50'] * 1e3:.0f}/{lat['p95'] * 1e3:.0f}/{lat['p99'] * 1e3:.0f} ms, SLO "
          f"attainment {'-' if att is None else f'{att:.0%}'}, flushes {rep['flush_reasons']}")
    print_policy_lines(rep)
    if (rep.get("distilled") or {}).get("enabled"):
        d = rep["distilled"]
        print(f"distilled: {d['served']} served at NFE={d['nfe']} ({d['fallbacks']} "
              f"quality-floor fallbacks, floor {d['gate_score']:.3f})")
    term = rep["terminal"]
    if any(v for k, v in term.items() if k not in (COMPLETED, ACCEPTED_DRAFT, DISTILLED)):
        print(f"terminal: {term}; admission {rep['admission']}; conservation "
              f"{'OK' if rep['conservation']['balanced'] else 'BROKEN'}")
    if engine is not None:
        print(f"draft engine: {engine.stats.as_dict()}")
    return rep


def print_policy_lines(rep: dict) -> None:
    if rep.get("speculative"):
        spec = rep["speculative"]
        print(f"speculative: {spec['accepted']}/{spec['eligible']} accepted (rate "
              f"{spec['accept_rate']:.0%}, threshold {spec['accept_score']:.3f})")
    if rep.get("bandit"):
        print(f"bandit arms: {len(rep['bandit'])} contexts learned")


def serve_batch(args, sched, sizes, engine, t0_auto: bool) -> dict:
    """The set through ``run`` (the end-of-run batch path); returns its report."""
    for i, L in enumerate(sizes):
        sched.submit(seq_len=L, num_samples=1, seed=100 + i, t0=None, tier=args.tier)
    results, rep = sched.run()
    print(f"\nscheduler: {rep['num_requests']} requests in {rep['num_micro_batches']} "
          f"micro-batches, {rep['requests_per_s']:.2f} req/s, "
          f"overlap_eff={rep['overlap_efficiency']:.2f}, mean NFE "
          f"{rep['mean_request_nfe']:.1f}, jit cache {rep['jit_cache']}")
    if t0_auto:
        print(f"adaptive t0 histogram: {rep['policy']['t0_histogram']}")
    print_policy_lines(rep)
    if (rep.get("distilled") or {}).get("enabled"):
        d = rep["distilled"]
        print(f"distilled: {d['served']}/{d['requests']} served at NFE={d['nfe']} "
              f"({d['fallbacks']} quality-floor fallbacks, floor {d['gate_score']:.3f})")
    if engine is not None:
        print(f"draft engine: {engine.stats.as_dict()}")
    for rid in sorted(results)[:4]:
        r = results[rid]
        print(f"[{rid}] t0={r.t0:.2f} nfe={r.nfe} bucket={r.bucket_len} "
              f"{decode(np.asarray(r.tokens[0]))}")
    return rep


def serve_one_shot(args, model, cfg, lstm, lparams) -> None:
    """One batch of ``--num`` rows through the one-shot ``WarmStartServer``."""
    t0 = float(args.t0)
    if args.draft == "ar-kv":
        from repro_torch.drafting import ARDraftEngine, LSTMDraftAdapter

        engine = ARDraftEngine(LSTMDraftAdapter(model=lstm, params=lparams),
                               max_len=args.seq_len)

        def draft_generate(rng, num):
            return engine.generate_rows(prng.split(rng, num), args.seq_len)
    else:
        def draft_generate(rng, num):
            return lstm.generate(lparams, rng, num, args.seq_len)
    step_fn = None
    if args.fused_step:
        from repro_torch.kernels.ws_step import make_ws_step_fn
        step_fn = make_ws_step_fn(WarmStartPath(t0=t0), device=args.device)
    server = WarmStartServer(flow_model=model, flow_cfg=cfg, draft_generate=draft_generate,
                             path=WarmStartPath(t0=t0), cold_nfe=args.cold_nfe,
                             step_fn=step_fn, device=args.device)
    out, report = server.serve(prng.key(11), args.num)
    print(f"\nNFE: {report['nfe']} / cold {report['cold_nfe']} "
          f"(guaranteed x{report['speedup_report'].guaranteed_factor:.1f})")
    print(f"draft {report['draft_time_s'] * 1e3:.1f}ms flow {report['flow_time_s'] * 1e3:.1f}ms "
          f"({report['per_nfe_s'] * 1e3:.1f}ms/NFE, one dispatch)")
    out = out.cpu().numpy()
    for i in range(min(args.num, 4)):
        print(f"[{i}] {decode(out[i])}")


if __name__ == "__main__":
    main()
