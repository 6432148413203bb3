"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` with
``nvcc``, holds each kernel against its plain PyTorch version on the card,
then serves the ``dfm_dit`` CONFIG backbone at full width (12 x 768,
seq 256, 32 samples, random seeded weights) through ``WarmStartServer``
with the ``ws_step`` kernel as its step and the ``flash_attn`` kernel in
every attention, and checks the NFE guarantee, the launch counts and the
tokens (against the plain CPU path on a small input). It prints the card,
one ``{"kernels": [...]}`` line, one ``{"serve": ...}`` line and, last,
``{"ok": true, "device": ...}``. Any failure raises and exits non-zero;
without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s and float32
# (non-tensor) operations/s, both at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

SEQ, NUM, COLD_NFE, T0, VOCAB = 256, 32, 64, 0.8, 27
WS_TIE_TOL = 1e-5
FLASH_TOL = 1e-4


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 7, inner: int = 20) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(fn, n: int = 20, reps: int = 7) -> float:
    """Device time per call of ``fn``: ``n`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events, median per call.
    Unlike :func:`time_ms` it leaves out the host's cost of each call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def bound_ms(nbytes: float, nops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- ws_step -------------------------------------------------------------------

# per element: the 20-round threefry hash (~72 integer ops), the Gumbel
# transform and the streamed softmax/argmax (~40 float ops incl. 2 logf,
# 2 expf and a division); counted against the float32 rate
WS_OPS_PER_ELEMENT = 112


def ws_inputs(r, v, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = 3.0 * torch.randn((r, v), generator=g, device="cuda")
    x = torch.randint(0, v, (r,), generator=g, device="cuda", dtype=torch.int32)
    t = torch.full((r,), T0 + 0.05, device="cuda")
    return logits, x, t


def check_ws_step(r, v, temperature, seed):
    from repro_torch import prng
    from repro_torch.core.paths import WarmStartPath
    from repro_torch.kernels.ws_step import (
        near_tie_rows, seed_from_key, ws_step, ws_step_ref_streamed,
    )

    path = WarmStartPath(t0=T0)
    logits, x, t = ws_inputs(r, v, seed)
    h = torch.tensor(1.0 / COLD_NFE, device="cuda")
    key = prng.key(seed)
    got = ws_step(key, logits, x, t, h, path, temperature=temperature)
    a = torch.clamp(h * path.velocity_scale(t), 0.0, 1.0)
    noise = prng.threefry_gumbel(seed_from_key(key), r, v, device="cuda")
    want = ws_step_ref_streamed(logits, x, a, noise, temperature=temperature)
    ties = near_tie_rows(logits, x, a, noise, temperature=temperature, tol=WS_TIE_TOL)
    torch.cuda.synchronize()
    mismatch = got != want
    bad = mismatch & ~ties
    res = {"rows": r, "vocab": v, "temperature": temperature,
           "mismatches": int(mismatch.sum()), "near_ties": int(ties.sum()),
           "max_abs_err": float((got - want)[~ties].abs().max())}
    print(f"ws_step R={r} V={v} T={temperature}: {res['mismatches']} mismatching rows, "
          f"{res['near_ties']} near-tie rows (tie rule: keep-vs-move scores or the two "
          f"best lg+g within {WS_TIE_TOL}), {int(bad.sum())} mismatches off the ties")
    if bool(bad.any()):
        fail(f"ws_step kernel disagrees with its plain version off the near ties: {res}")
    return res


def measure_ws_step(r, v):
    from repro_torch import prng
    from repro_torch.core.paths import WarmStartPath
    from repro_torch.kernels.ws_step import ops, seed_from_key, ws_step, ws_step_ref_streamed

    path = WarmStartPath(t0=T0)
    logits, x, t = ws_inputs(r, v, 0)
    h = torch.tensor(1.0 / COLD_NFE, device="cuda")
    key = prng.key(1)
    seed = seed_from_key(key)
    a = torch.clamp(h * path.velocity_scale(t), 0.0, 1.0)
    out = torch.empty(r, dtype=torch.int32, device="cuda")

    def plain():
        noise = prng.threefry_gumbel(seed, r, v, device="cuda")
        return ws_step_ref_streamed(logits, x, a, noise)

    ms = graph_ms(lambda: ops._launch(logits, x, a, out, seed, 1.0), n=50)
    call_ms = time_ms(lambda: ws_step(key, logits, x, t, h, path))
    plain_ms = graph_ms(plain)
    nbytes = r * v * 4 + 3 * r * 4
    bms, by = bound_ms(nbytes, WS_OPS_PER_ELEMENT * r * v)
    return {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": None}


# -- flash_attn ------------------------------------------------------------------

def flash_inputs(b, s, h, kh, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, s, h, d), generator=g, device="cuda")
    k = torch.randn((b, s, kh, d), generator=g, device="cuda")
    v = torch.randn((b, s, kh, d), generator=g, device="cuda")
    return q, k, v


def check_flash(b, s, h, kh, d, causal, window, seed):
    from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref

    q, k, v = flash_inputs(b, s, h, kh, d, seed)
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    err = float((got - want).abs().max())
    print(f"flash_attn B={b} S={s} H={h} KH={kh} D={d} causal={causal} window={window}: "
          f"max abs err {err:.3e} (limit {FLASH_TOL})")
    if not math.isfinite(err) or err > FLASH_TOL:
        fail(f"flash_attn kernel disagrees with its plain version: {err}")
    return err


def measure_flash(b, s, h, d):
    from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref, ops

    q, k, v = flash_inputs(b, s, h, h, d, 0)
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(d)
    ms = graph_ms(lambda: ops._launch(q, k, v, out, causal=False, window=None, scale=scale))
    call_ms = time_ms(lambda: flash_attention(q, k, v, causal=False))
    plain_ms = graph_ms(lambda: flash_attention_ref(q, k, v, causal=False))
    qt, kt, vt = (z.transpose(1, 2).contiguous() for z in (q, k, v))
    library_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt))
    nbytes = 4 * b * s * h * d * 4
    bms, by = bound_ms(nbytes, 4.0 * b * h * s * s * d)
    return {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": library_ms}


# -- the main path ---------------------------------------------------------------

def check_small_serve_against_cpu():
    """The card's serve (kernels) equals the plain CPU path's on a small
    input: same seeded weights, key and draft."""
    from repro_torch import prng
    from repro_torch.configs.dfm_dit import smoke_config
    from repro_torch.core.paths import WarmStartPath
    from repro_torch.kernels.ws_step import make_ws_step_fn
    from repro_torch.models import Model
    from repro_torch.serving import WarmStartServer, uniform_draft

    out = {}
    for device in ("cuda", "cpu"):
        path = WarmStartPath(t0=T0)
        model = Model(smoke_config(), device="cpu", seed=3).to(device)
        draft = uniform_draft(VOCAB, device=device)
        server = WarmStartServer(
            flow_model=model, flow_cfg=model.cfg,
            draft_generate=lambda rng, num, draft=draft: draft(prng.split(rng, num), 32),
            path=path, cold_nfe=16, step_fn=make_ws_step_fn(path, device=device),
            device=device)
        out[device] = server.serve(prng.key(5), 4)[0].cpu()
    diff = int((out["cuda"] != out["cpu"]).sum())
    print(f"small serve (smoke config, 4 x 32 tokens, 4 steps): card vs CPU plain path: "
          f"{diff} tokens differ")
    if diff:
        fail("the card's serve disagrees with the plain CPU path on a small input")


def check_full_width_logits(model, tokens, t):
    """Full-width backbone logits through the kernels on the card against
    the plain CPU path on the same weights."""
    from repro_torch.configs.dfm_dit import CONFIG
    from repro_torch.models import Model

    with torch.inference_mode():
        got = model.dfm_apply(tokens, t).cpu()
        ref_model = Model(CONFIG, device="cpu")
        ref_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        want = ref_model.dfm_apply(tokens.cpu(), t.cpu())
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    print(f"full-width dfm_apply, 1 x {SEQ} tokens, card kernels vs CPU plain: max abs err "
          f"{err:.3e} (logits up to {scale:.2f})")
    if not math.isfinite(err) or err > 1e-3 * max(1.0, scale):
        fail(f"full-width logits disagree with the plain path: {err}")


def main_path():
    from repro_torch import prng
    from repro_torch.configs.dfm_dit import CONFIG
    from repro_torch.core.guarantees import warm_nfe
    from repro_torch.core.paths import WarmStartPath
    from repro_torch.kernels import launches
    from repro_torch.kernels.ws_step import make_ws_step_fn
    from repro_torch.models import Model
    from repro_torch.serving import WarmStartServer, uniform_draft

    model = Model(CONFIG, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    path = WarmStartPath(t0=T0)
    draft = uniform_draft(VOCAB, device="cuda")
    server = WarmStartServer(
        flow_model=model, flow_cfg=CONFIG,
        draft_generate=lambda rng, num: draft(prng.split(rng, num), SEQ),
        path=path, cold_nfe=COLD_NFE, step_fn=make_ws_step_fn(path), device="cuda")
    nfe_want = warm_nfe(COLD_NFE, T0)
    if nfe_want != 13:
        fail(f"warm_nfe({COLD_NFE}, {T0}) = {nfe_want}, expected 13")
    per_serve = {"ws_step": nfe_want, "flash_attn": nfe_want * CONFIG.num_layers}

    launches.clear()
    reports, last = [], None
    for i in range(3):
        before = dict(launches)
        x, rep = server.serve(prng.key(100 + i), NUM)
        for name, n in per_serve.items():
            grew = launches[name] - before.get(name, 0)
            if grew != n:
                fail(f"serve {i}: {name} launched {grew} times, expected {n}")
        if not (rep["nfe"] == rep["backbone_evals"] == nfe_want):
            fail(f"serve {i}: nfe {rep['nfe']} backbone_evals {rep['backbone_evals']}")
        if x.shape != (NUM, SEQ) or x.dtype != torch.int32 or x.device.type != "cuda":
            fail(f"serve {i}: tokens {tuple(x.shape)} {x.dtype} on {x.device}")
        if int(x.min()) < 0 or int(x.max()) >= VOCAB:
            fail(f"serve {i}: tokens outside [0, {VOCAB})")
        reports.append(rep)
        last = x
    counts = dict(launches)
    print(f"main path: dfm_dit CONFIG ({n_params / 1e6:.1f}M params) x 3 serves of "
          f"{NUM} x {SEQ}, t0={T0}, cold_nfe={COLD_NFE}: nfe 13 per serve, guarantee gate "
          f"passed, launches {counts} (per serve {per_serve})")

    check_full_width_logits(model, last[:1], torch.full((1,), T0, device="cuda"))
    profile = profile_serve(server, prng.key(200))
    steady = reports[1:]
    serve = {
        "config": CONFIG.name, "num": NUM, "seq_len": SEQ, "t0": T0, "cold_nfe": COLD_NFE,
        "nfe": nfe_want, "params": n_params,
        "warmup_flow_ms": reports[0]["flow_time_s"] * 1e3,
        "draft_ms": statistics.median(r["draft_time_s"] for r in steady) * 1e3,
        "flow_ms": statistics.median(r["flow_time_s"] for r in steady) * 1e3,
        "per_nfe_ms": statistics.median(r["per_nfe_s"] for r in steady) * 1e3,
        "samples_per_s": statistics.median(
            NUM / (r["draft_time_s"] + r["flow_time_s"]) for r in steady),
        "flow_ms_each": [r["flow_time_s"] * 1e3 for r in steady],
        "profile": profile,
    }
    return counts, per_serve, serve


def _category(name: str) -> str:
    if "flash_attn_kernel" in name:
        return "flash_attn"
    if "ws_step_kernel" in name:
        return "ws_step"
    if "gemm" in name.lower() or "cutlass" in name.lower():
        return "matmul"
    return "other"


def profile_serve(server, key):
    """One more serve under ``torch.profiler``: device time by kernel and
    the device's busy share of the serve's wall time (profiler on)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, rep = server.serve(key, NUM)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: a host op (aten::mm) also carries its kernels' device time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        print("profile: the trace holds no device time (not measured)")
        return {"device_ms": None}
    device_ms = sum(ms for _, ms, _ in rows)
    by_cat = {}
    for name, ms, _ in rows:
        by_cat[_category(name)] = by_cat.get(_category(name), 0.0) + ms
    top = sorted(rows, key=lambda r: -r[1])[:8]
    n_launch = sum(c for _, _, c in rows)
    print(f"profile of one serve: device busy {device_ms:.1f} ms of {wall_ms:.1f} ms wall "
          f"({device_ms / wall_ms:.1%}), {n_launch} kernel launches; by kind {by_cat}")
    for name, ms, count in top:
        print(f"  {ms:9.3f} ms  x{count:<5d} {name[:100]}")
    return {"device_ms": device_ms, "wall_ms": wall_ms, "busy_share": device_ms / wall_ms,
            "kernel_launches": n_launch,
            "flow_ms": rep["flow_time_s"] * 1e3, "by_kind_ms": by_cat,
            "top": [[n[:100], ms, c] for n, ms, c in top]}


def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)   # progress survives a kill
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs the card",
              file=sys.stderr)
        return 2
    card = card_line()
    from repro_torch.device import resolve_device

    resolve_device("cuda")   # float32 products stay float32: TF32 off
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import _build

    _build.build(force=True, ptxas_info=True)
    print(f"build: nvcc for sm_90a, {_build.build_seconds:.1f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas " + line.split("ptxas info    :")[-1].strip())
    _build.library()

    ws_checks = [check_ws_step(8192, 27, 1.0, 0), check_ws_step(64, 50257, 1.0, 1),
                 check_ws_step(64, 50257, 0.7, 2), check_ws_step(64, 262144, 1.0, 3)]
    flash_errs = [check_flash(32, SEQ, 12, 12, 64, False, None, 0),
                  check_flash(2, 200, 8, 2, 64, True, None, 1),
                  check_flash(2, 300, 4, 4, 32, False, 37, 2),
                  check_flash(1, 130, 4, 4, 128, True, 50, 3)]
    ws_num = measure_ws_step(NUM * SEQ, VOCAB)
    flash_num = measure_flash(NUM, SEQ, 12, 64)

    check_small_serve_against_cpu()
    counts, per_serve, serve = main_path()

    breakdown = {
        "flash_attn_ms_per_nfe": per_serve["flash_attn"] / per_serve["ws_step"] * flash_num["ms"],
        "ws_step_ms_per_nfe": ws_num["ms"],
    }
    breakdown["rest_ms_per_nfe"] = (serve["per_nfe_ms"] - breakdown["flash_attn_ms_per_nfe"]
                                    - breakdown["ws_step_ms_per_nfe"])
    serve["breakdown_from_kernel_times"] = breakdown
    kernels = [
        {"name": "ws_step", "route": "cuda", "source": "src/repro_torch/csrc/ws_step.cu",
         "replaces": "src/repro/kernels/ws_step/kernel.py:213",
         "tpu_kernel": "ws_step_streamed_pallas",
         "launches": counts.get("ws_step", 0), "launches_per_serve": per_serve["ws_step"],
         "max_abs_err": max(c["max_abs_err"] for c in ws_checks),
         "mismatches": sum(c["mismatches"] for c in ws_checks),
         "near_ties": sum(c["near_ties"] for c in ws_checks),
         "shape": [NUM * SEQ, VOCAB], **ws_num,
         "bound_us": ws_num["bound_ms"] * 1e3},
        {"name": "flash_attn", "route": "cuda", "source": "src/repro_torch/csrc/flash_attn.cu",
         "replaces": "src/repro/kernels/flash_attn/kernel.py:94",
         "tpu_kernel": "flash_attention_pallas",
         "launches": counts.get("flash_attn", 0), "launches_per_serve": per_serve["flash_attn"],
         "max_abs_err": max(flash_errs), "max_err": max(flash_errs),
         "shape": [NUM, SEQ, 12, 64], **flash_num,
         "bound_us": flash_num["bound_ms"] * 1e3},
    ]
    for k in kernels:
        if k["launches"] <= 0:
            fail(f"{k['name']} was not launched on the main path")
    print(json.dumps({"serve": serve}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t_start = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    sys.exit(rc)
