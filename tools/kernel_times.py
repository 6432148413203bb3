#!/usr/bin/env python
"""Device times of the head, ws_step, ws_fused, ws_step_gumbel and flash_attn
kernels of a checkout, for comparing two trees on one card.

Run on a machine with one NVIDIA H100, from the root of the checkout that holds
this script:

    python3 tools/kernel_times.py [--root DIR] [--label NAME] [--attn-only] [--draft]

It builds the kernels of ``DIR/src/repro_torch`` (default: this checkout) into
``DIR/build`` and times, with this checkout's ``chip_smoke.py`` helpers (a CUDA
graph of launches between CUDA events, median per launch), through entry points
that every tree since the head and ws_step kernels were ported shares:
  * ``head`` at the draft's decode shape (32 rows, D = 768, V = 27, row-major
    weights), warm (one weight set) and cold (650 weight sets, 54 MB, cycled);
  * ``ws_step`` at (8192, 27) and ``ws_step_rows`` at (32, 256, 27);
  * ``ws_fused`` at (8192, 27, K = 4) and (64, 50257, K = 4), per-row keys, and a
    graph of 4 ``ws_step`` launches at the same shapes;
  * ``ws_step_gumbel`` with its noise given at (8192, 27), and the default Euler
    step ``core.sampler.gumbel_step`` as a whole at (32, 256, 27) (a graph of
    steps: the noise, the weights and the launch);
  * the launch floor: a graph of one-element in-place adds;
  * ``flash_attn``, bidirectional, at the shapes of PERF.md's rows 2 (the
    DiT: 32 x 256, 12 heads of 64), 2z (starcoder2-3b: 8 x 256, 24 heads of
    128, kv 2), 2r (zamba2-2.7b: 8 x 256, 32 heads of 80), 2m (arctic-480b:
    8 x 256, 56 heads of 128, kv 8), 2g (gemma3-1b: 4 x 1024, 4 heads of 256,
    kv 1, window 512) and, where the tree has the instance with values
    narrower than queries and keys, 2d (deepseek-v3-671b: 8 x 256, 128 heads,
    q/k 192, v 128);
  * ``attn_cached`` through ``ops._launch_attn_cached`` at the shapes of PERF.md's
    rows 5 (the DiT's decode: 32 rows, T = 271, 12 heads of 64) and 5z
    (starcoder2-3b's: 8 rows, 24 heads of 128, kv 2), one token a row, with the
    cursor on the last row (end = 271) and mid-decode (end = 144), each launch
    on its own K/V buffers of a set that exceeds the L2 twice (cold reads, as a
    decode step finds them);
  * with ``--draft``, the DiT's AR draft as the serve runs it (``chip_smoke.py``'s
    ``draft_engine``: the full-width model through the draft kernels, 32 rows, a
    16-token prompt, 255 decode steps, one CUDA graph): host wall ms of a replay
    after a synchronize, median of 5, the capture's call apart.
Prints the card (``nvidia-smi``) and one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys

import torch

HERE = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose kernels are timed")
    ap.add_argument("--label", default="", help="a name for the JSON line")
    ap.add_argument("--attn-only", action="store_true", help="time attn_cached alone")
    ap.add_argument("--draft", action="store_true", help="time the DiT's AR draft too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    # the timed tree's package first: chip_smoke put this checkout's src in front
    sys.path.insert(0, str(pathlib.Path(args.root).resolve() / "src"))
    from repro_torch import prng
    from repro_torch.core.paths import WarmStartPath
    from repro_torch.core.sampler import gumbel_step
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels.draft_decode import ops as dops
    from repro_torch.kernels.ws_fused import ops as fops
    from repro_torch.kernels.ws_step import ops as wops

    resolve_device("cuda")
    if not str(_build.CSRC).startswith(str(pathlib.Path(args.root).resolve())):
        raise RuntimeError(f"imported {_build.CSRC}, not the tree under {args.root}")
    _build.library()

    if args.attn_only:
        res = {"label": args.label, "root": args.root, "card": smoke.card_line(),
               **attn_times(smoke, dops)}
        if args.draft:
            res["dit_draft_ms"] = draft_ms(smoke, prng)
        print(res["card"])
        print(json.dumps({"kernel_times": res}))
        return 0

    d, v, r = 768, smoke.VOCAB, smoke.NUM
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((r, d), generator=g, device="cuda")
    ln = {"scale": 1.0 + 0.1 * torch.randn(d, generator=g, device="cuda"),
          "bias": 0.1 * torch.randn(d, generator=g, device="cuda")}
    w = torch.randn((d, v), generator=g, device="cuda")
    logits = torch.empty((r, v), device="cuda")
    heads = smoke.cycle([torch.randn((d, v), generator=g, device="cuda")
                         for _ in range(smoke.HEAD_COLD_SETS)])
    kw = dict(norm="layernorm", eps=1e-6)
    res = {"label": args.label, "root": args.root, "card": smoke.card_line(),
           "head_warm_ms": smoke.graph_ms(lambda: dops._launch_head(x, ln, w, logits, **kw),
                                          n=50),
           "head_cold_ms": smoke.graph_ms(
               lambda: dops._launch_head(x, ln, heads(), logits, **kw),
               n=smoke.HEAD_COLD_SETS, reps=5)}

    rows = smoke.NUM * smoke.SEQ
    lg, xt, _ = smoke.ws_inputs(rows, v, 0)
    a = torch.full((rows,), 0.078125, device="cuda")   # h * velocity_scale(t) at t0 = 0.8
    seed = wops.seed_from_key(prng.key(1))
    out = torch.empty(rows, dtype=torch.int32, device="cuda")
    res["ws_step_ms"] = smoke.graph_ms(lambda: wops._launch(lg, xt, a, out, seed, 1.0), n=50)
    keys = prng.key_data(prng.split(prng.key(5), smoke.NUM)).to("cuda", torch.int64)
    lg3, x2 = lg.view(smoke.NUM, smoke.SEQ, v), xt.view(smoke.NUM, smoke.SEQ)
    ab, out2 = a[:smoke.NUM].contiguous(), out.view(smoke.NUM, smoke.SEQ)
    res["ws_step_rows_ms"] = smoke.graph_ms(
        lambda: wops._launch_rows(lg3, x2, ab, keys, out2, 1.0), n=50)
    steps = [wops.seed_from_key(k) for k in prng.split(prng.key(6), 4)]
    path = WarmStartPath(t0=0.0)
    for suffix, (b, n, vf) in (("", (smoke.NUM, smoke.SEQ, v)), ("_v50257", (2, 32, 50257))):
        keys4, lgf, xf, ts, hs = smoke.fused_case("rows", 4, b, n, vf, 6)
        seeds, lgf, xf, af, kg, ag = fops.fused_inputs(keys4, lgf, xf, ts, hs, path)
        xf, sd = xf.contiguous(), seeds.to("cuda", torch.int64).contiguous()
        outs = [torch.empty(b * n, dtype=torch.int32, device="cuda") for _ in steps]
        a_step = torch.full((b * n,), 0.078125, device="cuda")

        def ws_steps():
            cur = xf
            for seed_j, out_j in zip(steps, outs):
                wops._launch(lgf, cur, a_step, out_j, seed_j, 1.0)
                cur = out_j

        res["ws_step_graph_of_4" + suffix + "_ms"] = smoke.graph_ms(ws_steps, n=20)
        res["ws_fused" + suffix + "_ms"] = smoke.graph_ms(
            lambda: fops._launch(lgf, xf, af, sd, outs[0], kg, ag, 1.0), n=20)
    noise = prng.gumbel(prng.key(0), (rows, v), device="cuda")
    x1, a1, o1 = xt.view(rows, 1), a.view(rows, 1), out.view(rows, 1)
    res["ws_step_gumbel_given_ms"] = smoke.graph_ms(
        lambda: wops._launch_gumbel(lg, x1, a1, noise, o1, v, 1.0), n=50)
    t = torch.full((smoke.NUM,), smoke.T0, device="cuda")
    h = torch.tensor(1.0 / smoke.COLD_NFE, device="cuda")
    warm = WarmStartPath(t0=smoke.T0)
    res["gumbel_step_ms"] = smoke.graph_ms(
        lambda: gumbel_step(prng.key(0), lg3, x2, t, h, warm), n=20)
    res["launch_floor_ms"] = smoke.launch_floor_ms()

    from repro_torch.kernels.flash_attn import ops as aops

    # row of PERF.md §6: (B, S, H, KH, q/k head_dim, v head_dim, window)
    flash = {"2": (32, 256, 12, 12, 64, 64, None), "2z": (8, 256, 24, 2, 128, 128, None),
             "2r": (8, 256, 32, 32, 80, 80, None), "2m": (8, 256, 56, 8, 128, 128, None),
             "2g": (4, 1024, 4, 1, 256, 256, 512), "2d": (8, 256, 128, 128, 192, 128, None)}
    narrow = (192, 128) in getattr(aops, "SUPPORTED_HEAD_DIMS", ())
    for row, (b, s, h, kh, dk, dv, window) in flash.items():
        if dk != dv and not narrow:
            continue
        q, k, vv = smoke.flash_inputs(b, s, h, kh, dk, 0, dv=dv)
        o = q.new_empty((b, s, h, dv))
        res[f"flash_attn_{row}_ms"] = smoke.graph_ms(
            lambda: aops._launch(q, k, vv, o, causal=False, window=window, scale=dk ** -0.5),
            n=20)
        del q, k, vv, o
    res.update(attn_times(smoke, dops))
    print(res["card"])
    print(json.dumps({"kernel_times": res}))
    return 0


def draft_ms(smoke, prng):
    """The DiT's AR draft (32 x 256 after a 16-token prompt) a replay: median
    host wall ms of 5 after the capturing call."""
    import time

    engine = smoke.draft_engine()
    prompt = smoke.draft_prompt(smoke.NUM)
    times = []
    for i in range(6):
        keys = prng.split(prng.key(i), smoke.NUM)
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.generate_rows(keys, smoke.SEQ, prompt)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    del engine
    torch.cuda.empty_cache()
    return sorted(times[1:])[2]


def attn_times(smoke, dops):
    """attn_cached's device time a launch at rows 5 and 5z, end = T and 144."""
    import math

    res = {}
    t = smoke.MAX_LEN
    # row of PERF.md §6: (B, H, KH, head_dim)
    for row, (b, h, kh, hd) in {"5": (smoke.NUM, 12, 12, 64), "5z": (8, 24, 2, 128)}.items():
        g = torch.Generator(device="cuda").manual_seed(0)
        n_sets = max(2, math.ceil(2 * smoke.L2_BYTES / (2 * 4 * b * t * kh * hd)))
        sets = smoke.cycle([tuple(torch.randn((b, t, kh * hd), generator=g, device="cuda")
                                  for _ in range(2)) for _ in range(n_sets)])
        q = torch.randn((b, h * hd), generator=g, device="cuda")
        out = torch.empty_like(q)
        for label, end in (("", t), ("_mid", smoke.ATTN_MID_END)):
            start = torch.tensor(end - 1, dtype=torch.int32, device="cuda")
            kw = dict(pos0=end - 1, seq=1, heads=h, kv_heads=kh, head_dim=hd)
            res[f"attn_cached_{row}{label}_ms"] = smoke.graph_ms(
                lambda: dops._launch_attn_cached(q, *sets(), start, out, **kw), n=50)
        del sets
    return res


if __name__ == "__main__":
    sys.exit(main())
