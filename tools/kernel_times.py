#!/usr/bin/env python
"""Device times of the head and ws_step kernels of a checkout, for comparing two
trees on one card.

Run on a machine with one NVIDIA H100, from the root of the checkout that holds
this script:

    python3 tools/kernel_times.py [--root DIR] [--label NAME]

It builds the kernels of ``DIR/src/repro_torch`` (default: this checkout) into
``DIR/build`` and times, with this checkout's ``chip_smoke.py`` helpers (a CUDA
graph of launches between CUDA events, median per launch), through entry points
that every tree since the head and ws_step kernels were ported shares:
  * ``head`` at the draft's decode shape (32 rows, D = 768, V = 27, row-major
    weights), warm (one weight set) and cold (650 weight sets, 54 MB, cycled);
  * ``ws_step`` at (8192, 27) and ``ws_step_rows`` at (32, 256, 27);
  * the launch floor: a graph of one-element in-place adds.
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
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels.draft_decode import ops as dops
    from repro_torch.kernels.ws_step import ops as wops

    resolve_device("cuda")
    if not str(_build.CSRC).startswith(str(pathlib.Path(args.root).resolve())):
        raise RuntimeError(f"imported {_build.CSRC}, not the tree under {args.root}")
    _build.library()

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
    res["launch_floor_ms"] = smoke.launch_floor_ms()
    print(res["card"])
    print(json.dumps({"kernel_times": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
