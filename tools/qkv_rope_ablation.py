#!/usr/bin/env python
"""Where qkv_rope_kernel's time goes: the kernel timed with one phase removed.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 tools/qkv_rope_ablation.py

Each variant is a copy of ``src/repro_torch`` under ``build/qkv_rope_ablation/``
whose ``csrc/draft_decode.cu`` has one phase of ``qkv_rope_kernel`` cut out by a
text patch; it is built with ``nvcc`` and timed in a process of its own at the
draft's decode shape, as ``chip_smoke.py``'s ``measure_draft_kernels`` times it
(``DRAFT_CASES[0]``, cold weights cycled over 10 sets, a CUDA graph of 50
launches, median of 7), three times, in the order base, the variants, base.
A variant's outputs are wrong by construction; the base's are checked against
the plain version. The difference to the base is what that phase adds to the
kernel's time. Prints the card and one JSON line.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

# name -> [(text in csrc/draft_decode.cu, replacement)]
VARIANTS = {
    "base": [],
    # each rank normalises with its own slice's statistics: no first cluster barrier
    # and no remote read of the statistics
    "no_stats_exchange": [
        ("  cluster_arrive();\n  // RoPE's rotation", "  // RoPE's rotation"),
        ("  cluster_wait();\n\n  // the 8 slices' statistics", "\n  // the 8 slices' statistics"),
        ("    const float* st = cluster.map_shared_rank(stats, p);", "    const float* st = stats;"),
    ],
    "no_normalise": [
        ("  for (int kb = qd; kb < len; kb += 4 * kLanes) {",
         "  for (int kb = qd; kb < 0 * len; kb += 4 * kLanes) {"),
    ],
    "no_products": [
        ("    const int kn = min(CH, len8 - c * CH);", "    const int kn = 0 * min(CH, len8 - c * CH);"),
    ],
    "no_weight_copy": [
        ("  if (nch > 0) copy_chunk(0);\n  cp_async_commit();", "  cp_async_commit();"),
    ],
    # no bias, RoPE or store: the compiler then drops the combine's remote reads too
    "no_combine_or_store": [
        ("    if (!mine[e]) continue;", "    if (mine[e] || !mine[e]) continue;"),
    ],
}

MEASURE = r'''
import importlib.util, json, sys, torch
src, smoke = sys.argv[1], sys.argv[2]
sys.path.insert(0, src)
spec = importlib.util.spec_from_file_location("chip_smoke", smoke)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
sys.path.insert(0, src)
import repro_torch
assert repro_torch.__file__.startswith(src), repro_torch.__file__
from repro_torch.kernels import _build
from repro_torch.kernels.draft_decode import ops, qkv_rope_ref
_build.build(force=True)
case = cs.DRAFT_CASES[0]
_, b, s, t, d, f, h, kh, hd, norm, _, _, act, _ = case
sets = [cs.draft_case_inputs(case, i) for i in range(10)]
x = sets[0][4]
start = torch.tensor(t - 1, dtype=torch.int32, device="cuda")
qkw = dict(pos0=t - 1, seq=1, norm=norm, eps=1e-6, use_rope=True, theta=1e4, heads=h,
           kv_heads=kh, head_dim=hd)
q = torch.empty((b, h * hd), device="cuda")
layer = cs.cycle(sets)
def launch():
    z = layer()
    ops._launch_qkv_rope(x, z[0], z[1], q, z[5], z[6], start, **qkw)
ln1, attn_p, _, _, _, kbuf, vbuf = sets[0]
got = ops.qkv_rope(x, ln1, attn_p, kbuf.clone(), vbuf.clone(), start, **qkw)
want = qkv_rope_ref(x, ln1, attn_p, kbuf.clone(), vbuf.clone(), start.cpu(), **qkw)
err = float((got - want).abs().max())
print(json.dumps({"ms": [cs.graph_ms(launch, n=50) for _ in range(3)], "max_abs_err": err}))
'''


def variant_source(text: str, name: str, variants=None) -> str:
    for old, new in (variants or VARIANTS)[name]:
        if old not in text:
            raise RuntimeError(f"{name}: the kernel no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def run(kernel: str, variants: dict, measure: str) -> int:
    """Build and time each variant of csrc/draft_decode.cu in a process of its own,
    in the order base, the variants, base; print the card and one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print(f"{kernel}_ablation: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    out = ROOT / "build" / f"{kernel}_ablation"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    (out / "measure.py").write_text(measure)
    text = (ROOT / "src" / "repro_torch" / "csrc" / "draft_decode.cu").read_text()
    res = {}
    for name in ["base", *[n for n in variants if n != "base"], "base"]:
        pkg = out / name / "src" / "repro_torch"
        if not pkg.exists():
            shutil.copytree(ROOT / "src" / "repro_torch", pkg,
                            ignore=shutil.ignore_patterns("__pycache__"))
            (pkg / "csrc" / "draft_decode.cu").write_text(variant_source(text, name, variants))
        proc = subprocess.run([sys.executable, str(out / "measure.py"), str(pkg.parent),
                               str(ROOT / "chip_smoke.py")], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-2000:] + proc.stderr[-4000:], file=sys.stderr)
            return 1
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        res.setdefault(name, []).append(got)
        print(f"{name}: {got}", flush=True)
    base_ms = min(min(r["ms"]) for r in res["base"])
    if max(r["max_abs_err"] for r in res["base"]) > 1e-4:
        print(f"{kernel}_ablation: the base kernel disagrees with its plain version",
              file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({f"{kernel}_ablation": {
        "card": card, "base_ms": base_ms,
        "saved_ms": {n: base_ms - min(min(r["ms"]) for r in rs)
                     for n, rs in res.items() if n != "base"},
        "runs": res}}))
    return 0


def main() -> int:
    return run("qkv_rope", VARIANTS, MEASURE)


if __name__ == "__main__":
    sys.exit(main())
