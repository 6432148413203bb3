#!/usr/bin/env python
"""Where head_proj_kernel's time goes: the kernel timed with one phase removed.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 tools/head_ablation.py

As ``tools/qkv_rope_ablation.py`` (whose runner it uses): each variant is a copy of
``src/repro_torch`` under ``build/head_ablation/`` whose ``csrc/draft_decode.cu`` has one
phase of ``head_proj_kernel`` cut out by a text patch, built with ``nvcc`` and timed in a
process of its own at the draft's decode shape (32 rows, D = 768, V = 27, row-major
weights, one weight set: as ``chip_smoke.py`` times the head warm; a CUDA graph of 50
launches, median of 7), three times, in the order base, the variants, base. A variant's
outputs are wrong by construction; the base's are checked against the plain version.
Prints the card and one JSON line.
"""

from __future__ import annotations

import importlib.util
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("qkv_rope_ablation",
                                               ROOT / "tools" / "qkv_rope_ablation.py")
_runner = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_runner)

_STATS_LOOP = "for (int k = 4 * tid; k < t.ldx; k += 4 * kHeadThreads)"

# name -> [(text in csrc/draft_decode.cu, replacement)]
VARIANTS = {
    "base": [],
    # the rows and the norm's parameters are not copied (the statistics read garbage)
    "no_rows_copy": [("    for (int r = 0; r < RT + 2; ++r) {\n      const float* src = r < RT",
                      "    for (int r = 0; r < 0 * RT; ++r) {\n      const float* src = r < RT")],
    # the weight slab of a row-major w with V <= nt is not copied
    "no_weight_copy": [("    for (int q = 0; q < t.s; ++q) {\n      const int len = min(run,",
                        "    for (int q = 0; q < 0 * t.s; ++q) {\n      const int len = min(run,")],
    # the statistics' and the normalisation's loops run no element; the sums, the
    # barriers and the butterflies stay
    "no_statistics": [(_STATS_LOOP, _STATS_LOOP.replace("k < t.ldx", "k < 0 * t.ldx"))],
    "no_products": [("  const int len4 = (min(t.sl, max(0, a.D - k0)) + 3) & ~3;",
                     "  const int len4 = 0 * ((min(t.sl, max(0, a.D - k0)) + 3) & ~3);")],
    "no_combine_or_store": [("  for (int i = tid; i < RT * t.nt; i += kHeadThreads) {",
                             "  for (int i = tid; i < 0 * RT * t.nt; i += kHeadThreads) {")],
}

MEASURE = r'''
import importlib.util, json, sys, torch
src, smoke = sys.argv[1], sys.argv[2]
spec = importlib.util.spec_from_file_location("chip_smoke", smoke)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
sys.path.insert(0, src)
import repro_torch
assert repro_torch.__file__.startswith(src), repro_torch.__file__
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.draft_decode import head_ref, ops
resolve_device("cuda")
_build.build(force=True)
g = torch.Generator(device="cuda").manual_seed(0)
r, d, v = cs.NUM, 768, cs.VOCAB
x = torch.randn((r, d), generator=g, device="cuda")
ln = {"scale": 1.0 + 0.1 * torch.randn(d, generator=g, device="cuda"),
      "bias": 0.1 * torch.randn(d, generator=g, device="cuda")}
w = torch.randn((d, v), generator=g, device="cuda") / d ** 0.5
out = torch.empty((r, v), device="cuda")
kw = dict(norm="layernorm", eps=1e-6)
got = ops.head(x, ln, w, **kw)
err = float((got - head_ref(x, ln, w, **kw)).abs().max())
print(json.dumps({"ms": [cs.graph_ms(lambda: ops._launch_head(x, ln, w, out, **kw), n=50)
                         for _ in range(3)], "max_abs_err": err}))
'''


def variant_source(text: str, name: str) -> str:
    return _runner.variant_source(text, name, VARIANTS)


if __name__ == "__main__":
    sys.exit(_runner.run("head", VARIANTS, MEASURE))
