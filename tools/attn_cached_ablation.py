#!/usr/bin/env python
"""Where attn_cached_kernel's time goes: the kernel timed with one phase removed.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 tools/attn_cached_ablation.py [VARIANT ...]   # default: every variant

As ``tools/qkv_rope_ablation.py`` (whose runner it uses): each variant is a copy of
``src/repro_torch`` under ``build/attn_cached_ablation/`` whose ``csrc/draft_decode.cu``
has one phase of ``attn_cached_kernel`` cut out, or one of its constants changed, by a
text patch, built with ``nvcc -Xptxas -v`` and
timed in a process of its own, three times, in the order base, the variants, base, at
PERF.md's rows 5z (``ms``: starcoder2-3b's decode, 8 rows, 24 heads of 128, kv 2) and 5
(``ms_dit``: the DiT's, 32 rows, 12 heads of 64), and at minitron-4b's decode (``ms_m``:
8 rows, 24 heads of 128, kv 8), one token a row, the cursor on the
last row, each launch on its own K/V of a set that exceeds the L2 twice (as
``tools/kernel_times.py``; a CUDA graph of 50 launches, median of 7). A variant's
outputs (a phase cut out) may be wrong by construction; the base's are checked against
the plain version at each shape. ``ptxas`` gives each attn_cached instance's registers
and spill bytes.
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

# name -> [(text in csrc/draft_decode.cu, replacement)]
VARIANTS = {
    "base": [],
    # no K or V copied into shared memory (the scores read whatever is there)
    "no_kv_copy": [
        ("    copy_tile<NT>(ks, KLD, kb, ld, n, HD, n, HD, a.k, vec);\n", ""),
        ("  if (nch == 1 && tid >= 32) {", "  if (false) {"),
    ],
    "no_scores": [("    attn_scores<HD, NG>(qs, P, NG * g, ks + tl * (HD + 4), scale, sv);",
                   "    for (int u = 0; u < NG; ++u) sv[u] = 0.f;")],
    "no_exp": [("ps[tl * SL + sp * ACC + j] = p < P ? expf(__fsub_rn(sc[p * sld + tl], gmax[p])) : 0.f;",
                "ps[tl * SL + sp * ACC + j] = p < P ? 1.f : 0.f;")],
    "no_pv": [("  for (int tl = 0; tl < n; ++tl) {\n    const float x = vs[tl * HD + d];",
               "  for (int tl = 0; tl < 0 * n; ++tl) {\n    const float x = vs[tl * HD + d];")],
    "no_combine": [("  for (int o = rank * per + tid; o < min(total, (rank + 1) * per);",
                    "  for (int o = rank * per + tid; o < 0 * min(total, (rank + 1) * per);")],
    # other constants: 128 threads a block for 16 pairs too
    "threads_128": [("  static constexpr int kThreads = PB >= 16 ? 256 : 128;",
                     "  static constexpr int kThreads = 128;")],
    # barriers (1) and (2) released by every thread, V copied by every warp
    "release_by_all": [
        ("  __syncthreads();\n  cluster_release_arrive(tid == 0);\n  cp_async_wait<0>();",
         "  cluster_arrive();\n  cp_async_wait<0>();"),
        ("  __syncthreads();   // (2) every rank's partials are written, released as at (1)\n"
         "  cluster_release_arrive(tid == 0);",
         "  cluster_arrive();"),
        ("  if (nch == 1 && tid >= 32) {   // warps 1 .. : warp 0 keeps nothing in flight (see (1))\n"
         "    const int step = vec ? 4 : 1, cols = HD / step;\n"
         "    for (int i = tid - 32; i < len * cols; i += NT - 32) {",
         "  if (nch == 1) {\n    const int step = vec ? 4 : 1, cols = HD / step;\n"
         "    for (int i = tid; i < len * cols; i += NT) {")],
    # the cluster instances' launch bounds with a minimum of one block an SM (ptxas may
    # then take more registers)
    "min_blocks": [("__global__ void __launch_bounds__(AttnTile<HD, PB>::kThreads) "
                    "attn_cached_kernel(",
                    "__global__ void __launch_bounds__(AttnTile<HD, PB>::kThreads, 1) "
                    "attn_cached_kernel(")],
    # block barriers in place of the three cluster barriers, and no remote read
    "no_cluster": [
        ("  cluster_release_arrive(tid == 0);\n  cp_async_wait<0>();   // V of a one-stage "
         "slice, while the cluster meets\n  cluster_wait();",
         "  cp_async_wait<0>();\n  __syncthreads();"),
        ("  cluster_release_arrive(tid == 0);\n  cluster_wait();\n", ""),
        ("  cluster_arrive_relaxed();\n  cluster_wait();\n}", "  __syncthreads();\n}"),
        ("m = fmaxf(m, cluster.map_shared_rank(lmax, r)[tid]);", "m = fmaxf(m, lmax[tid]);"),
        ("    float sum = cluster.map_shared_rank(part, 0)[o];", "    float sum = part[o];"),
        ("      if (r < a.C) sum = __fadd_rn(sum, cluster.map_shared_rank(part, r)[o]);",
         "      if (r < a.C) sum = __fadd_rn(sum, part[o]);"),
        ("    float l = cluster.map_shared_rank(lpart, 0)[tid];\n"
         "    for (int r = 1; r < a.C; ++r) l = __fadd_rn(l, cluster.map_shared_rank(lpart, r)[tid]);",
         "    float l = lpart[tid];"),
    ],
    # 2 .. 4 pairs (minitron-4b's decode, G = 3) on the 16-pair instance
    "pairs_16_for_4": [("  if (pt <= 4) return launch_attn_pb<HD, 4>(a, B, stream);",
                        "  if (false) return launch_attn_pb<HD, 4>(a, B, stream);")],
    # one pair (the DiT's decode) on a cluster, as the other pair counts
    "no_solo": [("  if (pt == 1 && solo <= kMaxSmem) {", "  if (false) {")],
}

MEASURE = r'''
import importlib.util, json, math, sys, torch
src, smoke = sys.argv[1], sys.argv[2]
sys.path.insert(0, src)
spec = importlib.util.spec_from_file_location("chip_smoke", smoke)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
sys.path.insert(0, src)
import repro_torch
assert repro_torch.__file__.startswith(src), repro_torch.__file__
from repro_torch.kernels import _build
from repro_torch.kernels.draft_decode import attn_cached_ref, ops
_build.build(force=True, ptxas_info=True)
res = {"ptxas": {k.split("attn_cached")[-1][:40]: v
                 for k, v in cs.ptxas_usage(_build.build_log).items() if "attn_cached" in k}}
t = cs.MAX_LEN
errs = []
for key, (b, h, kh, hd) in (("ms", (8, 24, 2, 128)), ("ms_dit", (cs.NUM, 12, 12, 64)),
                            ("ms_m", (8, 24, 8, 128))):
    g = torch.Generator(device="cuda").manual_seed(0)
    n_sets = max(2, math.ceil(2 * cs.L2_BYTES / (2 * 4 * b * t * kh * hd)))
    sets = [tuple(torch.randn((b, t, kh * hd), generator=g, device="cuda") for _ in range(2))
            for _ in range(n_sets)]
    q = torch.randn((b, h * hd), generator=g, device="cuda")
    out = torch.empty_like(q)
    start = torch.tensor(t - 1, dtype=torch.int32, device="cuda")
    kw = dict(pos0=t - 1, seq=1, heads=h, kv_heads=kh, head_dim=hd)
    kv = cs.cycle(sets)
    res[key] = [cs.graph_ms(lambda: ops._launch_attn_cached(q, *kv(), start, out, **kw), n=50)
                for _ in range(3)]
    ops._launch_attn_cached(q, *sets[0], start, out, **kw)
    errs.append(float((out - attn_cached_ref(q, *sets[0], start, **kw)).abs().max()))
res["max_abs_err"] = max(errs)
print(json.dumps(res))
'''


def main() -> int:
    names = sys.argv[1:] or list(VARIANTS)
    return _runner.run("attn_cached", {n: VARIANTS[n] for n in ["base", *names]}, MEASURE)


if __name__ == "__main__":
    sys.exit(main())
