#!/usr/bin/env python
"""The tile of flash_attn_kernel<256, 256> (head_dim 256, gemma3-1b), measured.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 tools/flash_tile_sweep.py

Each variant is a copy of ``src/repro_torch`` under ``build/flash_tile_sweep/``
whose ``csrc/flash_attn.cu`` sets ``Tiles<256, 256>::kBlockK`` (keys a tile; the
query tile stays 64 rows over 4 warps) and ``Tiles<256, 256>::kSplit`` (blocks that
share a query tile, each with D / kSplit columns of V and of the output) by a
text patch. It is built with
``nvcc -Xptxas -v`` and run in a process of its own: the kernel against its
plain version, and its device time (``chip_smoke.graph_ms``: a CUDA graph of
20 launches, median of 7) at gemma3-1b's shapes, 4 heads, one KV head, 4 x
1024 tokens: bidirectional with the local window of 512, causal with it, and
bidirectional without a window. Variants run in the order of ``VARIANTS``,
then the first again. Prints each variant's registers and spills, the card
and one JSON line.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
ANCHORS = ("static constexpr int kBlockK = DV <= 128 ? 32 : {};",
           "static constexpr int kSplit = DV <= 128 ? 1 : {};")

# name -> (keys a tile, blocks a query tile) at head_dim 256
VARIANTS = {"bk32_split2": (32, 2), "bk16_split2": (16, 2), "bk16_split1": (16, 1),
            "bk32_split1": (32, 1)}

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
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn import flash_attention_ref, ops
resolve_device("cuda")
_build.build(force=True, ptxas_info=True)
usage = {k: v for k, v in cs.ptxas_usage(_build.build_log).items()
         if "flash_attn_kernel" in k and "ILi256" in k}
b, s, h, kh, d = 4, 1024, 4, 1, 256
q, k, v = cs.flash_inputs(b, s, h, kh, d, 0)
out = torch.empty_like(q)
res = {"usage": list(usage.values()), "ms": {}, "max_abs_err": 0.0}
for name, causal, window in (("bidir_w512", False, 512), ("causal_w512", True, 512),
                             ("bidir", False, None)):
    ops._launch(q, k, v, out, causal=causal, window=window, scale=1 / math.sqrt(d))
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    res["max_abs_err"] = max(res["max_abs_err"], float((out - want).abs().max()))
    res["ms"][name] = cs.graph_ms(lambda: ops._launch(q, k, v, out, causal=causal,
                                                       window=window, scale=1 / math.sqrt(d)))
print(json.dumps(res))
'''


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_tile_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    out = ROOT / "build" / "flash_tile_sweep"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    (out / "measure.py").write_text(MEASURE)
    text = (ROOT / "src" / "repro_torch" / "csrc" / "flash_attn.cu").read_text()
    anchors = []
    for i, pattern in enumerate(ANCHORS):
        found = next((pattern.format(v[i]) for v in VARIANTS.values()
                      if pattern.format(v[i]) in text), None)
        if found is None:
            print(f"flash_tile_sweep: flash_attn.cu no longer holds {pattern!r}",
                  file=sys.stderr)
            return 1
        anchors.append(found)
    res = {}
    names = list(VARIANTS)
    for name in names + names[:1]:
        pkg = out / name / "src" / "repro_torch"
        if not pkg.exists():
            shutil.copytree(ROOT / "src" / "repro_torch", pkg,
                            ignore=shutil.ignore_patterns("__pycache__"))
            patched = text
            for i, (anchor, pattern) in enumerate(zip(anchors, ANCHORS)):
                patched = patched.replace(anchor, pattern.format(VARIANTS[name][i]))
            (pkg / "csrc" / "flash_attn.cu").write_text(patched)
        proc = subprocess.run([sys.executable, str(out / "measure.py"), str(pkg.parent),
                               str(ROOT / "chip_smoke.py")], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-2000:] + proc.stderr[-4000:], file=sys.stderr)
            return 1
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        res.setdefault(name, []).append(got)
        print(f"{name}: {got}", flush=True)
        if got["max_abs_err"] > 1e-4 or any(u.get("spill") for u in got["usage"]):
            print(f"flash_tile_sweep: {name} spills or disagrees with the plain version",
                  file=sys.stderr)
    print(card)
    print(json.dumps({"flash_tile_sweep": {"card": card, "runs": res}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
