"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` with
``nvcc``, holds each kernel against its plain PyTorch version on the card,
then serves the ``dfm_dit`` CONFIG backbone at full width (12 x 768,
seq 256, 32 samples, random seeded weights) through ``WarmStartServer``:
the draft stage is the KV-cached AR draft engine (``dfm_dit`` CONFIG run as
a causal decoder, seed 1, 256 tokens per row after a shared 16-token
prompt) through the ``qkv_rope``, ``attn_cached``, ``post_attn`` and
``head`` kernels; the refine runs the ``ws_step`` kernel as its step and
the ``flash_attn`` kernel in every attention. It checks the NFE guarantee,
the launch counts, the draft engine's bit-exactness (batched prefill ==
token scan, engine == oracle) and the tokens and logits against the plain
CPU path. It then serves 16 mixed requests through ``WarmStartScheduler``
(``ws_step``'s per-row mode, ``ws_fused``), and runs the paper's generation
API, ``WarmStartPipeline.generate``, on the same backbone drafted by the
paper's §4.2 Text-8 LSTM (2 x 512, seed 2, through ``ARDraft``): 32 x 256
at t0 = 0.8 (13 NFE, each one ``ws_step_gumbel`` launch that draws its noise
in the kernel: the default Euler step), the cold pipeline (64 NFE) and
``EulerSampler(fused_block=2)``, with exact launch counts, and the measured
draft cost ratio. Besides each kernel against its plain version, the
``ws_step_gumbel`` keyed launch must equal the given-noise launch on
``prng.gumbel``'s noise and ``ws_fused`` must equal K composed launches, bit
for bit, at every lanes a row; ``ptxas`` must report no spills for any
instance of the ws, flash_attn and draft kernels. ``attn_cached`` is also
held against its plain version at ``ATTN_CASES`` (a cursor in mid-buffer, T
not a multiple of its slice, T below the cluster, T = 57 812, G = 1 to 32,
every head dim, one pair alone in its one block and past that block's limit; NaN in
every key past the chunk's end) and must give a query
token's output bit for bit alike launched alone (R = 1 or 32 rows), inside a
16-token chunk or in chunks 3 + 1 + 4 + 8; it is timed at a mid-decode cursor
too.

The AR draft's decode and the refine loops run as CUDA graphs, one
replay a call, captured once per compile key: it gates one capture per
key (the serve, the scheduler's ``(rows, prefix, bucket_len)``, the
pipeline's warm, cold and fused samplers), every graph against its eager
launches bit for bit (the decode at 32 x 255 steps with the prefix reused
and recomputed, two serves, the pipeline against ``jit=False``), a step
key read on the card against the host's words, and the launch counts of
each call (a replay counts what was captured; a call that captures counts
its eager warm-up run too); it prints the capture times, the draft's wall
and device time and busy share, and the graphed and eager times side by
side. The scheduler's masked per-row refine is one graph per compile key
(two row-t0 mixes of one key: one capture, each replay == its eager
launches) and is timed against its eager launches; the LSTM draft is one
graph per call shape, == its eager launches. A capture that a
synchronisation broke must leave the default CUDA generator drawing and a
fresh capture working.

The training phase trains the same backbone through ``launch/train.main``
(32 x 256, AMSGrad, 30 steps): the train step is one CUDA graph
(``jit_train_step``, as JAX jits it), captured at the first step, whose one
step is the capture's warm-up, and replayed at the 29 others, with exactly 12
``flash_attn`` launches a step; 3 graphed steps are held against 3 eager
steps from one init (losses, grad norms, every weight and AMSGrad moment,
bit for bit where two eager runs agree, else within 2 x the summed learning
rates), a step is profiled by phase (eager) and three steps' busy share is
taken eager and graphed; the two-moons study trains through the same graphs.

After the training phase, the drafting policies run on the trained DiT and
the AR engine over the 16 scheduler requests: ``AdaptiveT0Policy`` on a
calibration fitted to the text corpus (single- and multi-time probe),
``per_row_t0`` with ``speculative`` accept against speculation off, and
``BanditT0Policy`` through ``serve_requests`` and ``serve_stream``, with
exact launch counts, every request ending once, accepted == its pre-pass
drafts, rejected == speculation off, one ``draft_fn`` call a bucket, the
bandit's pulls == priors + rows refined, and a small policy scheduler on the
card == the CPU.

The distilled phase then serves the distilled tier behind the trained DiT
on the same probe and calibration: the 16 requests served guaranteed with a
``PairBuffer`` attached (70 pairs, their refined rows == the served
tokens), ``train_distilled`` on them (one graph a batch shape, each step
held against its eager launches as the DiT's; finite loss, the checkpoint round
trip bitwise), the floor at the median of the minimum scores of the
requests routed distilled (the odd ones), then the mix through
``serve_requests`` (twice) and ``serve_stream`` with a ``SpanTracer``:
served and fallbacks both > 0, every distilled request at NFE K and at or
above the floor, guaranteed and fallback requests bitwise those of the
all-guaranteed run, the ledger balanced and equal to the registry, a
valid trace with one ``request_fallback`` a fallback, exact launch counts,
one capture per distilled key, each replay == its eager launches with K
``ws_step_rows`` launches; it times the head (K = 1, 2), the gate probe and
a guaranteed micro-batch at (32, 256), and runs ``python -m
repro_torch.launch.serve --scheduler --draft ar-kv --tier distilled
--check-distilled --stream --trace-out ...`` at its defaults (exit 0).

Last, the dense zoo: every kernel against its plain version at the zoo's
shapes (``post_attn`` at d_model 3072 with F = 12288 and 9216, its slices
streamed in stages; ``qkv_rope`` and ``attn_cached`` at head_dim 128 and
16; the head at (3072, 49152) tied and (3072, 256000); ``ws_step`` and
``ws_step_rows`` at V = 49152 and 262144; ``flash_attn`` at head_dim 128 and
256 with gemma3-1b's 512-token window in both masks, and 16), their times
there, starcoder2-3b at its published widths (float32, random weights, seed
0) served 8 x 256 at t0 = 0.8 (13 NFE) drafted by the same config as a
causal decoder (seed 1) through the four draft kernels as one graph replay,
with exact launch counts, prefill == scan and graph == eager bitwise and its
logits against the plain CPU path; gemma3-1b's logits at 1 x 600 tokens
against the CPU; the four archs' smoke configs served on the card == the
CPU.

Then the recurrent family: ``flash_attn`` at head_dim 80 (Zamba2's shared
attention, both masks, no spill) and ``ws_step`` at V = 32000 and 50304
against their plain versions and timed; zamba2-2.7b (8 rows, 12 of its 54
layers) and xlstm-1.3b (4 rows) at their published widths (float32, seed 0)
served at 256 tokens, 13 NFE, each drafted by its own config as a causal decoder
(seed 1; the plain decode path, prompt prefilled by scan, the decode one
graph replay): two serves with exact launch counts and one capture per
key, the second against its eager launches drafted by a fresh engine and
the draft's reused and recomputed prefix against that fresh engine,
bitwise (the JAX engine's reference fault R7 not carried over), the
logits at 1 x 64 against the CPU; zamba2-2.7b's flow stage profiled; both
smoke configs served on the card == the CPU.

Then the encoder-decoder family: ``flash_attn`` over whisper-medium's
1500 frames (the encoder's 1500 x 1500, the cross attention's 256 x 1500,
the draft decode's 1 x 1500; the smoke config's shapes) and ``ws_step`` at
V = 51865 against their plain versions and timed; whisper-medium at its
published widths, 4 of its 24 encoder and 4 of its 24 decoder layers
(float32, seed 0, 8 rows of 1500 frames made
from a seed) served 8 x 256, 13 NFE, through ``WarmStartServer`` on a
``Conditioned`` model (the frames bound to ``dfm_apply``), drafted by
``ar_generate`` on the same config (seed 1) with the frames at seq_len 257
(the JAX engine's reference fault R8: 256 tokens), one CUDA graph replay a
draft: two serves with exact launch counts (12 ``flash_attn`` and 1
``ws_step`` a NFE; the draft 8 at its prefill and 4 a decode step; the
first serve twice both, the captures' warm-ups), one capture of the refine
and one of the draft, the second serve's refine replay == its eager
launches and its draft replay == the eager draft on the same key, bitwise,
the logits at 1 x 64 against the CPU, an NFE's encoder and cross k/v
shares, the flow stage and one whole draft replay profiled; the smoke
config served on the card == the CPU.

Then the MoE family: ``flash_attn`` at arctic-480b's refine (8 x 256, 56
heads of 128, kv 8) and ``ws_step`` at V = 32000 (the device-key launch
against the host key's too) against their plain versions and timed;
arctic-480b at its published widths with one of its 35 layers (128
experts, top-2, float32, seed 0: 56.3 GB of weights) served 8 x 256, 13
NFE, three times, drafted by the same model as a causal decoder (the plain
decode path: the dropless MoE path in the decode graph, the capacity path
in the refine's): exact launches (13 ``flash_attn`` and 13 ``ws_step`` a
serve, no draft kernel), one capture each, the first serve's graphs == their
eager launches, the layer's MoE FFN at 1 x 64 against float64 on both
dispatches, the flow stage profiled, an eager NFE and an eager decode step
by kind of op (the dropless gather, the expert GEMMs, the other GEMMs); the
smoke config served and trained 3 steps on the card == the CPU.

Then the MLA family: ``flash_attn<192, 128>`` (queries and keys 192 wide,
values 128) at deepseek-v3-671b's refine (8 x 256, 128 heads) and causal
at a small shape, ``flash_attn<48, 32>`` at its smoke config's serve, and
``ws_step`` at V = 129 280 (the device-key launch against the host key's
too) against their plain versions and timed; deepseek-v3-671b at its
published widths with one of its 3 dense ``mla`` layers and one ``mla_moe`` layer
(256 experts top-8 beside a shared one; float32, seed 0: 60.4 GB of
weights) served 8 x 256, 13 NFE, twice, drafted by the same model as a
causal decoder (the plain decode path: the naive latent expansion and the
dropless MoE path in the decode graph, the capacity path in the refine's):
exact launches (52 ``flash_attn`` and 13 ``ws_step`` a serve, no draft
kernel), one capture each, the first serve's graphs == their eager
launches, a prefix layer's MLA at 1 x 64 against float64 (the kernel path,
the naive and the absorbed cached paths), the MoE FFN at 1 x 64 against
float64 on both dispatches (routed and shared experts), the absorbed
decode's first step within 1e-4 of the naive one's logits and its draft
timed, the flow stage profiled, an eager NFE and an eager decode step
(naive and absorbed) by kind of op; the smoke config served and trained 3
steps on the card == the CPU; the phase within 120 s.

Then the VLM family: ``flash_attn<128>`` at qwen2-vl-72b's refine (8 x
(256 patches + 256 text), 64 heads over 8 KV heads, q and k rotated by
M-RoPE) and ``ws_step`` at V = 152 064 (the device-key launch against the
host key's too) against their plain versions and timed (SDPA beside);
qwen2-vl-72b at its published widths with 4 of its 80 layers (float32, seed
0: 24.1 GB of weights) served 8 x 256 text tokens after 256 patches a row
(0.1 N(0, 1), numpy seed 7: the ViT's stub, as in JAX) at Qwen2-VL's
M-RoPE ids of a 16 x 16 grid, 13 NFE, twice, through ``WarmStartServer`` on
``Conditioned(model, {"patches", "positions"})``, drafted by the same model
as a causal decoder on the text alone (the plain decode path): exact
launches (52 ``flash_attn`` and 13 ``ws_step`` a serve, no draft kernel),
one capture each, the second serve's replay == its eager launches bitwise,
the patches' rows flipped in place moving the replay's tokens, the logits at
1 x (256 + 64) against a float64 forward in plain torch, the flow stage
profiled; the smoke config's forward, serve and 3 train steps on the card
== the CPU.

Then it trains those three families at their published widths and depth
(float32, seed 0; whisper over frames made as its serve's): at 2 x 256
tokens the WS-DFM loss's gradient through the ``flash_attn`` kernel
(``FlashAttentionFn``) against autograd through the plain attention, every
parameter within 1e-3 of its max |g| and none all zero but the leaves JAX
leaves zero (zamba2-2.7b's ``zshared`` positions' ``ln1``), two backwards
without remat against each other and remat against no remat (bitwise where
the two agree), with exact ``flash_attn`` launches (9, 0 and 72 a forward,
twice that with remat); then 1 + 3 steps at 8 x 256 with remat and AdamW,
each one CUDA graph replay after the capturing first, zamba2-2.7b and
xlstm-1.3b through ``Trainer.fit``, whisper-medium through
``jit_train_step(make_train_step(...))`` with its frames (the reference's
R9: ``fit`` builds no frames), with finite losses and grad norms, moved
weights, exact launches a step and one capture, one more replay profiled
for the device's busy share, an eager step timed beside it, and 3
graphed steps against 3 eager ones from one init at 2 x 256 (zamba2-2.7b
and xlstm-1.3b cut to one pattern group, whisper-medium at full depth);
each smoke config (the MoE, MLA and VLM ones in their phases) trained 3
steps on the card eager and graphed, each == the CPU, and the graph == the
eager steps; and ``python -m
repro_torch.launch.train --smoke --steps 3`` for zamba2-2.7b and xlstm-1.3b
(exit 0). Last it runs the README's torch quickstart snippet and the four
``examples/*_torch.py`` on the card as subprocesses, all at once (each exit 0, its NFEs
equal to ``warm_nfe``, its headline numbers read from its report).

It prints the card, ``{"serve": ...}``, ``{"scheduler": ...}``,
``{"pipeline": ...}``, ``{"train": ...}``, ``{"policy": ...}``,
``{"distilled": ...}``, ``{"zoo": ...}``, ``{"recurrent": ...}``,
``{"encdec": ...}``, ``{"moe": ...}``, ``{"mla": ...}``, ``{"vlm": ...}``,
``{"train_zoo": ...}`` and ``{"examples": ...}`` lines, a ``{"kernels":
[...]}`` line (the zoo's shapes under ``zoo``, the recurrent family's under
``recurrent``, whisper's under ``encdec``, arctic-480b's under ``moe``,
deepseek-v3's under ``mla``, qwen2-vl-72b's under ``vlm``, the
families' training launches under ``flash_attn``'s ``train_zoo``) and, last,
``{"ok": true, "device": ...}``. Any
failure raises and exits non-zero; without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import dataclasses
import itertools
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

# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, float32 (non-tensor)
# operations/s and dense TF32 tensor-core operations/s, all at the full
# 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12

SEQ, NUM, COLD_NFE, T0, VOCAB = 256, 32, 64, 0.8, 27
WS_TIE_TOL = 1e-5
FLASH_TOL = 1e-4
# the AR draft: a 16-token prompt shared by the rows, then SEQ tokens
PROMPT, DRAFT_SEED = 16, 1
MAX_LEN = PROMPT + SEQ - 1
PROJ_TOL = 1e-4      # x max(1, max |plain|), for qkv_rope, post_attn and head
ATTN_TOL = 1e-5      # absolute, for attn_cached
ATTN_MID_END = 144   # a mid-decode cursor's end, of MAX_LEN = 271 keys
L2_BYTES = 50e6      # an H100's L2 cache
DRAFT_KERNELS = ("qkv_rope", "attn_cached", "post_attn", "head")


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


def bound_ms(nbytes: float, nops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / ops_per_s * 1e3
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


def measure_ws_step(r, v, plain_n=20):
    """``ms`` is the kernel the serve's refine graph launches, the step key
    read on the card (``ws_step_dkey_kernel``); ``byvalue_ms`` the same body
    with the key's words passed by value (eager callers with a host key).
    The plain version is timed over ``plain_n`` calls a graph."""
    from repro_torch import prng
    from repro_torch.core.paths import WarmStartPath
    from repro_torch.kernels.ws_step import (
        key_words, ops, seed_from_key, ws_step, ws_step_ref_streamed,
    )

    path = WarmStartPath(t0=T0)
    logits, x, t = ws_inputs(r, v, 0)
    h = torch.tensor(1.0 / COLD_NFE, device="cuda")
    key = prng.key(1)
    seed = seed_from_key(key)
    dkey = key.to("cuda")
    words = key_words(dkey)
    a = torch.clamp(h * path.velocity_scale(t), 0.0, 1.0)
    out = torch.empty(r, dtype=torch.int32, device="cuda")

    def plain():
        noise = prng.threefry_gumbel(seed, r, v, device="cuda")
        return ws_step_ref_streamed(logits, x, a, noise)

    ms = graph_ms(lambda: ops._launch(logits, x, a, out, words, 1.0), n=50)
    byvalue_ms = graph_ms(lambda: ops._launch(logits, x, a, out, seed, 1.0), n=50)
    call_ms = time_ms(lambda: ws_step(dkey, logits, x, t, h, path))
    plain_ms = graph_ms(plain, n=plain_n, reps=7 if plain_n >= 20 else 3)
    nbytes = r * v * 4 + 3 * r * 4
    bms, by = bound_ms(nbytes, WS_OPS_PER_ELEMENT * r * v)
    return {"ms": ms, "byvalue_ms": byvalue_ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None}


WS_LANES = (2, 4, 8, 16, 32)    # the lanes a row the ws_step kernels admit; 32 is draw_row's


def lanes_inputs(r, v, seed):
    """Both modes' inputs at (r, v): the single-key step, and the per-row
    step as (r / n, n, v) with one key and weight per request row."""
    from repro_torch import prng
    from repro_torch.core.paths import WarmStartPath
    from repro_torch.kernels.ws_step import seed_from_key

    path = WarmStartPath(t0=T0)
    logits, x, t = ws_inputs(r, v, seed)
    a = torch.clamp(path.velocity_scale(t) / COLD_NFE, 0.0, 1.0)
    a[0] = 0.0                                 # a frozen row
    n = 256 if r % 256 == 0 else 16
    keys = prng.key_data(prng.split(prng.key(seed), r // n)).to("cuda", torch.int64)
    return logits, x, a, seed_from_key(prng.key(seed)), n, keys


def check_ws_lanes(r, v, seed):
    """ws_step and ws_step_rows at every admissible lanes a row, the
    kernel's own choice (lanes = 0) among them, against one warp a row
    (draw_row's layout): the tokens must be equal, bitwise."""
    from repro_torch.kernels.ws_step import ops

    logits, x, a, seed_w, n, keys = lanes_inputs(r, v, seed)
    b = r // n
    outs = {}
    for lanes in (0,) + WS_LANES:
        step = torch.empty(r, dtype=torch.int32, device="cuda")
        rows = torch.empty((b, n), dtype=torch.int32, device="cuda")
        ops._launch(logits, x, a, step, seed_w, 1.0, lanes=lanes)
        ops._launch_rows(logits.view(b, n, v), x.view(b, n), a[:b].contiguous(), keys, rows,
                         1.0, lanes=lanes)
        outs[lanes] = (step, rows.reshape(-1))
    torch.cuda.synchronize()
    ref = outs[32]
    differ = {lanes: int((o[0] != ref[0]).sum()) + int((o[1] != ref[1]).sum())
              for lanes, o in outs.items()}
    chosen = ops.lanes_for(v)
    print(f"ws_step lanes a row at ({r}, {v}): the kernels take {chosen}; tokens differing from "
          f"32 lanes a row (both modes, bitwise), by lanes (0 = the kernels' choice): {differ}")
    if any(differ.values()):
        fail(f"the grouped ws_step draw differs from draw_row's: {differ}")
    return {"rows": r, "vocab": v, "lanes": chosen, "differ": sum(differ.values())}


def measure_ws_lanes(r, v):
    """Device time of both modes at each lanes a row, (r, v) as in
    check_ws_lanes (the per-row mode as (r / 256, 256, v)); ``ws_step`` with
    the key read on the card (the refine graph's kernel), beside it
    ``ws_step_byvalue`` with the words by value."""
    from repro_torch import prng
    from repro_torch.kernels.ws_step import key_words, ops

    logits, x, a, seed_w, n, keys = lanes_inputs(r, v, 5)
    words = key_words(prng.key(5).to("cuda"))
    b = r // n
    step = torch.empty(r, dtype=torch.int32, device="cuda")
    rows = torch.empty((b, n), dtype=torch.int32, device="cuda")
    lg3, x2, ab = logits.view(b, n, v), x.view(b, n), a[:b].contiguous()
    res = {"ws_step": {}, "ws_step_byvalue": {}, "ws_step_rows": {}}
    for lanes in WS_LANES:
        res["ws_step"][lanes] = graph_ms(
            lambda: ops._launch(logits, x, a, step, words, 1.0, lanes=lanes), n=50)
        res["ws_step_byvalue"][lanes] = graph_ms(
            lambda: ops._launch(logits, x, a, step, seed_w, 1.0, lanes=lanes), n=50)
        res["ws_step_rows"][lanes] = graph_ms(
            lambda: ops._launch_rows(lg3, x2, ab, keys, rows, 1.0, lanes=lanes), n=50)
    print(f"ws_step by lanes a row at ({r}, {v}), us device: "
          + json.dumps({k: {g: round(ms * 1e3, 3) for g, ms in d.items()} for k, d in res.items()}))
    return res


def launch_floor_ms():
    """This card's device time per launch of the least kernel: a CUDA graph
    of one-element in-place adds."""
    one = torch.zeros(1, device="cuda")
    return graph_ms(lambda: one.add_(1.0), n=50)


# -- ws_step_gumbel ----------------------------------------------------------------

# per element, the function's own work: lg / T, the max, lg - m, exp, the sum,
# the division, the mix (2 products and a sum), the clamp, log, + g and the
# argmax's compare; counted against the float32 rate
WS_GUMBEL_OPS_PER_ELEMENT = 13


def gumbel_inputs(r, vp, valid_v, seed):
    """Logits padded with zeros past ``valid_v`` (as the JAX package pads to
    128 lanes), tokens, mixing weights (one row at a = 0) and the noise of
    ``jax.random.gumbel`` for a seeded key, all on the card."""
    from repro_torch import prng

    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.zeros((r, vp), device="cuda")
    logits[:, :valid_v] = 3.0 * torch.randn((r, valid_v), generator=g, device="cuda")
    x = torch.randint(0, valid_v, (r, 1), generator=g, device="cuda", dtype=torch.int32)
    a = torch.rand((r, 1), generator=g, device="cuda")
    a[0] = 0.0
    noise = prng.gumbel(prng.key(seed), (r, vp), device="cuda")
    return logits, x, a, noise


def check_ws_step_gumbel(r, vp, valid_v, seed):
    from repro_torch.kernels.ws_step import near_tie_rows_probs, ws_step_gumbel, ws_step_gumbel_ref

    args = gumbel_inputs(r, vp, valid_v, seed)
    got = ws_step_gumbel(*args, valid_v=valid_v, row_block=8 if r % 8 == 0 else 1)
    want = ws_step_gumbel_ref(*args, valid_v=valid_v)
    ties = near_tie_rows_probs(*args, valid_v=valid_v, tol=WS_TIE_TOL)
    torch.cuda.synchronize()
    mismatch = (got != want)[:, 0]
    bad = mismatch & ~ties
    frozen = int(got[0, 0]) == int(args[1][0, 0])
    res = {"rows": r, "vocab": vp, "valid_v": valid_v, "mismatches": int(mismatch.sum()),
           "near_ties": int(ties.sum()),
           "max_abs_err": float((got - want)[~ties].abs().max()), "a0_frozen": frozen}
    print(f"ws_step_gumbel R={r} Vp={vp} valid_v={valid_v}: {res['mismatches']} mismatching "
          f"rows, {res['near_ties']} near-tie rows (best two probability-space scores within "
          f"{WS_TIE_TOL}), {int(bad.sum())} mismatches off the ties; a = 0 row unchanged: "
          f"{frozen}")
    if bool(bad.any()) or not frozen or int(got.max()) >= valid_v:
        fail(f"ws_step_gumbel kernel disagrees with its plain version: {res}")
    return res


# per element of the keyed step, beyond the 13 above: the 20-round hash (~72 integer
# ops), the uniform (~4), the noise's two logf and two expf and two divisions of the
# three passes (~40 float ops in all); counted against the float32 rate
WS_KEYED_OPS_PER_ELEMENT = 130


def check_ws_step_gumbel_keyed(r, v, seed):
    """The keyed launch (noise hashed in the kernel) at every lanes a row, and
    the kernels' choice, against the given-noise launch on prng.gumbel(key,
    (R, V)) at the same G, bitwise; through the wrapper against the plain
    version off near ties; a = 0 keeps the token."""
    from repro_torch import prng
    from repro_torch.kernels.ws_step import (
        near_tie_rows_probs, ops, seed_from_key, ws_step_gumbel_keyed, ws_step_gumbel_ref,
    )

    logits, x, a, _ = gumbel_inputs(r, v, v, seed)
    x, a = x[:, 0].contiguous(), a[:, 0].contiguous()
    key = prng.key(seed + 100)
    noise = prng.gumbel(key, (r, v), device="cuda")
    differ, outs = {}, {}
    for lanes in (0,) + WS_LANES:
        keyed = torch.empty(r, dtype=torch.int32, device="cuda")
        given = torch.empty((r, 1), dtype=torch.int32, device="cuda")
        ops._launch_gumbel_keyed(logits, x, a, seed_from_key(key), keyed, v, 1.0, lanes=lanes)
        ops._launch_gumbel(logits, x[:, None], a[:, None], noise, given, v, 1.0, lanes=lanes)
        outs[lanes] = keyed
        differ[lanes] = int((keyed != given[:, 0]).sum())
    got = ws_step_gumbel_keyed(key, logits, x, a)
    want = ws_step_gumbel_ref(logits, x[:, None], a[:, None], noise, valid_v=v)[:, 0]
    ties = near_tie_rows_probs(logits, x[:, None], a[:, None], noise, valid_v=v,
                               tol=WS_TIE_TOL)
    torch.cuda.synchronize()
    mismatch = got != want
    bad = mismatch & ~ties
    frozen = int(got[0]) == int(x[0])
    res = {"rows": r, "vocab": v, "lanes": ops.lanes_for(v), "keyed_vs_given": differ,
           "wrapper_vs_launch": int((got != outs[0]).sum()),
           "mismatches": int(mismatch.sum()), "near_ties": int(ties.sum()),
           "max_abs_err": float((got - want)[~ties].abs().max()), "a0_frozen": frozen}
    print(f"ws_step_gumbel keyed R={r} V={v}: tokens differing from the given-noise launch "
          f"on prng.gumbel noise at the same lanes a row (bitwise; 0 = the kernels' choice, "
          f"{res['lanes']}): {differ}; {res['mismatches']} from the plain version "
          f"({res['near_ties']} near-tie rows, {int(bad.sum())} mismatches off them); a = 0 "
          f"row unchanged: {frozen}")
    if any(differ.values()) or res["wrapper_vs_launch"] or bool(bad.any()) or not frozen:
        fail(f"the keyed ws_step_gumbel disagrees: {res}")
    return res


def measure_ws_step_gumbel(r, v):
    """Both noise sources at (r, v) and every lanes a row (``keyed``: the key
    read on the card, the kernel the pipeline's refine graph launches;
    ``keyed_byvalue``: its words by value); the default step, gumbel_step,
    as a whole at (NUM, SEQ, v) with its key on the card against the
    composition it replaces (prng.gumbel's torch ops, then the given-noise
    launch); and the kernels one gumbel_step launches (profiler)."""
    from repro_torch import prng
    from repro_torch.core.paths import WarmStartPath
    from repro_torch.core.sampler import gumbel_step
    from repro_torch.kernels.ws_step import (
        key_words, ops, seed_from_key, ws_step_gumbel, ws_step_gumbel_keyed,
        ws_step_gumbel_ref,
    )

    logits, x, a, noise = gumbel_inputs(r, v, v, 0)
    a.fill_(0.078125)                    # h * velocity_scale(t) at t = 0.8, h = 1/64
    x1, a1 = x[:, 0].contiguous(), a[:, 0].contiguous()
    key = prng.key(0)
    seed = seed_from_key(key)
    dkey = key.to("cuda")
    words = key_words(dkey)
    out = torch.empty((r, 1), dtype=torch.int32, device="cuda")
    by_lanes = {"keyed": {}, "keyed_byvalue": {}, "given": {}}
    for lanes in WS_LANES:
        by_lanes["keyed"][lanes] = graph_ms(
            lambda: ops._launch_gumbel_keyed(logits, x1, a1, words, out, v, 1.0, lanes=lanes),
            n=50)
        by_lanes["keyed_byvalue"][lanes] = graph_ms(
            lambda: ops._launch_gumbel_keyed(logits, x1, a1, seed, out, v, 1.0, lanes=lanes),
            n=50)
        by_lanes["given"][lanes] = graph_ms(
            lambda: ops._launch_gumbel(logits, x, a, noise, out, v, 1.0, lanes=lanes), n=50)
    chosen = ops.lanes_for(v)
    ms = by_lanes["keyed"][chosen]
    call_ms = time_ms(lambda: ws_step_gumbel_keyed(dkey, logits, x1, a1))
    plain_ms = graph_ms(lambda: ws_step_gumbel_ref(logits, x, a, noise, valid_v=v))
    bms, by = bound_ms(r * v * 4 + 3 * r * 4, WS_KEYED_OPS_PER_ELEMENT * r * v)
    given_bms, given_by = bound_ms(2 * r * v * 4 + 3 * r * 4, WS_GUMBEL_OPS_PER_ELEMENT * r * v)

    # the default Euler step as the pipeline calls it: (B, N, V) logits, t (B,), h on the card
    path = WarmStartPath(t0=T0)
    b, n = r // SEQ, SEQ
    lg3, x2 = logits.view(b, n, v), x.view(b, n)
    t = torch.full((b,), T0, device="cuda")
    h = torch.tensor(1.0 / COLD_NFE, device="cuda")

    def before():
        g = prng.gumbel(key, (b, n, v), device="cuda").reshape(-1, v)
        aa = torch.clamp(h * path.velocity_scale(t), 0.0, 1.0)
        aa = aa.reshape(b, 1).expand(b, n).reshape(-1, 1)
        return ws_step_gumbel(lg3.reshape(-1, v), x2.reshape(-1, 1), aa, g, valid_v=v,
                              row_block=1)

    step_ms = graph_ms(lambda: gumbel_step(dkey, lg3, x2, t, h, path), n=20)
    before_ms = graph_ms(before, n=20)
    profile = _profile(lambda: (gumbel_step(dkey, lg3, x2, t, h, path),
                                torch.cuda.synchronize()), "default step (gumbel_step)")
    print(f"ws_step_gumbel at ({r}, {v}), us device by lanes a row: "
          + json.dumps({k: {g: round(t_ * 1e3, 3) for g, t_ in d.items()}
                        for k, d in by_lanes.items()})
          + f"; the kernels take {chosen}: keyed {ms * 1e3:.2f} us, key on the card (by "
          f"value {by_lanes['keyed_byvalue'][chosen] * 1e3:.2f} us; bound {bms * 1e3:.3f} us, "
          f"{by}), given {by_lanes['given'][chosen] * 1e3:.2f} us (bound "
          f"{given_bms * 1e3:.3f} us, {given_by}), plain {plain_ms * 1e3:.1f} us")
    print(f"gumbel_step at ({b}, {n}, {v}), device ms a step: {step_ms:.5f} (one keyed "
          f"launch and the scalar ops on a); before, prng.gumbel's torch ops and the "
          f"given-noise launch: {before_ms:.5f}; kernels in one step (profiler): "
          f"{profile.get('kernel_launches')}")
    n_kernels = profile.get("kernel_launches")
    if n_kernels is not None and n_kernels > 8:
        fail(f"gumbel_step launched {n_kernels} kernels: the noise is drawn outside the kernel")
    return {"ms": ms, "byvalue_ms": by_lanes["keyed_byvalue"][chosen], "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None,
            "lanes": chosen,
            "given_ms": by_lanes["given"][chosen], "given_bound_ms": given_bms,
            "ms_by_lanes": by_lanes, "gumbel_step_ms": step_ms,
            "gumbel_step_before_ms": before_ms, "gumbel_step_kernels": n_kernels}


# -- flash_attn ------------------------------------------------------------------

def flash_inputs(b, s, h, kh, d, seed, t=None, dv=None):
    """q (b, s, h, d), k (b, t, kh, d), v (b, t, kh, dv); dv defaults to d."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, s, h, d), generator=g, device="cuda")
    k = torch.randn((b, t or s, kh, d), generator=g, device="cuda")
    v = torch.randn((b, t or s, kh, dv or d), generator=g, device="cuda")
    return q, k, v


def check_flash(b, s, h, kh, d, causal, window, seed, t=None, dv=None):
    from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref

    q, k, v = flash_inputs(b, s, h, kh, d, seed, t, dv)
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    err = float((got - want).abs().max())
    print(f"flash_attn B={b} S={s} T={t or s} H={h} KH={kh} D={d} DV={dv or d} "
          f"causal={causal} window={window}: max abs err {err:.3e} (limit {FLASH_TOL})")
    if not math.isfinite(err) or err > FLASH_TOL:
        fail(f"flash_attn kernel disagrees with its plain version: {err}")
    return err


def measure_flash(b, s, h, d, kh=None, window=None, t=None, dv=None):
    """Bidirectional attention at (b, s, h, d) with kh KV heads (default h),
    an optional window, t keys (default s) and values dv wide (default d).
    The library call is SDPA on the same inputs with the KV heads repeated
    to h (and the window as a boolean mask); the bound counts the (query,
    key) pairs the window keeps."""
    from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref, ops
    from repro_torch.kernels.flash_attn.ref import attention_mask

    kh, t, dv = kh or h, t or s, dv or d
    q, k, v = flash_inputs(b, s, h, kh, d, 0, t, dv)
    out = q.new_empty((b, s, h, dv))
    scale = 1.0 / math.sqrt(d)
    ms = graph_ms(lambda: ops._launch(q, k, v, out, causal=False, window=window, scale=scale))
    call_ms = time_ms(lambda: flash_attention(q, k, v, causal=False, window=window))
    plain_ms = graph_ms(lambda: flash_attention_ref(q, k, v, causal=False, window=window))
    qt, kt, vt = (z.transpose(1, 2).repeat_interleave(h // z.shape[2], dim=1).contiguous()
                  for z in (q, k, v))
    mask = (None if window is None
            else attention_mask(s, t, causal=False, window=window, device="cuda"))
    library_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    pairs = float(s * t if mask is None else mask.sum())
    # q and k read (d wide), v read and out written (dv wide)
    nbytes = b * (s * h + t * kh) * (d + dv) * 4
    nops = 2.0 * b * h * pairs * (d + dv)
    # the function's bound: its products at the fastest rate that float32
    # inputs reach (TF32 on the tensor cores). For reference only, printed:
    # the floor of this kernel's 3xTF32 split (three TF32 products each) and
    # of a kernel on the CUDA cores.
    bms, by = bound_ms(nbytes, nops, TF32_OPS_PER_S)
    split_ms, split_by = bound_ms(nbytes, 3 * nops, TF32_OPS_PER_S)
    f32_ms, f32_by = bound_ms(nbytes, nops)
    print(f"flash_attn at ({b}, {s}, {h}, kv {kh}, {d}, dv {dv}, window {window}, T {t}): "
          f"{ms * 1e3:.1f} us device, "
          f"{nops / ms * 1e-9:.1f} TFLOP/s of the products ({3 * nops / ms * 1e-9:.1f} TF32 "
          f"TFLOP/s of 3xTF32); bound {bms * 1e3:.1f} us ({by}); computed floors for "
          f"reference: 3xTF32 on the tensor cores {split_ms * 1e3:.1f} us ({split_by}), "
          f"float32 on the CUDA cores {f32_ms * 1e3:.1f} us ({f32_by}); plain "
          f"{plain_ms * 1e3:.1f} us, SDPA {library_ms * 1e3:.1f} us")
    return {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": library_ms,
            "shape": {"B": b, "S": s, "T": t, "H": h, "KH": kh, "D": d, "DV": dv,
                      "window": window}}


def ptxas_usage(build_log: str) -> dict:
    """Spill bytes (stores + loads) and registers that ``ptxas -v`` reports,
    by kernel function."""
    out, name = {}, None
    for line in build_log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[-1].strip()
            out[name] = {}
        elif name is not None and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out[name]["spill"] = nums[1] + nums[2]   # stack frame, spill stores, spill loads
        elif name is not None and "registers" in line and "Used" in line:
            out[name]["registers"] = int(line.split("Used")[-1].split()[0])
            name = None
    return out


# -- draft_decode ------------------------------------------------------------------

def draft_layer(g, d, f, h, kh, hd, *, norm, bias, gated):
    """One layer's parameters in the JAX dict layout, on the card."""
    def dense(i, o):
        p = {"w": torch.randn((i, o), generator=g, device="cuda") / math.sqrt(i)}
        if bias:
            p["b"] = 0.1 * torch.randn(o, generator=g, device="cuda")
        return p

    def ln():
        p = {"scale": 1.0 + 0.1 * torch.randn(d, generator=g, device="cuda")}
        if norm == "layernorm":
            p["bias"] = 0.1 * torch.randn(d, generator=g, device="cuda")
        return p

    attn = {"wq": dense(d, h * hd), "wk": dense(d, kh * hd), "wv": dense(d, kh * hd),
            "wo": dense(h * hd, d)}
    mlp = {"up": dense(d, f), "down": dense(f, d)}
    if gated:
        mlp["gate"] = dense(d, f)
    return ln(), attn, ln(), mlp


# (name, B, S, T, D, F, H, KH, hd, norm, bias, gated, act, rope): the main
# path's decode and prefill shapes, then GQA + rmsnorm + gated + bias + no RoPE
DRAFT_CASES = [
    ("decode", NUM, 1, MAX_LEN, 768, 3072, 12, 12, 64, "layernorm", False, False, "gelu", True),
    ("prefill", NUM, PROMPT, MAX_LEN, 768, 3072, 12, 12, 64, "layernorm", False, False, "gelu",
     True),
    ("gqa-rmsnorm-gated-bias-norope", 8, 4, 64, 512, 1376, 8, 2, 64, "rmsnorm", True, True,
     "silu", False),
]


def draft_case_inputs(case, seed):
    _, b, s, t, d, f, h, kh, hd, norm, bias, gated, act, rope = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    ln1, attn_p, ln2, mlp_p = draft_layer(g, d, f, h, kh, hd, norm=norm, bias=bias, gated=gated)
    x = torch.randn((b * s, d), generator=g, device="cuda")
    kbuf = torch.randn((b, t, kh * hd), generator=g, device="cuda")
    vbuf = torch.randn((b, t, kh * hd), generator=g, device="cuda")
    return ln1, attn_p, ln2, mlp_p, x, kbuf, vbuf


def check_draft_kernels(case, seed):
    """Each draft kernel against its plain version on the same inputs; the
    cursor sits so the chunk ends at the buffer's last row."""
    from repro_torch.kernels.draft_decode import (
        attn_cached, attn_cached_ref, head, head_ref, post_attn, post_attn_ref, qkv_rope,
        qkv_rope_ref,
    )

    name, b, s, t, d, f, h, kh, hd, norm, bias, gated, act, rope = case
    ln1, attn_p, ln2, mlp_p, x, kbuf, vbuf = draft_case_inputs(case, seed)
    start = torch.tensor(t - s, dtype=torch.int32, device="cuda")
    kw = dict(heads=h, kv_heads=kh, head_dim=hd)
    qkw = dict(pos0=t - s, seq=s, norm=norm, eps=1e-6, use_rope=rope, theta=1e4, **kw)
    kk, vk, kr, vr = kbuf.clone(), vbuf.clone(), kbuf.clone(), vbuf.clone()
    pairs = {}
    q = qkv_rope(x, ln1, attn_p, kk, vk, start, **qkw)
    q_ref = qkv_rope_ref(x, ln1, attn_p, kr, vr, start, **qkw)
    pairs["qkv_rope"] = [(q, q_ref), (kk, kr), (vk, vr)]
    a = attn_cached(q_ref, kr, vr, start, pos0=t - s, seq=s, **kw)
    a_ref = attn_cached_ref(q_ref, kr, vr, start, pos0=t - s, seq=s, **kw)
    pairs["attn_cached"] = [(a, a_ref)]
    out = post_attn(a_ref, x, attn_p, ln2, mlp_p, norm=norm, eps=1e-6, act=act)
    out_ref = post_attn_ref(a_ref, x, attn_p, ln2, mlp_p, norm=norm, eps=1e-6, act=act)
    pairs["post_attn"] = [(out, out_ref)]
    w = torch.randn((d, VOCAB), generator=torch.Generator(device="cuda").manual_seed(seed),
                    device="cuda")
    if name.startswith("gqa"):
        w = w.T.contiguous().T            # a tied head: the table, transposed
    pairs["head"] = [(head(out_ref, ln1, w, norm=norm, eps=1e-6),
                      head_ref(out_ref, ln1, w, norm=norm, eps=1e-6))]
    torch.cuda.synchronize()
    errs = {}
    for k, ps in pairs.items():
        abs_err = max(float((g - w_).abs().max()) for g, w_ in ps)
        scale = max(1.0, max(float(w_.abs().max()) for _, w_ in ps))
        limit = ATTN_TOL if k == "attn_cached" else PROJ_TOL * scale
        errs[k] = {"abs": abs_err, "scale": scale, "limit": limit}
    print(f"draft kernels {name} (B={b} S={s} T={t} D={d} F={f} H={h} KH={kh} hd={hd} "
          f"{norm} bias={bias} gated={gated} {act} rope={rope}): max abs err "
          + ", ".join(f"{k} {e['abs']:.3e} (limit {e['limit']:.1e})" for k, e in errs.items()))
    for k, e in errs.items():
        if not math.isfinite(e["abs"]) or e["abs"] > e["limit"]:
            fail(f"{k} kernel disagrees with its plain version at {name}: {e}")
    return errs


# attn_cached alone against its plain version (name, B, S, T, H, KH, hd, cursor): the cases
# the cluster split meets that the draft layers' do not. Keys at or past the chunk's end
# hold NaN for the kernel and zeros for the plain version (the same function: they are
# masked), so a kernel that reads one fails
ATTN_CASES = [
    ("mid cursor, S = 5, G = 1", 3, 5, MAX_LEN, 12, 12, 64, 100),
    ("prefill at cursor 0, S = 16", 4, PROMPT, MAX_LEN, 12, 12, 64, 0),
    ("starcoder2-3b mid decode (end 144), G = 12", 8, 1, MAX_LEN, 24, 2, 128, 143),
    ("T = 37, not a multiple of W = 10, G = 2", 4, 3, 37, 8, 4, 32, 20),
    ("T = 5 at hd 16 (C = 4, W = 2): rank 3 holds nothing, G = 4", 2, 2, 5, 8, 2, 16, 1),
    ("T = 3 < C = 8, S = 1: ranks 3 .. 7 hold nothing", 3, 1, 3, 4, 4, 128, 2),
    ("S = T = 40, G = 4, 10 row tiles", 2, 40, 40, 8, 2, 64, 0),
    ("G = 32, two clusters a KV head", 2, 3, 64, 32, 1, 32, 30),
    ("T = 57 812, the old wrapper's limit, G = 12", 1, 2, 57812, 24, 2, 128, 57000),
    ("T = 57 812, G = 1, S = 1: one pair past the one-block limit", 1, 1, 57812, 2, 2, 128,
     30000),
    ("the DiT's decode at end 144, G = 1, S = 1: one block a pair", NUM, 1, MAX_LEN, 12, 12,
     64, 143),
    ("G = 1, S = 1 at hd 32 and T = 37", 2, 1, 37, 4, 4, 32, 20),
    ("G = 1, S = 1 at hd 16, T = 5 < C W", 2, 1, 5, 2, 2, 16, 1),
]


def check_attn_cases():
    """attn_cached against its plain version at ATTN_CASES, ATTN_TOL absolute."""
    from repro_torch.kernels.draft_decode import attn_cached, attn_cached_ref

    errs = {}
    for i, (name, b, s, t, h, kh, hd, cur) in enumerate(ATTN_CASES):
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        q = torch.randn((b * s, h * hd), generator=g, device="cuda")
        kbuf = torch.randn((b, t, kh * hd), generator=g, device="cuda")
        vbuf = torch.randn((b, t, kh * hd), generator=g, device="cuda")
        kref, vref = kbuf.clone(), vbuf.clone()
        kbuf[:, cur + s:], vbuf[:, cur + s:] = math.nan, math.nan
        kref[:, cur + s:], vref[:, cur + s:] = 0.0, 0.0
        start = torch.tensor(cur, dtype=torch.int32, device="cuda")
        kw = dict(pos0=cur, seq=s, heads=h, kv_heads=kh, head_dim=hd)
        err = float((attn_cached(q, kbuf, vbuf, start, **kw)
                     - attn_cached_ref(q, kref, vref, start, **kw)).abs().max())
        errs[name] = err
        print(f"attn_cached {name} (B={b} S={s} T={t} H={h} KH={kh} hd={hd} cursor={cur}): "
              f"max abs err {err:.3e} (limit {ATTN_TOL:.0e})")
        if not math.isfinite(err) or err > ATTN_TOL:
            fail(f"attn_cached disagrees with its plain version at {name}: {err}")
    return errs


# (H, KH, hd): the DiT's layer, starcoder2-3b's, and GQA at hd 16 and 32
ATTN_INVARIANCE = [(12, 12, 64), (24, 2, 128), (8, 2, 16), (8, 4, 32), (4, 4, 128),
                   (8, 8, 16)]


def check_attn_batch_invariance(h, kh, hd, seed, rows=NUM, t=MAX_LEN, c0=100):
    """Kernel level: the outputs of the 16 query tokens at positions c0 ..
    c0 + 15 of each of ``rows`` batch rows, launched as one S = 16 chunk,
    as chunks 3 + 1 + 4 + 8, as 16 one-token launches of all rows (R =
    ``rows``) and, for the last row, alone (R = 1), agree bit for bit. Keys
    at or past c0 + 16 hold NaN: no launch may read them."""
    from repro_torch.kernels.draft_decode import attn_cached

    g = torch.Generator(device="cuda").manual_seed(seed)
    kd, s, last = kh * hd, PROMPT, rows - 1
    kbuf = torch.randn((rows, t, kd), generator=g, device="cuda")
    vbuf = torch.randn((rows, t, kd), generator=g, device="cuda")
    kbuf[:, c0 + s:], vbuf[:, c0 + s:] = math.nan, math.nan
    q = torch.randn((rows, s, h * hd), generator=g, device="cuda")
    kw = dict(heads=h, kv_heads=kh, head_dim=hd)

    def launch(rows_q, kb, vb, i0, width):
        start = torch.tensor(c0 + i0, dtype=torch.int32, device="cuda")
        x = rows_q[:, i0:i0 + width].reshape(-1, h * hd).contiguous()
        return attn_cached(x, kb, vb, start, pos0=c0 + i0, seq=width, **kw).view(
            rows_q.shape[0], width, h * hd)

    whole = launch(q, kbuf, vbuf, 0, s)
    runs, i0 = {}, 0
    parts = []
    for width in (3, 1, 4, 8):
        parts.append(launch(q, kbuf, vbuf, i0, width))
        i0 += width
    runs["chunks 3+1+4+8"] = torch.cat(parts, 1)
    runs[f"S = 1, R = {rows}"] = torch.cat([launch(q, kbuf, vbuf, i, 1) for i in range(s)], 1)
    alone = torch.cat([launch(q[last:], kbuf[last:], vbuf[last:], i, 1) for i in range(s)], 1)
    torch.cuda.synchronize()
    diffs = {k: int((v != whole).sum()) for k, v in runs.items()}
    diffs["S = 1, R = 1 (last row)"] = int((alone != whole[last:]).sum())
    finite = bool(torch.isfinite(whole).all())
    print(f"attn_cached batch invariance (H={h} KH={kh} hd={hd}, {rows} rows x 16 tokens "
          f"at cursor {c0}, NaN past the chunk): elements differing from the S = 16 launch "
          f"{diffs}; finite {finite}")
    if any(diffs.values()) or not finite:
        fail(f"attn_cached is not batch invariant at H={h} KH={kh} hd={hd}: {diffs}")
    return diffs


def cycle(items):
    """A function returning items[0], items[1], ... round and round."""
    it = itertools.cycle(items)
    return lambda: next(it)


HEAD_COLD_SETS = 650       # x 83 KB = 54 MB of head weights, more than the 50 MB L2


def measure_draft_kernels(case=None, vocab=VOCAB, n_sets=10, tied=False, cold_head=True):
    """Device time of each draft kernel at a decode shape (default the main
    path's: R = 32 rows, one token each, T = 271, the cursor at the last row
    so every key is valid), its plain version, the wrapper call, the bound.
    As in a decode step, which streams every layer's weights and caches
    through the 50 MB L2, the timed launches cycle through ``n_sets`` weight
    sets (at the DiT's widths 10: qkv_rope's 7.1 MB x 9 others between two
    uses of one set) and two caches (53 MB each at the DiT's), so every
    launch reads them cold. The head (``vocab`` columns; ``tied``: the table
    transposed) is timed warm (one weight set) and, with ``cold_head``, cold:
    a graph of HEAD_COLD_SETS launches, each on its own weight set (54 MB in
    all at the DiT's head, more than the L2), as a decode step finds it
    after 12 layers' weights."""
    from repro_torch.kernels.draft_decode import (
        attn_cached, attn_cached_ref, head, head_ref, ops, post_attn, post_attn_ref, qkv_rope,
        qkv_rope_ref,
    )

    case = case or DRAFT_CASES[0]
    _, b, s, t, d, f, h, kh, hd, norm, _, _, act, _ = case
    sets = [draft_case_inputs(case, i) for i in range(n_sets)]
    ln1, attn_p, ln2, mlp_p, x, kbuf, vbuf = sets[0]
    r, qd, kd = b * s, h * hd, kh * hd
    start = torch.tensor(t - 1, dtype=torch.int32, device="cuda")
    start_host = start.cpu()                        # the plain versions read it on the host
    kw = dict(heads=h, kv_heads=kh, head_dim=hd)
    qkw = dict(pos0=t - 1, seq=1, norm=norm, eps=1e-6, use_rope=True, theta=1e4, **kw)
    akw = dict(pos0=t - 1, seq=1, **kw)
    pkw = dict(norm=norm, eps=1e-6, act=act)
    q = torch.empty((r, qd), device="cuda")
    a = torch.empty((r, qd), device="cuda")
    x1, u, out = torch.empty_like(x), torch.empty((r, f), device="cuda"), torch.empty_like(x)
    w = torch.randn((vocab, d), device="cuda").T if tied else torch.randn((d, vocab), device="cuda")
    logits = torch.empty((r, vocab), device="cuda")
    ops._launch_qkv_rope(x, ln1, attn_p, q, kbuf, vbuf, start, **qkw)
    layer = cycle(sets)
    res = {}

    def entry(name, launch, call, plain, nbytes, nops, library=None):
        bms, by = bound_ms(nbytes, nops)
        res[name] = {"ms": graph_ms(launch, n=50), "call_ms": time_ms(call),
                     "plain_ms": graph_ms(plain, n=3, reps=5), "bound_ms": bms,
                     "bound_by": by, "library_ms": library() if library else None,
                     "shape": {"rows": r, "T": t, "D": d, "F": f, "H": h, "KH": kh, "hd": hd}}

    def qkv_launch():
        z = layer()
        ops._launch_qkv_rope(x, z[0], z[1], q, z[5], z[6], start, **qkw)

    def qkv_call():
        z = layer()
        return qkv_rope(x, z[0], z[1], z[5], z[6], start, **qkw)

    entry("qkv_rope", qkv_launch, qkv_call,
          lambda: qkv_rope_ref(x, ln1, attn_p, kbuf, vbuf, start_host, **qkw),
          4 * (d * (qd + 2 * kd) + 2 * d + r * d + r * (qd + 2 * kd)),
          2.0 * r * d * (qd + 2 * kd) + 8.0 * r * d)

    col = torch.arange(t, device="cuda")
    mask = ((col <= t - 1) & (col < int(start_host) + s)).view(1, 1, 1, t)
    # attn_cached cycles through enough caches (two at the DiT's 53 MB) that every launch
    # reads its K and V cold, as a decode step finds them after the other layers
    cache_bytes = 2 * 4 * b * t * kd
    kv_sets = [(z[5], z[6]) for z in sets[:2]]
    kv_sets += [tuple(torch.randn_like(c) for c in kv_sets[0])
                for _ in range(max(0, math.ceil(2 * L2_BYTES / cache_bytes) - len(kv_sets)))]
    caches = cycle(kv_sets)
    # SDPA's K/V: the caches' views, with GQA's KV heads repeated to H beforehand
    sdpa_kv = cycle([tuple(c.view(b, t, kh, hd).transpose(1, 2) if kh == h else
                           c.view(b, t, kh, hd).transpose(1, 2).repeat_interleave(h // kh, 1)
                           for c in z) for z in kv_sets[:2]])

    def sdpa(m=mask):
        kv = sdpa_kv()
        return torch.nn.functional.scaled_dot_product_attention(
            q.view(b, s, h, hd).transpose(1, 2), kv[0], kv[1], attn_mask=m)

    def attn_bound(keys):
        return (4 * (2 * b * keys * kd + 2 * r * qd),
                4.0 * r * h * keys * hd + 3.0 * r * h * keys)

    entry("attn_cached",
          lambda: ops._launch_attn_cached(q, *caches(), start, a, **akw),
          lambda: attn_cached(q, *caches(), start, **akw),
          lambda: attn_cached_ref(q, kbuf, vbuf, start_host, **akw),
          *attn_bound(t), library=lambda: graph_ms(sdpa))
    # a mid-decode cursor: end = ATTN_MID_END of T, about a 16-token-prompt serve's mean
    # (the bound counts the valid keys' bytes only)
    start_mid = torch.tensor(ATTN_MID_END - 1, dtype=torch.int32, device="cuda")
    mid_host = start_mid.cpu()
    mkw = dict(akw, pos0=ATTN_MID_END - 1)
    mask_mid = (col < ATTN_MID_END).view(1, 1, 1, t)
    bms, by = bound_ms(*attn_bound(ATTN_MID_END))
    res["attn_cached"]["mid"] = {
        "end": ATTN_MID_END,
        "ms": graph_ms(lambda: ops._launch_attn_cached(q, *caches(), start_mid, a, **mkw), n=50),
        "plain_ms": graph_ms(lambda: attn_cached_ref(q, kbuf, vbuf, mid_host, **mkw),
                             n=3, reps=5),
        "bound_ms": bms, "bound_by": by, "library_ms": graph_ms(lambda: sdpa(mask_mid))}
    res["attn_cached"]["kv_sets"] = len(kv_sets)

    def post(fn, *outs):
        z = layer()
        return fn(a, x, z[1], z[2], z[3], *outs, **pkw)

    entry("post_attn",
          lambda: post(ops._launch_post_attn, x1, u, out),
          lambda: post(post_attn),
          lambda: post_attn_ref(a, x, attn_p, ln2, mlp_p, **pkw),
          4 * (qd * d + 2 * d * f + 2 * d + r * (qd + 2 * d)),
          2.0 * r * (qd * d + 2 * d * f) + 10.0 * r * f)
    entry("head",
          lambda: ops._launch_head(out, ln1, w, logits, norm=norm, eps=1e-6),
          lambda: head(out, ln1, w, norm=norm, eps=1e-6),
          lambda: head_ref(out, ln1, w, norm=norm, eps=1e-6),
          4 * (d * vocab + 2 * d + r * d + r * vocab), 2.0 * r * d * vocab + 8.0 * r * d)
    res["head"]["shape"]["V"] = vocab
    if cold_head:
        heads = cycle([torch.randn((d, vocab), device="cuda") for _ in range(HEAD_COLD_SETS)])
        res["head"]["cold_ms"] = graph_ms(
            lambda: ops._launch_head(out, ln1, heads(), logits, norm=norm, eps=1e-6),
            n=HEAD_COLD_SETS, reps=5)
        print(f"head at decode shape, cold ({HEAD_COLD_SETS} weight sets): "
              f"{res['head']['cold_ms'] * 1e3:.2f} us device")
    mid = res["attn_cached"]["mid"]
    print(f"attn_cached at decode shape, end {mid['end']} of {t}: {mid['ms'] * 1e3:.2f} us "
          f"device (bound {mid['bound_ms'] * 1e3:.2f} us, {mid['bound_by']}), plain "
          f"{mid['plain_ms'] * 1e3:.1f} us, library {mid['library_ms'] * 1e3:.1f} us")
    for name, m in res.items():
        print(f"{name} at decode shape {m['shape']}: {m['ms'] * 1e3:.1f} us device (bound "
              f"{m['bound_ms'] * 1e3:.2f} us, {m['bound_by']}), call {m['call_ms'] * 1e3:.1f} us, "
              f"plain {m['plain_ms'] * 1e3:.1f} us"
              + (f", library {m['library_ms'] * 1e3:.1f} us" if m["library_ms"] else ""))
    return res


def draft_engine(cfg=None):
    """The AR draft engine over a seeded ``cfg`` model (default: the
    full-width ``dfm_dit`` CONFIG) through the draft kernels."""
    from repro_torch.configs.dfm_dit import CONFIG
    from repro_torch.drafting import ARDraftEngine, TransformerDraftAdapter
    from repro_torch.models import Model

    model = Model(cfg or CONFIG, device="cuda", seed=DRAFT_SEED)
    return ARDraftEngine(TransformerDraftAdapter(model=model, decode_impl="kernel"),
                         max_len=MAX_LEN)


def draft_prompt(rows, vocab=VOCAB):
    """The shared prompt, one numpy-seeded row repeated."""
    import numpy as np

    row = np.random.default_rng(7).integers(0, vocab, PROMPT).astype(np.int32)
    return torch.from_numpy(np.tile(row, (rows, 1)))


def check_prefill_equals_scan(engine, rows=NUM):
    """Full width: the 16-token batched prefill, 16 single-token calls and
    chunks of 3 + 1 + 4 + 8 give the same logits and cache, bitwise."""
    from repro_torch.kernels.draft_decode import DraftDecoder

    model = engine.adapter.model
    dec = DraftDecoder(model)
    toks = draft_prompt(rows, model.cfg.vocab_size).to("cuda")
    runs = []
    for split in ((PROMPT,), (1,) * PROMPT, (3, 1, 4, PROMPT - 8)):
        cache, parts, pos = model.init_cache(rows, MAX_LEN, torch.float32), [], 0
        for w in split:
            lg, cache = dec.forward_chunk(toks[:, pos:pos + w], cache, pos)
            parts.append(lg)
            pos += w
        runs.append((torch.cat(parts, 1), cache["blocks"]["p0"]))
    (ref, ref_cache), *others = runs
    diffs = [int((lg != ref).sum()) + sum(int((c[k] != ref_cache[k]).sum())
                                          for k in ("k", "v", "pos")) for lg, c in others]
    print(f"full-width forward_chunk ({model.cfg.name}), {rows} rows x {PROMPT} tokens: "
          f"batched prefill vs 16 "
          f"single-token calls, and vs chunks 3+1+4+8: {diffs} elements differ "
          f"(logits and every cache leaf, bitwise)")
    if any(diffs):
        fail("batched prefill is not bitwise equal to the token scan on the card")


def check_engine_equals_oracle():
    """At smoke_config size: the engine on the card equals the cache-free
    oracle bitwise, and again when the prefix is reused."""
    from repro_torch import prng
    from repro_torch.configs.dfm_dit import smoke_config
    from repro_torch.drafting import ARDraftEngine, oracle_generate_rows

    adapter = draft_engine(cfg=smoke_config()).adapter
    keys = prng.split(prng.key(3), 3)
    prompt = draft_prompt(3)[:, :3]
    eng = ARDraftEngine(adapter, max_len=3 + 12 - 1)
    out = [eng.generate_rows(keys, 12, prompt=prompt) for _ in range(2)]
    ref = oracle_generate_rows(adapter, keys, 12, prompt=prompt, max_len=14)
    diff = sum(int((o != ref).sum()) for o in out)
    print(f"draft engine vs oracle (smoke config, 3 rows, prompt 3, 12 tokens, computed then "
          f"reused prefix): {diff} tokens differ; stats {eng.stats.as_dict()}")
    if diff or eng.stats.prefill_reuses != 1:
        fail("the draft engine disagrees with its oracle on the card")


def check_draft_logits_against_cpu(engine):
    """Full width, teacher-forced: the 16-token prefill and 8 decode steps
    on the card (kernels) against the plain CPU path on the same weights."""
    from repro_torch.drafting import TransformerDraftAdapter
    from repro_torch.models import Model

    model = engine.adapter.model
    cpu = Model(model.cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    toks = torch.randint(0, VOCAB, (2, PROMPT + 8), generator=torch.Generator().manual_seed(4),
                         dtype=torch.int32)
    got, want = [], []
    for adapter, out in ((engine.adapter, got),
                         (TransformerDraftAdapter(model=cpu, decode_impl="kernel"), want)):
        dev = adapter.model.device
        cache = adapter.init_cache(2, MAX_LEN)
        lg, cache = adapter.prefill_batched(toks[:, :PROMPT].to(dev), cache)
        out.append(lg.cpu())
        for i in range(PROMPT, PROMPT + 8):
            lg, cache = adapter.decode_step(toks[:, i].to(dev), cache, i)
            out.append(lg.cpu())
    got, want = torch.stack(got), torch.stack(want)
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    print(f"full-width draft logits (2 rows, 16-token prefill + 8 teacher-forced steps), card "
          f"kernels vs CPU plain: max abs err {err:.3e} (logits up to {scale:.2f}; limit 1e-3 "
          f"relative)")
    if not math.isfinite(err) or err > 1e-3 * max(1.0, scale):
        fail(f"full-width draft logits disagree with the plain path: {err}")


# -- ws_step per-row mode and ws_fused ------------------------------------------------

FUSED_KS, FUSED_VS = (2, 4, 8), (VOCAB, 50257)


def step_inputs(b, n, v, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = 3.0 * torch.randn((b, n, v), generator=g, device="cuda")
    x = torch.randint(0, v, (b, n), generator=g, device="cuda", dtype=torch.int32)
    return logits, x


def rows_inputs(b, n, v, seed):
    from repro_torch import prng

    logits, x = step_inputs(b, n, v, seed)
    keys = prng.split(prng.key(seed), b).to("cuda")
    t = torch.linspace(0.5, 0.9, b, device="cuda")
    h = torch.full((b,), 1.0 / COLD_NFE, device="cuda")
    h[0] = 0.0                                  # an inactive request row: frozen
    return keys, logits, x, t, h


def check_ws_step_rows(b, n, v, seed):
    """The per-row mode against its plain version (euler_step_probs and the
    argmax with jax.random.gumbel noise per request row), tokens equal off
    counted near ties; a = 0 rows unchanged."""
    from repro_torch import prng
    from repro_torch.core.paths import WarmStartPath
    from repro_torch.kernels.ws_step import near_tie_rows, ws_step_rows, ws_step_rows_ref

    path = WarmStartPath(t0=0.0)
    keys, logits, x, t, h = rows_inputs(b, n, v, seed)
    got = ws_step_rows(keys, logits, x, t, h, path)
    a = torch.clamp(h * path.velocity_scale(t), 0.0, 1.0)
    want = ws_step_rows_ref(keys, logits, x, a)
    g = prng.gumbel(keys, (n, v), device="cuda").reshape(b * n, v)
    ties = near_tie_rows(logits.reshape(b * n, v), x.reshape(-1), a.repeat_interleave(n), g,
                         tol=WS_TIE_TOL).reshape(b, n)
    torch.cuda.synchronize()
    mismatch = got != want
    bad = mismatch & ~ties
    frozen = bool(torch.equal(got[0], x[0]))
    res = {"rows": b * n, "vocab": v, "mismatches": int(mismatch.sum()),
           "near_ties": int(ties.sum()),
           "max_abs_err": float((got - want)[~ties].abs().max()), "a0_frozen": frozen}
    print(f"ws_step_rows B={b} N={n} V={v}: {res['mismatches']} mismatching tokens, "
          f"{res['near_ties']} near-tie tokens, {int(bad.sum())} mismatches off the ties; "
          f"a = 0 row unchanged: {frozen}")
    if bool(bad.any()) or not frozen:
        fail(f"ws_step_rows kernel disagrees with its plain version: {res}")
    return res


def measure_ws_step_rows(b, n, v):
    from repro_torch.core.paths import WarmStartPath
    from repro_torch.kernels.ws_step import ops, ws_step_rows, ws_step_rows_ref

    path = WarmStartPath(t0=0.0)
    keys, logits, x, t, h = rows_inputs(b, n, v, 5)
    a = torch.clamp(h * path.velocity_scale(t), 0.0, 1.0)
    out = torch.empty((b, n), dtype=torch.int32, device="cuda")
    ms = graph_ms(lambda: ops._launch_rows(logits, x, a, keys, out, 1.0), n=50)
    call_ms = time_ms(lambda: ws_step_rows(keys, logits, x, t, h, path))
    plain_ms = graph_ms(lambda: ws_step_rows_ref(keys, logits, x, a))
    r = b * n
    bms, by = bound_ms(r * v * 4 + 8 * r + 20 * b, WS_OPS_PER_ELEMENT * r * v)
    return {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": None}


def fused_case(layout, k, b, n, v, seed):
    """Inputs of one ws_fused call: single-key or per-row keys, a padded
    tail step (single) or an inactive request row and one entering
    mid-block (per row)."""
    from repro_torch import prng

    logits, x = step_inputs(b, n, v, seed)
    if layout == "single":
        keys = prng.split(prng.key(seed), k)
        ts = 0.5 + torch.arange(k, dtype=torch.float32) / 16
        hs = torch.full((k,), 1 / 16)
        hs[-1] = 0.0
    else:
        keys = prng.fold_in(prng.split(prng.key(seed), b)[None], torch.arange(k)[:, None])
        ts = 0.5 + torch.arange(k, dtype=torch.float32)[:, None].expand(k, b) / 16
        hs = torch.full((k, b), 1 / 16)
        hs[:, 0] = 0.0
        hs[: k // 2, 1] = 0.0
    return keys.to("cuda"), logits, x, ts.to("cuda"), hs.to("cuda")


def check_ws_fused(layout, k, v, seed):
    """One launch of K steps against K composed launches, bitwise (single
    key: K ws_step launches; per row: K one-step ws_fused launches with the
    same counters), and against the plain version off the near ties met on
    its path; a = 0 rows unchanged."""
    from repro_torch.core.paths import WarmStartPath
    from repro_torch.kernels.ws_fused import ws_fused_ref, ws_fused_steps
    from repro_torch.kernels.ws_fused.ops import fused_inputs
    from repro_torch.kernels.ws_step import ws_step

    b, n = (32, 256) if v == VOCAB else (4, 16)
    path = WarmStartPath(t0=0.0)
    keys, logits, x, ts, hs = fused_case(layout, k, b, n, v, seed)
    got = ws_fused_steps(keys, logits, x, ts, hs, path)
    if layout == "single":
        composed = x
        for j in range(k):
            composed = ws_step(keys[j].cpu(), logits, composed, ts[j], hs[j], path)
        frozen = True
    else:
        composed = ws_fused_steps(keys, logits, x, ts, hs, path, impl="composed")
        frozen = bool(torch.equal(got[0], x[0]))
    seeds, lg, xr, a, key_group, a_group = fused_inputs(keys, logits, x, ts, hs, path)
    want, ties = ws_fused_ref(seeds, lg, xr, a, key_group=key_group, a_group=a_group,
                              tie_tol=WS_TIE_TOL)
    torch.cuda.synchronize()
    vs_composed = int((got != composed).sum())
    flat = got.reshape(-1)
    mismatch = flat != want
    bad = mismatch & ~ties
    res = {"layout": layout, "k": k, "rows": b * n, "vocab": v, "vs_composed": vs_composed,
           "mismatches": int(mismatch.sum()), "near_ties": int(ties.sum()),
           "max_abs_err": float((flat - want)[~ties].abs().max()), "a0_frozen": frozen}
    print(f"ws_fused {layout} K={k} R={b * n} V={v}: {vs_composed} tokens differ from "
          f"{k} composed launches (bitwise), {res['mismatches']} from the plain version "
          f"({res['near_ties']} rows met a near tie, {int(bad.sum())} mismatches off them); "
          f"a = 0 row unchanged: {frozen}")
    if vs_composed or bool(bad.any()) or not frozen:
        fail(f"ws_fused disagrees: {res}")
    return res


def check_ws_fused_lanes(layout, k, b, n, v, seed):
    """ws_fused at every admissible lanes a row, and the kernel's choice,
    against 32 lanes a row and K composed launches (single key: K ws_step
    launches; per row: K one-step ws_fused launches), bitwise."""
    from repro_torch.core.paths import WarmStartPath
    from repro_torch.kernels.ws_fused import ops, ws_fused_steps
    from repro_torch.kernels.ws_fused.ops import fused_inputs
    from repro_torch.kernels.ws_step import ws_step

    path = WarmStartPath(t0=0.0)
    keys, logits, x, ts, hs = fused_case(layout, k, b, n, v, seed)
    seeds, lg, xr, a, key_group, a_group = fused_inputs(keys, logits, x, ts, hs, path)
    sd, x32, a = seeds.to("cuda", torch.int64).contiguous(), xr.contiguous(), a.contiguous()
    outs = {}
    for lanes in (0,) + WS_LANES:
        outs[lanes] = torch.empty(b * n, dtype=torch.int32, device="cuda")
        ops._launch(lg, x32, a, sd, outs[lanes], key_group, a_group, 1.0, lanes=lanes)
    if layout == "single":
        composed = x
        for j in range(k):
            composed = ws_step(keys[j].cpu(), logits, composed, ts[j], hs[j], path)
    else:
        composed = ws_fused_steps(keys, logits, x, ts, hs, path, impl="composed")
    composed = composed.reshape(-1)
    torch.cuda.synchronize()
    differ = {lanes: int((o != outs[32]).sum()) + int((o != composed).sum())
              for lanes, o in outs.items()}
    print(f"ws_fused lanes a row, {layout} K={k} R={b * n} V={v}: tokens differing from 32 "
          f"lanes a row and from {k} composed launches (bitwise), by lanes (0 = the kernel's "
          f"choice): {differ}")
    if any(differ.values()):
        fail(f"ws_fused differs across lanes a row: {differ}")
    return {"layout": layout, "k": k, "rows": b * n, "vocab": v, "differ": sum(differ.values())}


def measure_ws_fused(b, n, v, k):
    """At the scheduler's layout (per-row keys and weights): the fused
    launch, K one-step launches, a graph of K ws_step launches at the same
    (R, V) (the launches a fused block saves), the plain version, the bound."""
    from repro_torch import prng
    from repro_torch.core.paths import WarmStartPath
    from repro_torch.kernels.ws_fused import ops, ws_fused_ref, ws_fused_steps
    from repro_torch.kernels.ws_fused.ops import fused_inputs
    from repro_torch.kernels.ws_step import ops as step_ops
    from repro_torch.kernels.ws_step import seed_from_key

    path = WarmStartPath(t0=0.0)
    keys, logits, x, ts, hs = fused_case("rows", k, b, n, v, 6)
    seeds, lg, xr, a, key_group, a_group = fused_inputs(keys, logits, x, ts, hs, path)
    xr = xr.contiguous()
    out = torch.empty(b * n, dtype=torch.int32, device="cuda")

    def composed():
        cur = xr
        for j in range(k):
            ops._launch(lg, cur, a[j:j + 1], seeds[j:j + 1], out, key_group, a_group, 1.0)
            cur = out

    step_seeds = [seed_from_key(kk) for kk in prng.split(prng.key(6), k)]
    step_a = a[:, -1:].expand(k, b * n).contiguous()   # the last request row: never frozen
    step_out = [torch.empty(b * n, dtype=torch.int32, device="cuda") for _ in range(k)]

    def ws_steps():
        cur = xr
        for j in range(k):
            step_ops._launch(lg, cur, step_a[j], step_out[j], step_seeds[j], 1.0)
            cur = step_out[j]

    ms = graph_ms(lambda: ops._launch(lg, xr, a, seeds, out, key_group, a_group, 1.0), n=50)
    composed_ms = graph_ms(composed, n=20)
    ws_steps_ms = graph_ms(ws_steps, n=20)
    call_ms = time_ms(lambda: ws_fused_steps(keys, logits, x, ts, hs, path))
    plain_ms = graph_ms(lambda: ws_fused_ref(seeds, lg, xr, a, key_group=key_group,
                                             a_group=a_group), n=3, reps=5)
    r = b * n
    bms, by = bound_ms(r * v * 4 + 8 * r + 20 * k * b, WS_OPS_PER_ELEMENT * k * r * v)
    return {"ms": ms, "composed_ms": composed_ms, "ws_step_graph_ms": ws_steps_ms,
            "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None}


# -- the scheduler ---------------------------------------------------------------------

SCHED = dict(cold_nfe=COLD_NFE, default_t0=T0, max_rows=32, row_quantum=4, min_bucket=8,
             max_bucket=256)
# (seq_len, num_samples, t0 override): buckets 128 and 256, t0 0.8 (13 NFE),
# 0.5 (32 NFE) and 0.9 (7 NFE)
SCHED_REQUESTS = [(256, 8, None), (200, 4, None), (130, 6, None), (250, 2, 0.5),
                  (90, 3, None), (65, 8, None), (256, 1, None), (180, 5, None),
                  (120, 2, 0.9), (100, 4, 0.9), (240, 7, None), (77, 1, None),
                  (256, 3, 0.5), (150, 2, None), (128, 6, None), (210, 8, None)]


def sched_requests():
    from repro_torch.serving import ServeRequest

    return [ServeRequest(request_id=i, seq_len=L, num_samples=n, seed=1000 + 7 * i, t0=t0)
            for i, (L, n, t0) in enumerate(SCHED_REQUESTS)]


def expected_launches(report, prefills, layers, fused_block=1, captured=(), refine_captured=(),
                      drafts=None, probe_evals=0):
    """Exact kernel launches of one scheduler run from its micro-batches:
    per micro-batch, n refine steps (ceil(n / K) backbone evaluations with
    fused blocks; twice for the first micro-batch of a compile key captured
    in the run: the capture's warm-up) and a draft of bucket_len tokens
    (bucket_len - 1 decode steps), plus one 1-token prefill per prefix
    computed and one eager decode (the capture's warm-up) per decode key
    ``(rows, prefix, seq_len)`` captured. In policy mode the drafts are the
    pre-pass's (``drafts``: the bucket length of each ``draft_fn`` call) and
    ``probe_evals`` backbone evaluations of the probe launch flash_attn too.
    A distilled micro-batch runs n = K steps of the head: K ws_step_rows
    launches and no backbone (the head's products are plain PyTorch)."""
    want = {k: 0 for k in ("ws_step_rows", "ws_fused", "flash_attn") + DRAFT_KERNELS}
    seen = set()
    for b in report["batches"]:
        n = b["nfe"]
        distilled = b.get("tier") == "distilled"
        key = (b["bucket_len"], b["padded_rows"], n) + (("distilled",) if distilled else ())
        runs = 2 if key in refine_captured and key not in seen else 1
        seen.add(key)
        if distilled:
            want["ws_step_rows"] += runs * n
            continue
        evals = runs * (n if fused_block == 1 else -(-n // fused_block))
        want["ws_step_rows" if fused_block == 1 else "ws_fused"] += evals
        want["flash_attn"] += evals * layers
    for blen in (drafts if drafts is not None else [b["bucket_len"] for b in report["batches"]]):
        for name in ("qkv_rope", "attn_cached", "post_attn"):
            want[name] += (blen - 1) * layers
        want["head"] += blen - 1
    want["flash_attn"] += probe_evals * layers
    steps = prefills + sum(seq_len - 1 for _, _, seq_len in captured)
    for name in ("qkv_rope", "attn_cached", "post_attn"):
        want[name] += steps * layers
    want["head"] += steps
    return want


def run_counted(what, sched, fn, engine, layers, fused_block=1, **policy):
    """Run ``fn() -> (out, report)`` (a run of ``sched``) with the launch
    counts from 0 and gate them against the run's micro-batches and the
    graphs it captured (``policy``: see :func:`expected_launches`)."""
    from repro_torch.kernels import launches

    pre, keys = engine.stats.prefill_computes, set(engine.graphs.capture_s)
    refine_keys = set(sched.graphs.capture_s)
    launches.clear()
    out, report = fn()
    torch.cuda.synchronize()
    got = dict(launches)
    policy = {k: v() if callable(v) else v for k, v in policy.items()}
    want = expected_launches(report, engine.stats.prefill_computes - pre, layers, fused_block,
                             set(engine.graphs.capture_s) - keys,
                             set(sched.graphs.capture_s) - refine_keys, **policy)
    if {k: got.get(k, 0) for k in want} != want or set(got) - set(want):
        fail(f"{what}: launches {got}, expected {want}")
    return out, report, got


def busy_share(fn, what="a scheduler run"):
    """Run ``fn`` under torch.profiler: the union of the kernels' device
    intervals over the wall time (kernels of the draft and refine streams
    that overlap count once), and their summed device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start]
    return _busy_of(spans, wall_ms, what)


def _busy_of(spans, wall_ms, what):
    """The union of the kernels' device intervals (microseconds) over the
    wall time, and their summed time."""
    spans = sorted(spans)
    if not spans:
        print(f"profile of {what}: the trace holds no device time (not measured)")
        return {"busy_share": None, "wall_ms": wall_ms}
    busy, (cur_s, cur_e), total = 0.0, spans[0], 0.0
    for s_, e_ in spans:
        total += e_ - s_
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    res = {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3, "device_sum_ms": total / 1e3,
           "busy_share": busy / 1e3 / wall_ms, "kernels": len(spans)}
    print(f"profile of {what}: device busy {res['device_busy_ms']:.1f} ms of "
          f"{wall_ms:.1f} ms wall ({res['busy_share']:.1%}; kernels' summed time "
          f"{res['device_sum_ms']:.1f} ms, {len(spans)} kernels)")
    return res


def trace_busy_share(fn, what):
    """:func:`busy_share`'s numbers from the profiler's Chrome trace, which the
    profiler writes itself, device activity only: ``prof.events()`` builds a
    Python object an event, which takes minutes at xlstm-1.3b's ~200k kernels
    a train step. Kernels are the trace's ``"cat": "kernel"`` events."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return _busy_of([(e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") == "kernel" and e.get("dur", 0) > 0], wall_ms, what)


def check_scheduler_refine_graph(model):
    """The scheduler's per-row refine at full width (8 rows x 128, cold_nfe
    64): two calls of one compile key with different row-t0 mixes (the
    active mask as data) capture once; each replay equals its eager
    launches bit for bit, with a replay's launch counts."""
    import numpy as np

    from repro_torch.core.sampler import refine_schedule_rows
    from repro_torch.kernels import launches
    from repro_torch.serving import WarmStartScheduler, uniform_draft
    from repro_torch.serving.scheduler import _derive_row_keys

    sched = WarmStartScheduler(flow_model=model, draft_fn=uniform_draft(VOCAB, device="cuda"),
                               device="cuda", **SCHED)
    res = []
    for i, mix in enumerate([(0.8,) * 8, (0.8, 0.85, 0.9, 0.95, 0.8, 0.9, 0.85, 0.8)]):
        x = torch.randint(0, VOCAB, (8, 128), generator=torch.Generator().manual_seed(i),
                          dtype=torch.int32).cuda()
        _, flow_keys = _derive_row_keys(np.full(8, 50 + i), np.arange(8))
        sch = refine_schedule_rows(mix, 1.0 / COLD_NFE, COLD_NFE)[:4]
        runs = []
        for fn in (lambda: sched._refine_loop((128, 8, 13), flow_keys, x, *sch),
                   lambda: sched._refine_loop_eager(flow_keys, x, *sch)):
            before = dict(launches)
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            runs.append((out, grown(before), (time.perf_counter() - t) * 1e3))
        (g, n_g, ms_g), (e, n_e, ms_e) = runs
        k = 2 if i == 0 else 1
        ok = torch.equal(g, e) and n_g == {name: k * c for name, c in n_e.items()}
        res.append({"row_t0s": list(mix), "equal": ok, "graph_ms": ms_g, "eager_ms": ms_e,
                    "launches": n_g})
        if not ok:
            fail(f"the scheduler's refine graph disagrees with its eager launches: {res}")
    # one micro-batch's refine: its wall (host clock) against its device time
    profiles = {name: _profile(lambda fn=fn: (fn(), torch.cuda.synchronize()),
                               f"scheduler refine 8 x 128, 13 steps ({name})")
                for name, fn in (
                    ("graph", lambda: sched._refine_loop((128, 8, 13), flow_keys, x, *sch)),
                    ("eager", lambda: sched._refine_loop_eager(flow_keys, x, *sch)))}
    st = sched.graphs.stats()
    print(f"scheduler refine graph (8 x 128, 13 steps, two row-t0 mixes): captures "
          f"{st['captures']}, replays {st['replays']}, bitwise equal to eager; graph ms "
          f"{[round(r['graph_ms'], 1) for r in res]} (the first captures), eager "
          f"{[round(r['eager_ms'], 1) for r in res]}")
    if (st["captures"], st["replays"]) != (1, 3):
        fail(f"the scheduler's refine: {st}, expected one capture and three replays")
    return {"calls": res, "graphs": st, "profiles": profiles}


def scheduler_path(model, engine):
    """The continuous-batching scheduler at full width: the dfm_dit backbone
    drafted by the full-width AR engine (BOS prompt), a fixed set of 16
    requests of mixed lengths, samples, seeds and t0 overrides."""
    import numpy as np

    from repro_torch import prng
    from repro_torch.core.guarantees import warm_nfe
    from repro_torch.core.paths import WarmStartPath
    from repro_torch.kernels import launches
    from repro_torch.serving import WarmStartScheduler, WarmStartServer

    layers = model.cfg.num_layers
    engine.reset()           # the scheduler's caches are allocated on its draft stream
    draft_fn = engine.as_draft_fn()

    def scheduler(**kw):
        return WarmStartScheduler(flow_model=model, draft_fn=draft_fn, device="cuda",
                                  **SCHED, **kw)

    reqs = sched_requests()
    sched = scheduler()
    cap0, seen, captures = engine.graphs.captures, set(), []

    def gate_captures(what, report, keys=None):
        """One decode capture per (rows, prefix, bucket_len) key ever drafted
        (the scheduler's BOS prompt: prefix 1), none for a key seen before."""
        seen.update(keys or ((b["padded_rows"], 1, b["bucket_len"]) for b in report["batches"]))
        captures.append(engine.graphs.captures - cap0)
        if captures[-1] != len(seen):
            fail(f"{what}: {captures[-1]} decode captures for {len(seen)} keys {sorted(seen)}")

    # the first run pays the draft engine's first prefills, the caches and a
    # decode capture per key
    _, rep_first, _ = run_counted("warm-up run", sched, lambda: sched.serve_requests(reqs),
                                  engine, layers)
    gate_captures("warm-up run", rep_first)
    refine_first = dict(sched.graphs.stats())
    first_keys = {(b["bucket_len"], b["padded_rows"], b["nfe"]) for b in rep_first["batches"]}
    if sched.graphs.captures != len(first_keys):
        fail(f"warm-up run: {sched.graphs.captures} refine captures for the compile keys "
             f"{sorted(first_keys)}")
    batch, rep_on, counts = run_counted("serve_requests (overlap on)", sched,
                                        lambda: sched.serve_requests(reqs), engine, layers)
    gate_captures("serve_requests (overlap on)", rep_on)
    streamed, rep_stream, _ = run_counted(
        "serve_stream", sched, lambda: (list(sched.serve_stream(reqs)), sched.stream_report),
        engine, layers)
    gate_captures("serve_stream", rep_stream)
    off = scheduler(overlap=False)
    serial, rep_off, _ = run_counted("serve_requests (overlap off)", off,
                                     lambda: off.serve_requests(reqs), engine, layers)
    gate_captures("serve_requests (overlap off)", rep_off)
    alone_id = 7
    lone = scheduler()
    alone, rep_alone, _ = run_counted(
        "one request alone", lone, lambda: lone.serve_requests([reqs[alone_id]]), engine,
        layers)
    gate_captures("one request alone", rep_alone)
    # overlap off on the scheduler whose graphs are captured (the new
    # scheduler's run above pays its captures), then the parent's refine:
    # eager launches, overlap on and off, on the same scheduler
    sched.overlap = False
    steady_off = sched.serve_requests(reqs)
    rep_off_steady = steady_off[1]
    eager_runs = []
    for overlap in (True, False):
        sched.overlap = overlap
        sched._refine_loop = lambda key, *a: sched._refine_loop_eager(*a)
        eager_runs.append(sched.serve_requests(reqs))
        del sched._refine_loop
    sched.overlap = True
    rep_eager_on, rep_eager_off = eager_runs[0][1], eager_runs[1][1]
    for res_e, _ in eager_runs + [steady_off]:
        if any(not np.array_equal(res_e[rid].tokens, r.tokens) for rid, r in batch.items()):
            fail("the scheduler's refine graphs disagree with their eager launches")
    refine_graph = check_scheduler_refine_graph(model)

    stream_by_id = {c.request_id: c for c in streamed}
    diffs = {"stream_vs_batch": 0, "overlap_off_vs_on": 0}
    for rid, r in batch.items():
        for name, other in (("stream_vs_batch", stream_by_id[rid]),
                            ("overlap_off_vs_on", serial[rid])):
            if other.tokens.shape != r.tokens.shape:
                fail(f"{name}: request {rid} shape {other.tokens.shape} vs {r.tokens.shape}")
            diffs[name] += int((other.tokens != r.tokens).sum())
    diffs["alone_vs_packed"] = int((alone[alone_id].tokens != batch[alone_id].tokens).sum())
    ledger = rep_stream["conservation"]
    n_mb = rep_on["num_micro_batches"]
    print(f"scheduler: {len(reqs)} requests, {rep_on['rows']} rows in {n_mb} micro-batches "
          f"(buckets {sorted({b['bucket_len'] for b in rep_on['batches']})}, NFE "
          f"{[b['nfe'] for b in rep_on['batches']]}); tokens differing: {diffs}; stream "
          f"ledger {ledger}; launches per run {counts}")
    if any(diffs.values()):
        fail(f"scheduler runs disagree: {diffs}")
    if not ledger["balanced"] or rep_stream["completed"] != len(reqs):
        fail(f"serve_stream ledger: {ledger}, completed {rep_stream['completed']}")
    for rid, r in batch.items():
        t0 = SCHED_REQUESTS[rid][2] or T0
        toks = r.tokens
        if (r.nfe != warm_nfe(COLD_NFE, t0) or toks.shape != (SCHED_REQUESTS[rid][1],
                                                              SCHED_REQUESTS[rid][0])
                or toks.dtype != np.int32 or toks.min() < 0 or toks.max() >= VOCAB):
            fail(f"request {rid}: nfe {r.nfe}, tokens {toks.shape} {toks.dtype}")
    if rep_on["jit_cache"]["misses"] != 0 or rep_on["jit_cache"]["hits"] != n_mb:
        fail(f"second run's jit_cache {rep_on['jit_cache']}")

    # fused blocks: K = 2 draws per backbone evaluation
    fsched = scheduler(fused_block=2)
    fused, rep_fused, fused_counts = run_counted(
        "serve_requests (fused_block=2)", fsched, lambda: fsched.serve_requests(reqs), engine,
        layers, fused_block=2)
    gate_captures("serve_requests (fused_block=2)", rep_fused)
    prompt = draft_prompt(NUM)
    path = WarmStartPath(t0=T0)
    server = WarmStartServer(
        flow_model=model, flow_cfg=model.cfg,
        draft_generate=lambda rng, num: engine.generate_rows(prng.split(rng, num), SEQ, prompt),
        path=path, cold_nfe=COLD_NFE, fused_block=2, device="cuda")
    launches.clear()
    x, rep_server = server.serve(prng.key(300), NUM)
    torch.cuda.synchronize()
    server_counts = dict(launches)
    gate_captures("WarmStartServer(fused_block=2)", None, keys=[(NUM, PROMPT, SEQ)])
    # the serve captures its refine: the warm-up's 7 evaluations, then the replay's
    if (rep_server["nfe"], rep_server["backbone_evals"]) != (13, 7) or \
            server_counts.get("ws_fused") != 14 or server_counts.get("flash_attn") != 14 * layers \
            or x.shape != (NUM, SEQ) or int(x.min()) < 0 or int(x.max()) >= VOCAB:
        fail(f"WarmStartServer(fused_block=2): {rep_server['nfe']} NFE, "
             f"{rep_server['backbone_evals']} evals, launches {server_counts}")
    print(f"fused_block=2: scheduler launches {fused_counts} (ceil(n/2) evaluations per "
          f"micro-batch); WarmStartServer 32 x 256: nfe 13, backbone_evals 7, launches "
          f"{server_counts} (capture warm-up and replay)")

    profile = busy_share(lambda: sched.serve_requests(reqs))
    print(f"scheduler decode graphs: first run {rep_first['wall_time_s']:.3f} s with "
          f"{captures[0]} captures (keys {sorted(seen)}); later runs replay (captures after "
          f"each gated run {captures}); capture ms by key "
          f"{json.dumps(engine.graphs.stats()['capture_ms'])}")
    print(f"scheduler wall: overlap on {rep_on['wall_time_s']:.3f} s (draft "
          f"{rep_on['draft_time_s']:.3f} s, flow {rep_on['flow_time_s']:.3f} s), overlap off "
          f"{rep_off['wall_time_s']:.3f} s (draft {rep_off['draft_time_s']:.3f} s, flow "
          f"{rep_off['flow_time_s']:.3f} s, its refine captures included; with the graphs "
          f"captured {rep_off_steady['wall_time_s']:.3f} s, draft "
          f"{rep_off_steady['draft_time_s']:.3f} s, flow {rep_off_steady['flow_time_s']:.3f} s); "
          f"{rep_on['samples_per_s']:.2f} samples/s; the "
          f"refine as eager launches (the parent's): overlap on "
          f"{rep_eager_on['wall_time_s']:.3f} s (flow {rep_eager_on['flow_time_s']:.3f} s), "
          f"off {rep_eager_off['wall_time_s']:.3f} s (flow "
          f"{rep_eager_off['flow_time_s']:.3f} s); refine graphs: first run "
          f"{refine_first['captures']} captures, ms by key "
          f"{json.dumps(refine_first['capture_ms'])}")
    report = {
        "config": model.cfg.name, "draft": "AR engine, dfm_dit CONFIG as causal decoder, "
        "BOS prompt", **SCHED, "requests": len(reqs), "rows": rep_on["rows"],
        "micro_batches": n_mb, "nfe_per_micro_batch": [b["nfe"] for b in rep_on["batches"]],
        "requests_per_s": rep_on["requests_per_s"], "samples_per_s": rep_on["samples_per_s"],
        "draft_s": rep_on["draft_time_s"], "flow_s": rep_on["flow_time_s"],
        "wall_s_overlap_on": rep_on["wall_time_s"], "wall_s_overlap_off": rep_off["wall_time_s"],
        "draft_s_overlap_off": rep_off["draft_time_s"], "flow_s_overlap_off": rep_off["flow_time_s"],
        "overlap_efficiency": rep_on["overlap_efficiency"],
        # per micro-batch: rows, padded rows, bucket, NFE, draft ms and flow ms,
        # overlap on and off
        "micro_batches_on": [[b["rows"], b["padded_rows"], b["bucket_len"], b["nfe"],
                              b["draft_time_s"] * 1e3, b["flow_time_s"] * 1e3]
                             for b in rep_on["batches"]],
        "micro_batches_off": [[b["rows"], b["padded_rows"], b["bucket_len"], b["nfe"],
                               b["draft_time_s"] * 1e3, b["flow_time_s"] * 1e3]
                              for b in rep_off["batches"]],
        "stream_wall_s": rep_stream["wall_time_s"],
        "stream_latency_s": rep_stream["latency_s"],
        "fused_block_2": {"wall_s": rep_fused["wall_time_s"], "flow_s": rep_fused["flow_time_s"],
                          "samples_per_s": rep_fused["samples_per_s"],
                          "jit_cache_fused": rep_fused["jit_cache"]["fused"]},
        "server_fused_block_2": {"flow_ms": rep_server["flow_time_s"] * 1e3,
                                 "backbone_evals": rep_server["backbone_evals"]},
        "jit_cache": {"hits": rep_on["jit_cache"]["hits"],
                      "misses": rep_on["jit_cache"]["misses"]},
        "launches_per_run": counts, "launches_fused_run": fused_counts,
        "token_diffs": diffs, "conservation": ledger, "profile": profile,
        "first_run": {"wall_s": rep_first["wall_time_s"], "draft_s": rep_first["draft_time_s"],
                      "flow_s": rep_first["flow_time_s"], "decode_captures": captures[0]},
        "decode_captures_after_each_run": captures,
        "decode_graphs": engine.graphs.stats(),
        "refine_graphs": sched.graphs.stats(), "refine_graphs_first_run": refine_first,
        "refine_graph_check": refine_graph,
        "overlap_off_graphs_captured": {"wall_s": rep_off_steady["wall_time_s"],
                                        "draft_s": rep_off_steady["draft_time_s"],
                                        "flow_s": rep_off_steady["flow_time_s"]},
        "eager_refine": {"wall_s_overlap_on": rep_eager_on["wall_time_s"],
                         "flow_s_overlap_on": rep_eager_on["flow_time_s"],
                         "wall_s_overlap_off": rep_eager_off["wall_time_s"],
                         "flow_s_overlap_off": rep_eager_off["flow_time_s"]},
    }
    counts_path = {"ws_step_rows": counts.get("ws_step_rows", 0),
                   "ws_fused": fused_counts.get("ws_fused", 0) + server_counts.get("ws_fused", 0)}
    return report, counts_path


# -- the generation pipeline -----------------------------------------------------------

# the paper's §4.2 Text-8 draft: a 2-layer, 512-hidden LSTM; and a small one
LSTM_CFG = dict(vocab_size=VOCAB, hidden=512, num_layers=2, embed_dim=256)
LSTM_SEED = 2
SMALL_LSTM = dict(vocab_size=VOCAB, hidden=32, num_layers=2, embed_dim=16)


def to_device(tree, device):
    """An LSTM parameter tree (dicts and lists of tensors) on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def check_lstm_draft():
    """At smoke size: ``LSTMModel.generate`` on the card equals the CPU's on
    the same weights and key, and ``ARDraftEngine`` with
    ``LSTMDraftAdapter`` equals the cache-free oracle on the card (computed,
    then reused prefix)."""
    from repro_torch import prng
    from repro_torch.drafting import ARDraftEngine, LSTMDraftAdapter, oracle_generate_rows
    from repro_torch.models import LSTMConfig, LSTMModel

    lstm = LSTMModel(LSTMConfig(**SMALL_LSTM))
    params = lstm.init(4, device="cuda")
    got = lstm.generate(params, prng.key(9), 4, 32).cpu()
    want = lstm.generate(to_device(params, "cpu"), prng.key(9), 4, 32)
    vs_cpu = int((got != want).sum())
    adapter = LSTMDraftAdapter(model=lstm, params=params)
    keys = prng.split(prng.key(3), 3)
    prompt = draft_prompt(3)[:, :3]
    eng = ARDraftEngine(adapter, max_len=3 + 12 - 1)
    out = [eng.generate_rows(keys, 12, prompt=prompt) for _ in range(2)]
    ref = oracle_generate_rows(adapter, keys, 12, prompt=prompt, max_len=14)
    vs_oracle = sum(int((o != ref).sum()) for o in out)
    print(f"LSTM draft (2 x 32, smoke size): generate 4 x 32 on the card vs the CPU: {vs_cpu} "
          f"tokens differ; engine with LSTMDraftAdapter vs oracle (3 rows, prompt 3, 12 "
          f"tokens, computed then reused prefix): {vs_oracle} tokens differ; stats "
          f"{eng.stats.as_dict()}")
    if vs_cpu or vs_oracle or eng.stats.prefill_reuses != 1:
        fail("the LSTM draft disagrees on the card")


def check_small_pipeline_against_cpu():
    """``WarmStartPipeline.generate`` on the card (default step: the
    ws_step_gumbel kernel) against the plain CPU path, on the same seeded
    backbone (smoke config), LSTM draft and key: 4 x 32 tokens, 4 steps.

    Both runs record each step's input tokens and logits. The trajectories
    must be equal; where a step's draws differ (first difference only: the
    runs part there), every differing token must lie in a row that the
    probability-space near-tie helper flags on that step's logits and noise."""
    from repro_torch import prng
    from repro_torch.configs.dfm_dit import smoke_config
    from repro_torch.core import ARDraft, WarmStartPath, WarmStartPipeline
    from repro_torch.core.sampler import refine_loop_inputs
    from repro_torch.kernels.ws_step import near_tie_rows_probs
    from repro_torch.models import LSTMConfig, LSTMModel, Model

    cold, seq, num = 16, 32, 4
    lstm = LSTMModel(LSTMConfig(**SMALL_LSTM))
    lparams = lstm.init(4, device="cpu")
    runs = {}
    for device in ("cuda", "cpu"):
        model = Model(smoke_config(), device="cpu", seed=3).to(device)
        seen = []

        def model_fn(x, t, model=model, seen=seen):
            lg = model.dfm_apply(x, t)
            seen.append((x.cpu(), t.cpu(), lg.cpu()))
            return lg

        pipe = WarmStartPipeline(
            model_fn=model_fn, draft=ARDraft(decode_fn=lstm.generate,
                                             params=to_device(lparams, device), seq_len=seq),
            path=WarmStartPath(t0=T0), cold_nfe=cold, vocab_size=VOCAB, seq_len=seq,
            device=device)
        # model_fn copies each step to the host, which no graph can hold: jit=False,
        # as the JAX package's own tests record a trajectory
        x, _ = with_jit_off(pipe).generate(prng.key(5), num)
        runs[device] = [s_[0] for s_ in seen] + [x.cpu()], seen
    (states_c, seen_c), (states_p, seen_p) = runs["cuda"], runs["cpu"]
    n = len(seen_p)
    keys, ts, hs = refine_loop_inputs(prng.split(prng.key(5), 2)[1], T0, 1.0 / cold, n)
    path = WarmStartPath(t0=T0)
    diff, ties, parted_at = 0, 0, None
    if not torch.equal(states_c[0], states_p[0]):
        fail("small pipeline: the LSTM drafts differ between the card and the CPU")
    for i in range(n):
        d = (states_c[i + 1] != states_p[i + 1]).reshape(-1)
        if not bool(d.any()):
            continue
        x_in, t_in = seen_p[i][0], seen_p[i][1]
        a = torch.clamp(hs[i] * path.velocity_scale(t_in), 0.0, 1.0)
        a = a.reshape(-1, 1).expand(num, seq).reshape(-1, 1)
        g = prng.gumbel(keys[i], (num, seq, VOCAB)).reshape(-1, VOCAB)
        tie = torch.zeros_like(d)
        for lg in (seen_p[i][2], seen_c[i][2]):
            tie |= near_tie_rows_probs(lg.reshape(-1, VOCAB), x_in.reshape(-1, 1), a, g,
                                       valid_v=VOCAB, tol=WS_TIE_TOL)
        if bool((d & ~tie).any()):
            fail(f"small pipeline: step {i} draws {int((d & ~tie).sum())} tokens differently "
                 f"from the CPU off the near ties")
        diff, ties, parted_at = int(d.sum()), int((d & tie).sum()), i
        break
    print(f"small pipeline (smoke config + LSTM 2 x 32 draft, 4 x 32 tokens, {n} steps): card "
          f"vs CPU plain path: {diff} tokens differ"
          + (f", all in near-tie rows, at step {parted_at} (the runs part there)" if diff
             else ""))
    return {"tokens_differ": diff, "near_tie_tokens": ties, "parted_at_step": parted_at}


def check_lstm_graph(lstm, lparams):
    """The §4.2 LSTM draft at 32 x 256 (255 + 1 tokens a row): one graph
    replay a call against its eager launches, bit for bit over 5 keys, each
    timed on the host clock to the card's end; the capture's ms; one replay
    profiled (device time, busy share)."""
    from repro_torch import prng

    outs, times = {}, {}
    for name, fn in (("graph", lstm.generate), ("eager", lstm._generate_eager)):
        for i in range(5):
            t = time.perf_counter()
            x = fn(lparams, prng.key(950 + i), NUM, SEQ)
            torch.cuda.synchronize()
            times.setdefault(name, []).append((time.perf_counter() - t) * 1e3)
            outs.setdefault(name, []).append(x)
    differ = sum(int((a != b).sum()) for a, b in zip(outs["graph"], outs["eager"]))
    st = lstm.graphs.stats()
    profile = _profile(lambda: (lstm.generate(lparams, prng.key(960), NUM, SEQ),
                                torch.cuda.synchronize()), "LSTM draft (graph)")
    res = {"graph_ms": times["graph"], "eager_ms": times["eager"],
           "graph_ms_median": statistics.median(times["graph"]),
           "eager_ms_median": statistics.median(times["eager"]), "tokens_differ": differ,
           "graphs": st, "profile": profile}
    print(f"LSTM draft 32 x 256: graph replay {res['graph_ms_median']:.2f} ms (median of 5; "
          f"{[round(v, 2) for v in times['graph']]}), eager {res['eager_ms_median']:.1f} ms "
          f"({[round(v, 1) for v in times['eager']]}); tokens differing {differ}; captures "
          f"{st['captures']}, replays {st['replays']}, capture ms {json.dumps(st['capture_ms'])}")
    if differ or st["captures"] != 1:
        fail(f"the LSTM draft's graph disagrees with its eager launches: {res}")
    return res


def with_jit_off(pipe):
    """The same pipeline with its sampler's loop as eager launches
    (``EulerSampler(jit=False)``)."""
    other = dataclasses.replace(pipe)
    other._sampler = dataclasses.replace(pipe.sampler(), jit=False)
    return other


def check_pipeline_graphs(pipe, warm, cold_pipe, x_cold, fused, x0, x_fused, model_fn,
                          draft_s):
    """The pipeline's refine graphs against ``jit=False`` at full width, bit
    for bit: warm generates 2 and 3 (replays), the first cold generate (64
    NFE) and ``EulerSampler(fused_block=2)`` call, each key captured once
    over its calls; and the eager generates' times beside the graphed ones."""
    from repro_torch import prng

    res = {"captures": {"warm": pipe.sampler().graphs.stats(),
                        "cold": cold_pipe.sampler().graphs.stats(),
                        "fused": fused.graphs.stats()}}
    eager, eager_warm = with_jit_off(pipe), []
    for i in (1, 2):
        t0 = time.perf_counter()
        x, _ = eager.generate(prng.key(500 + i), NUM)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eager_warm.append({"differ": int((x != warm[i]["x"]).sum()), "wall_ms": wall * 1e3,
                           "draft_ms": draft_s[-1] * 1e3, "flow_ms": (wall - draft_s[-1]) * 1e3})
    t0 = time.perf_counter()
    x, _ = with_jit_off(cold_pipe).generate(prng.key(600), NUM)
    torch.cuda.synchronize()
    res["eager_cold"] = {"differ": int((x != x_cold).sum()),
                         "flow_ms": (time.perf_counter() - t0) * 1e3}
    x, _ = dataclasses.replace(fused, jit=False).sample(prng.key(701), model_fn, x0)
    res["eager_fused_differ"] = int((x != x_fused).sum())
    res["eager_warm"] = eager_warm
    # the warm flow alone (13 NFE on an LSTM draft), one replay and its eager launches
    for name, smp in (("flow_profile", pipe.sampler()),
                      ("flow_profile_eager", dataclasses.replace(pipe.sampler(), jit=False))):
        res[name] = _profile(lambda smp=smp: (smp.sample(prng.key(900), model_fn, x0),
                                              torch.cuda.synchronize()),
                             "warm flow" + (" (eager launches)" if name.endswith("eager")
                                            else " (graph)"))
    caps = {k: v["captures"] for k, v in res["captures"].items()}
    reps = {k: v["replays"] for k, v in res["captures"].items()}
    print(f"pipeline graphs: captures {caps}, replays {reps}, capture ms (warm-up and capture) "
          + json.dumps({k: v["capture_ms"] for k, v in res["captures"].items()})
          + f"; vs jit=False, tokens differing (bitwise): warm "
          f"{[w['differ'] for w in eager_warm]}, cold {res['eager_cold']['differ']}, "
          f"fused_block=2 {res['eager_fused_differ']}; eager generates: flow "
          f"{[round(w['flow_ms'], 1) for w in eager_warm]} ms (graphed "
          f"{[round(w['flow_ms'], 1) for w in warm[1:]]}), cold flow "
          f"{res['eager_cold']['flow_ms']:.1f} ms")
    if caps != {"warm": 1, "cold": 1, "fused": 1} or reps != {"warm": 3, "cold": 2, "fused": 2} \
            or res["eager_cold"]["differ"] \
            or res["eager_fused_differ"] or any(w["differ"] for w in eager_warm):
        fail(f"the pipeline's graphs disagree with jit=False or were captured more than "
             f"once: {res}")
    return res


def pipeline_path(model):
    """The paper's generation API at full width: ``WarmStartPipeline`` over
    the dfm_dit backbone, drafted by the §4.2 Text-8 LSTM through
    ``ARDraft(decode_fn=LSTMModel.generate)``, 32 x 256 at t0 = 0.8 and
    cold_nfe = 64 (13 NFE, default Euler step), then the cold pipeline (no
    draft, t0 = 0, 64 NFE) and ``EulerSampler(fused_block=2)``; exact
    launch counts per run, and the draft cost measured against one NFE."""
    from repro_torch import prng
    from repro_torch.core import ARDraft, EulerSampler, WarmStartPath, WarmStartPipeline, warm_nfe
    from repro_torch.kernels import launches
    from repro_torch.models import LSTMConfig, LSTMModel
    from repro_torch.serving import make_refine_step_fn

    layers = model.cfg.num_layers
    lstm = LSTMModel(LSTMConfig(**LSTM_CFG))
    lparams = lstm.init(LSTM_SEED, device="cuda")
    n_lstm = sum(p.numel() for p in [lparams["embed"]["table"], lparams["head"]["w"]]
                 + [lp[k]["w"] for lp in lparams["layers"] for k in ("wx", "wh")])
    draft_s, evals = [], []

    def decode_fn(params, rng, num, seq_len):
        """LSTMModel.generate, its time taken up to the card's end."""
        t = time.perf_counter()
        out = lstm.generate(params, rng, num, seq_len)
        torch.cuda.synchronize()
        draft_s.append(time.perf_counter() - t)
        return out

    def model_fn(x, t):
        evals.append(1)
        return model.dfm_apply(x, t)

    path = WarmStartPath(t0=T0)
    draft = ARDraft(decode_fn=decode_fn, params=lparams, seq_len=SEQ)
    pipe = WarmStartPipeline(model_fn=model_fn, draft=draft, path=path, cold_nfe=COLD_NFE,
                             vocab_size=VOCAB, seq_len=SEQ, device="cuda")
    nfe = warm_nfe(COLD_NFE, T0)
    smp = pipe.sampler()
    if not (smp.nfe == smp.backbone_evals == nfe == 13):
        fail(f"pipeline sampler: nfe {smp.nfe}, backbone_evals {smp.backbone_evals}")

    # the measured draft cost: one LSTM batch against one NFE at 32 x 256
    refine = make_refine_step_fn(model, model.cfg, path)
    x_cal = torch.randint(0, VOCAB, (NUM, SEQ), generator=torch.Generator().manual_seed(6),
                          dtype=torch.int32).to("cuda")
    t_cal = torch.full((NUM,), T0, device="cuda")

    def nfe_fn():
        with torch.no_grad():
            return refine(prng.key(400), x_cal, t_cal, 1.0 / COLD_NFE)

    cal = draft.calibrate_cost_ratio(nfe_fn, rng=prng.key(401), num=NUM, seq_len=SEQ)
    lstm_graph = check_lstm_graph(lstm, lparams)

    def counted(what, fn, want, want_evals, smp):
        """Run ``fn``, one call of ``smp``'s refine graph, and gate its launches:
        ``want`` a replay (what was captured), twice that when the call
        captures (the warm-up's eager launches too). model_fn's calls are
        Python's: 2 x ``want_evals`` when the call captures (the warm-up run
        and the capture), none on a replay; exactly one replay a call."""
        before, n0 = dict(launches), len(evals)
        c0, r0 = smp.graphs.captures, smp.graphs.replays
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        grew = grown(before)
        runs = 1 + smp.graphs.captures - c0
        traced = 2 * want_evals * (smp.graphs.captures - c0)
        if grew != {k: runs * c for k, c in want.items()} or len(evals) - n0 != traced \
                or smp.graphs.replays != r0 + 1:
            fail(f"{what}: launches {grew}, {len(evals) - n0} model_fn calls, "
                 f"{smp.graphs.replays - r0} replays; expected {runs} x {want}, {traced} "
                 f"({want_evals} backbone evaluations a run), 1")
        return out, wall

    per_warm = {"ws_step_gumbel": nfe, "flash_attn": nfe * layers}
    launches.clear()
    warm = []
    for i in range(3):
        n_draft = len(draft_s)
        (x, rep), wall = counted(f"warm generate {i}",
                                 lambda i=i: pipe.generate(prng.key(500 + i), NUM), per_warm,
                                 nfe, smp)
        if (rep.warm_nfe, rep.cold_nfe) != (nfe, COLD_NFE) or len(draft_s) != n_draft + 1:
            fail(f"warm generate {i}: report {rep}")
        if x.shape != (NUM, SEQ) or x.dtype != torch.int32 or x.device.type != "cuda" \
                or int(x.min()) < 0 or int(x.max()) >= VOCAB:
            fail(f"warm generate {i}: tokens {tuple(x.shape)} {x.dtype} on {x.device}")
        warm.append({"wall_ms": wall * 1e3, "draft_ms": draft_s[-1] * 1e3,
                     "flow_ms": (wall - draft_s[-1]) * 1e3, "report": rep, "x": x})
    cold_pipe = WarmStartPipeline(model_fn=model_fn, draft=None, path=WarmStartPath(t0=0.0),
                                  cold_nfe=COLD_NFE, vocab_size=VOCAB, seq_len=SEQ,
                                  device="cuda")
    # the cold pipeline and the fused sampler twice each: the first call
    # captures, the second replays (its time is the steady one)
    cold_walls, fused_walls = [], []
    for i in range(2):
        (x, rep_cold), wall = counted(
            f"cold generate {i}", lambda i=i: cold_pipe.generate(prng.key(600 + i), NUM),
            {"ws_step_gumbel": COLD_NFE, "flash_attn": COLD_NFE * layers}, COLD_NFE,
            cold_pipe.sampler())
        if rep_cold.warm_nfe != COLD_NFE or rep_cold.nfe_speedup != 1.0 \
                or x.shape != (NUM, SEQ):
            fail(f"cold generate {i}: report {rep_cold}")
        x_cold = x_cold if i else x
        cold_walls.append(wall)
    fused = EulerSampler(path=path, num_steps=COLD_NFE, fused_block=2)
    x0 = lstm.generate(lparams, prng.key(700), NUM, SEQ)
    for i in range(2):
        (x, st_fused), wall = counted(
            f"EulerSampler(fused_block=2) {i}",
            lambda i=i: fused.sample(prng.key(701 + i), model_fn, x0),
            {"ws_fused": 7, "flash_attn": 7 * layers}, 7, fused)
        x_fused = x_fused if i else x
        fused_walls.append(wall)
    cold_wall, fused_wall = cold_walls[1], fused_walls[1]
    if (fused.nfe, fused.backbone_evals, st_fused.nfe) != (nfe, 7, 7):
        fail(f"EulerSampler(fused_block=2): nfe {fused.nfe}, evals {fused.backbone_evals}")
    counts = dict(launches)
    graphs = check_pipeline_graphs(pipe, warm, cold_pipe, x_cold, fused, x0, x_fused, model_fn,
                                   draft_s)
    profile = _profile(lambda: (pipe.generate(prng.key(800), NUM), torch.cuda.synchronize()),
                       "pipeline generate")

    def med(key):
        return statistics.median(w[key] for w in warm[1:])

    flow_ms = med("flow_ms")
    rep = warm[-1]["report"]
    res = {
        "config": model.cfg.name, "draft": {"model": "LSTM (paper §4.2 Text-8)", **LSTM_CFG,
                                            "seed": LSTM_SEED, "params": n_lstm},
        "num": NUM, "seq_len": SEQ, "t0": T0, "cold_nfe": COLD_NFE, "nfe": nfe,
        "backbone_evals": smp.backbone_evals,
        "warmup_generate_ms": warm[0]["wall_ms"],
        "generate_ms": med("wall_ms"), "draft_ms": med("draft_ms"), "flow_ms": flow_ms,
        "per_nfe_ms": flow_ms / nfe, "samples_per_s": NUM / (med("wall_ms") / 1e3),
        "generate_ms_each": [w["wall_ms"] for w in warm[1:]],
        "flow_ms_each": [w["flow_ms"] for w in warm[1:]],
        "draft_ms_each": [w["draft_ms"] for w in warm[1:]],
        "measured_cost": cal.as_dict(),
        "draft_cost_ratio": rep.draft_cost_ratio,
        "guaranteed_speedup": rep.guaranteed_factor, "nfe_speedup": rep.nfe_speedup,
        "effective_speedup": rep.effective_speedup,
        "cold": {"nfe": rep_cold.warm_nfe, "flow_ms": cold_wall * 1e3,
                 "capture_call_ms": cold_walls[0] * 1e3,
                 "per_nfe_ms": cold_wall * 1e3 / COLD_NFE},
        "fused_block_2": {"flow_ms": fused_wall * 1e3, "backbone_evals": st_fused.nfe,
                          "capture_call_ms": fused_walls[0] * 1e3},
        "launches_per_warm_generate": per_warm, "launches_path": counts,
        "graphs": graphs, "lstm_graph": lstm_graph,
        "profile": profile,
        # every kernel the profiled generate launched (the draft's too), per NFE
        "profile_launches_per_nfe": (profile["kernel_launches"] / nfe
                                     if profile.get("device_ms") is not None else None),
    }
    print(f"pipeline: {model.cfg.name} drafted by the LSTM ({n_lstm / 1e6:.2f}M params), "
          f"{NUM} x {SEQ}, t0={T0}, cold_nfe={COLD_NFE}: {nfe} NFE per warm generate, guarantee "
          f"gate passed, launches per warm generate {per_warm}; draft {res['draft_ms']:.1f} ms, "
          f"flow {flow_ms:.1f} ms ({res['per_nfe_ms']:.2f} ms per NFE), draft_cost_ratio "
          f"{rep.draft_cost_ratio:.3f} (best of 5: draft {cal.draft_time_s * 1e3:.2f} ms, one "
          f"NFE {cal.nfe_time_s * 1e3:.2f} ms), effective speed-up "
          f"{rep.effective_speedup:.2f}x of {rep.guaranteed_factor:.2f}x; cold (64 NFE) "
          f"{cold_wall * 1e3:.1f} ms; fused_block=2 {fused_wall * 1e3:.1f} ms (7 evaluations); "
          f"the profiled generate's kernel launches per NFE: {res['profile_launches_per_nfe']}")
    return res, counts


# -- CUDA graphs of the loops ----------------------------------------------------

def check_device_keys(r, v, seed):
    """ws_step and the keyed ws_step_gumbel with the step key's words read
    from the card (the entry points the refine graphs take) against the
    launches with the words passed as integers, at every lanes a row and
    the kernels' choice: the tokens must be equal, bitwise."""
    from repro_torch import prng
    from repro_torch.kernels.ws_step import key_words, ops

    logits, x, a, seed_w, _, _ = lanes_inputs(r, v, seed)
    dkey = key_words(prng.key(seed).to("cuda"))
    differ = {}
    for lanes in (0,) + WS_LANES:
        out = [torch.empty(r, dtype=torch.int32, device="cuda") for _ in range(4)]
        ops._launch(logits, x, a, out[0], seed_w, 1.0, lanes=lanes)
        ops._launch(logits, x, a, out[1], dkey, 1.0, lanes=lanes)
        ops._launch_gumbel_keyed(logits, x, a, seed_w, out[2], v, 1.0, lanes=lanes)
        ops._launch_gumbel_keyed(logits, x, a, dkey, out[3], v, 1.0, lanes=lanes)
        differ[lanes] = int((out[0] != out[1]).sum()) + int((out[2] != out[3]).sum())
    torch.cuda.synchronize()
    print(f"device key vs host key at ({r}, {v}): tokens differing (ws_step and keyed "
          f"ws_step_gumbel, bitwise), by lanes a row (0 = the kernels' choice): {differ}")
    if any(differ.values()):
        fail(f"a step key read on the card draws differently from the host's words: {differ}")
    return {"rows": r, "vocab": v, "differ": sum(differ.values())}


def grown(before: dict) -> dict:
    """The launches counted since ``before`` (a copy of ``launches``)."""
    from repro_torch.kernels import launches

    return {k: c - before.get(k, 0) for k, c in launches.items() if c != before.get(k, 0)}


def serve_eager(server, engine, rng, prompt, num=NUM):
    """``server.serve(rng, num)``'s draft and refine as eager launches (the
    graphs' yardstick), timed as ``serve`` times them: (tokens, draft s,
    flow s)."""
    from repro_torch import prng
    from repro_torch.core.sampler import refine_loop_inputs

    k_draft, k_flow = prng.split(rng, 2)
    t0 = time.perf_counter()
    x = engine._generate_rows_eager(prng.split(k_draft, num), SEQ, prompt)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    keys, ts, hs = refine_loop_inputs(k_flow, T0, 1.0 / COLD_NFE, 13)
    with torch.inference_mode():
        x = server._refine_loop_eager(keys, x, ts, hs)
    torch.cuda.synchronize()
    return x, t1 - t0, time.perf_counter() - t1


def check_serve_graphs(server, engine, prompt, prefill):
    """Full width, after the serves that captured: two more serves (new
    keys: replays) against the same serves as eager launches, tokens
    bitwise; then the decode alone, graph against eager at 32 rows x 255
    steps with the prefix reused, recomputed into the same buffers and
    recomputed back, tokens bitwise and the replay's launches equal to the
    eager decode's; no capture in any of it."""
    from repro_torch import prng
    from repro_torch.kernels import launches

    caps = (engine.graphs.captures, server.graphs.captures)
    kv = engine._caches[NUM]["blocks"]["p0"]["k"].data_ptr()
    res = {"serve": [], "decode": []}
    for rng in (prng.key(110), prng.key(111)):
        x, rep = server.serve(rng, NUM)
        want, t_draft, t_flow = serve_eager(server, engine, rng, prompt)
        res["serve"].append({
            "differ": int((x != want).sum()),
            "graph_draft_ms": rep["draft_time_s"] * 1e3,
            "graph_flow_ms": rep["flow_time_s"] * 1e3,
            "eager_draft_ms": t_draft * 1e3, "eager_flow_ms": t_flow * 1e3})
    other = torch.roll(prompt, 1, dims=1)
    for i, (what, p) in enumerate((("reused", prompt), ("recomputed", other),
                                   ("recomputed back", prompt))):
        keys = prng.split(prng.key(120 + i), NUM)
        computes = engine.stats.prefill_computes
        before = dict(launches)
        got = engine.generate_rows(keys, SEQ, p)
        torch.cuda.synchronize()
        n_got = grown(before)
        if engine.stats.prefill_computes != computes:
            n_got = {k: c - prefill.get(k, 0) for k, c in n_got.items()}
        before = dict(launches)
        want = engine._generate_rows_eager(keys, SEQ, p)
        torch.cuda.synchronize()
        n_want = grown(before)
        res["decode"].append({"prefix": what, "differ": int((got != want).sum()),
                              "launches_equal": n_got == n_want})
    same_buffers = engine._caches[NUM]["blocks"]["p0"]["k"].data_ptr() == kv
    decode = [(r["prefix"], r["differ"], r["launches_equal"]) for r in res["decode"]]
    print(f"graphs at full width: serve (graph) vs serve (eager launches), 2 keys: "
          f"{[r['differ'] for r in res['serve']]} tokens differ (bitwise); draft "
          f"{[round(r['graph_draft_ms'], 1) for r in res['serve']]} ms graphed vs "
          f"{[round(r['eager_draft_ms'], 1) for r in res['serve']]} eager, flow "
          f"{[round(r['graph_flow_ms'], 1) for r in res['serve']]} vs "
          f"{[round(r['eager_flow_ms'], 1) for r in res['serve']]}; decode graph vs eager "
          f"({NUM} x {SEQ - 1} steps; prefix, tokens differing, launches equal): {decode}"
          f"; KV buffers kept: {same_buffers}; captures (engine, server) {caps} -> "
          f"{(engine.graphs.captures, server.graphs.captures)}")
    if any(r["differ"] for r in res["serve"] + res["decode"]) \
            or not all(r["launches_equal"] for r in res["decode"]) or not same_buffers \
            or (engine.graphs.captures, server.graphs.captures) != caps:
        fail(f"the serve's graphs disagree with their eager launches: {res}")
    return res


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
    the plain CPU path on the same weights (a copy of the model moved to the
    host: no second random init), within 1e-3 x max(1, max |logit|)."""
    import copy

    ref_model = copy.deepcopy(model).to("cpu")
    with torch.inference_mode():
        got = model.dfm_apply(tokens, t).cpu()
        want = ref_model.dfm_apply(tokens.cpu(), t.cpu())
    del ref_model
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    print(f"full-width dfm_apply ({model.cfg.name}), {tokens.shape[0]} x {tokens.shape[1]} "
          f"tokens, card kernels vs CPU plain: max abs err {err:.3e} (logits up to "
          f"{scale:.2f}; limit 1e-3 relative)")
    if not math.isfinite(err) or err > 1e-3 * max(1.0, scale):
        fail(f"full-width logits of {model.cfg.name} disagree with the plain path: {err}")
    return {"config": model.cfg.name, "tokens": list(tokens.shape), "max_abs_err": err,
            "max_abs_logit": scale}


def main_path(engine):
    from repro_torch import prng
    from repro_torch.configs.dfm_dit import CONFIG
    from repro_torch.core.guarantees import warm_nfe
    from repro_torch.core.paths import WarmStartPath
    from repro_torch.kernels import launches
    from repro_torch.kernels.ws_step import make_ws_step_fn
    from repro_torch.models import Model
    from repro_torch.serving import WarmStartServer

    model = Model(CONFIG, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    path = WarmStartPath(t0=T0)
    prompt = draft_prompt(NUM)
    server = WarmStartServer(
        flow_model=model, flow_cfg=CONFIG,
        draft_generate=lambda rng, num: engine.generate_rows(prng.split(rng, num), SEQ, prompt),
        path=path, cold_nfe=COLD_NFE, step_fn=make_ws_step_fn(path), device="cuda")
    nfe_want = warm_nfe(COLD_NFE, T0)
    if nfe_want != 13:
        fail(f"warm_nfe({COLD_NFE}, {T0}) = {nfe_want}, expected 13")
    steps = (SEQ - 1) * CONFIG.num_layers           # 255 decode steps x 12 layers
    per_serve = {"ws_step": nfe_want, "flash_attn": nfe_want * CONFIG.num_layers,
                 "qkv_rope": steps, "attn_cached": steps, "post_attn": steps, "head": SEQ - 1}
    prefill = {"qkv_rope": CONFIG.num_layers, "attn_cached": CONFIG.num_layers,
               "post_attn": CONFIG.num_layers, "head": 1}

    launches.clear()
    reports, last = [], None
    for i in range(3):
        before = dict(launches)
        x, rep = server.serve(prng.key(100 + i), NUM)
        for name, n in per_serve.items():
            # the first serve captures the decode and the refine: each capture's
            # warm-up runs its loop once more, eagerly, before the replay
            want = n * 2 + prefill.get(name, 0) if i == 0 else n
            grew = launches[name] - before.get(name, 0)
            if grew != want:
                fail(f"serve {i}: {name} launched {grew} times, expected {want}")
        if not (rep["nfe"] == rep["backbone_evals"] == nfe_want):
            fail(f"serve {i}: nfe {rep['nfe']} backbone_evals {rep['backbone_evals']}")
        if x.shape != (NUM, SEQ) or x.dtype != torch.int32 or x.device.type != "cuda":
            fail(f"serve {i}: tokens {tuple(x.shape)} {x.dtype} on {x.device}")
        if int(x.min()) < 0 or int(x.max()) >= VOCAB:
            fail(f"serve {i}: tokens outside [0, {VOCAB})")
        reports.append(rep)
        last = x
    counts = dict(launches)
    stats = engine.stats.as_dict()
    print(f"main path: dfm_dit CONFIG ({n_params / 1e6:.1f}M params) x 3 serves of "
          f"{NUM} x {SEQ} drafted by the AR engine (prompt {PROMPT}, max_len {MAX_LEN}), "
          f"t0={T0}, cold_nfe={COLD_NFE}: nfe 13 per serve, guarantee gate passed, launches "
          f"{counts} (per serve {per_serve}; the first serve twice that, its capture "
          f"warm-ups, and {prefill}); draft stats {stats}")
    if (stats["prefill_computes"], stats["prefill_reuses"]) != (1, 2):
        fail(f"the draft engine's prefix pool: {stats}, expected 1 compute and 2 reuses")
    graph_counts = {"engine": (engine.graphs.captures, engine.graphs.replays),
                    "server": (server.graphs.captures, server.graphs.replays)}
    print(f"main path graphs (captures, replays) over the 3 serves: {graph_counts}; capture ms "
          f"(warm-up and capture): decode {engine.graphs.stats()['capture_ms']}, refine "
          f"{server.graphs.stats()['capture_ms']}")
    if graph_counts != {"engine": (1, 3), "server": (1, 3)}:
        fail(f"the 3 serves must capture the decode and the refine once each: {graph_counts}")

    check_full_width_logits(model, last[:1], torch.full((1,), T0, device="cuda"))
    graphs = check_serve_graphs(server, engine, prompt, prefill)
    profile = profile_serve(server, prng.key(200))
    draft_profile = profile_draft(engine, prng.key(201), prompt)
    draft_profile_eager = profile_draft(engine, prng.key(201), prompt, eager=True)
    steady = reports[1:]
    serve = {
        "config": CONFIG.name, "num": NUM, "seq_len": SEQ, "t0": T0, "cold_nfe": COLD_NFE,
        "nfe": nfe_want, "params": n_params,
        "draft": {"config": CONFIG.name + " (causal decoder)", "seed": DRAFT_SEED,
                  "prompt": PROMPT, "max_len": MAX_LEN, "decode_steps": SEQ - 1,
                  "stats": stats},
        "warmup_draft_ms": reports[0]["draft_time_s"] * 1e3,
        "warmup_flow_ms": reports[0]["flow_time_s"] * 1e3,
        "draft_ms": statistics.median(r["draft_time_s"] for r in steady) * 1e3,
        "flow_ms": statistics.median(r["flow_time_s"] for r in steady) * 1e3,
        "per_nfe_ms": statistics.median(r["per_nfe_s"] for r in steady) * 1e3,
        "samples_per_s": statistics.median(
            NUM / (r["draft_time_s"] + r["flow_time_s"]) for r in steady),
        "speedup_report": {"draft_cost_ratio": statistics.median(
            r["speedup_report"].draft_cost_ratio for r in steady),
            "effective_speedup": statistics.median(
                r["speedup_report"].effective_speedup for r in steady),
            "nfe_speedup": steady[0]["speedup_report"].nfe_speedup},
        "draft_ms_each": [r["draft_time_s"] * 1e3 for r in steady],
        "flow_ms_each": [r["flow_time_s"] * 1e3 for r in steady],
        "profile": profile,
        "draft_profile": draft_profile,
        "draft_profile_eager": draft_profile_eager,
        "graphs": {"engine": engine.graphs.stats(), "server": server.graphs.stats(),
                   "vs_eager": graphs},
    }
    return counts, per_serve, serve, model


# -- training ------------------------------------------------------------------

TRAIN_STEPS = 30
TRAIN_GATE_STEPS = 3   # graphed against eager steps from one init
GRAD_TOL = 1e-3      # x max |g| of the parameter: kernel path vs autograd through the plain
MOONS_GRID, MOONS_STEPS, MOONS_COLD_NFE = 128, 300, 20


def train_argv(ckpt_dir: str, steps: int = TRAIN_STEPS):
    """``launch/train.py``'s flags for the DiT at full width, as a user calls it."""
    return ["--arch", "dfm-dit", "--t0", str(T0), "--batch-size", str(NUM),
            "--seq-len", str(SEQ), "--steps", str(steps), "--checkpoint-dir", ckpt_dir,
            "--device", "cuda"]


def train_batch(cfg):
    """The first batch of ``launch/train``'s pairs (32 x 256), on the card,
    and the trainer's first step key."""
    from repro_torch import prng
    from repro_torch.core.coupling import pair_iterator
    from repro_torch.launch import train as launch_train

    args = launch_train.parse_args(train_argv("unused"))
    src, tgt, rng = launch_train.training_pairs(cfg, args)
    x_src, x_tgt = next(pair_iterator(src, tgt, NUM, rng))
    batch = {"x_src": torch.from_numpy(x_src).cuda(), "x_tgt": torch.from_numpy(x_tgt).cuda()}
    return batch, prng.split(prng.key(args.seed + 1), 2)[1]


def check_train_gradients(cfg, batch, key):
    """Gradient gate: one backward of the WS-DFM loss of the model as the
    trainer runs it (attention through ``FlashAttentionFn``: the kernel
    forward, the matmul gradient) against the same loss differentiated by
    autograd through ``flash_attention_ref``, on the card. Every parameter's
    gradient within GRAD_TOL x its max |g|, finite and not all zero."""
    import repro_torch.models.attention as attention
    from repro_torch.convert import jax_leaves
    from repro_torch.core.paths import WarmStartPath
    from repro_torch.kernels import launches
    from repro_torch.kernels.flash_attn import flash_attention_ref
    from repro_torch.models import build_model
    from repro_torch.training.train_step import loss_and_grads, make_loss_fn

    model = build_model(cfg, device="cuda", seed=0)
    leaves = jax_leaves(model)
    names = {id(p): n for n, p in model.named_parameters()}
    loss_fn = make_loss_fn(model, cfg, WarmStartPath(T0))
    launches.clear()
    loss, _, grads = loss_and_grads(loss_fn, model, leaves, batch, key)
    loss = loss.detach()
    torch.cuda.synchronize()
    n_kernel = launches["flash_attn"]
    if dict(launches) != {"flash_attn": cfg.num_layers}:
        fail(f"gradient gate: one forward and backward launched {dict(launches)}, expected "
             f"flash_attn x {cfg.num_layers} (the backward launches none)")
    kernel_path = attention.flash_attention
    attention.flash_attention = flash_attention_ref
    try:
        loss_ref, _, grads_ref = loss_and_grads(loss_fn, model, leaves, batch, key)
        loss_ref = loss_ref.detach()
    finally:
        attention.flash_attention = kernel_path
    torch.cuda.synchronize()
    if launches["flash_attn"] != n_kernel:
        fail("gradient gate: the plain path launched the kernel")
    worst, worst_name, checked = 0.0, None, 0
    for leaf, ps in leaves.items():
        for p, g, r in zip(ps, grads[leaf], grads_ref[leaf]):
            name = names[id(p)]
            scale = float(r.abs().max())
            if not bool(torch.isfinite(g).all()) or float(g.abs().max()) == 0.0 or scale == 0.0:
                fail(f"gradient gate: {name} has no usable gradient (max |g| "
                     f"{float(g.abs().max())}, plain {scale})")
            err = float((g - r).abs().max()) / scale
            if err > worst:
                worst, worst_name = err, name
            checked += 1
    if checked != sum(1 for _ in model.parameters()):
        fail(f"gradient gate: checked {checked} parameters")
    print(f"gradient gate: {checked} parameters, loss {float(loss):.6f} (plain "
          f"{float(loss_ref):.6f}); worst |g - g_plain| / max|g_plain| {worst:.3e} "
          f"({worst_name}), tolerance {GRAD_TOL:g}; flash_attn {n_kernel} launches")
    if worst > GRAD_TOL:
        fail(f"gradient gate: {worst_name} off by {worst:.3e} of its max |g|")
    return {"params": checked, "loss": float(loss), "loss_plain": float(loss_ref),
            "max_rel_err": worst, "worst_param": worst_name, "tolerance": GRAD_TOL,
            "flash_attn_launches": n_kernel}


def train_leaves(state) -> dict:
    """Copies of every weight and optimizer moment (AMSGrad's running max
    too) of a train state, by name."""
    out = {("param", n): p.detach().clone() for n, p in state.params.named_parameters()}
    for f in ("mu", "nu", "nu_max"):
        out.update({(f, k): v.clone() for k, v in (getattr(state.opt_state, f, None) or {}).items()})
    return out


def run_to_run(eager, eager2):
    """What two eager runs of the same steps give differently: (the steps
    whose metrics differ, the leaves that differ)."""
    (me, le), (me2, le2) = eager, eager2
    steps = [i for i in range(me.shape[0]) if not torch.equal(me[i], me2[i])]
    return steps, {k for k, x in le.items() if not torch.equal(x, le2[k])}


def check_graph_equals_eager(what, graph, eager, nondet, bound):
    """The graph == eager gate, as remat against no remat: ``graph`` and
    ``eager`` are (metrics (steps, 2): loss and grad norm, {leaf: tensor})
    of the same steps from one init, graphed and eager; ``nondet`` is
    :func:`run_to_run` of two eager runs. A leaf the two eager runs give bit
    for bit must come out of the graph bit for bit, any other within
    ``bound`` (2 x the summed learning rates: the smoke card == CPU gate's).
    The losses and grad norms are bitwise where the eager step is (no leaf
    and no metric varied between the two eager runs), else within
    SMOKE_LOSS_RTOL / SMOKE_GNORM_RTOL relative: a loss or a norm is one
    reduction's result, whose last bit two runs of a step that varies can
    round alike by chance."""
    (mg, lg), (me, le) = graph, eager
    steps, leaves = nondet
    varies = bool(steps or leaves)
    mg, me = mg.cpu(), me.cpu()
    for i in range(me.shape[0]):
        if not varies:
            if not torch.equal(mg[i], me[i]):
                fail(f"{what}: step {i + 1}'s (loss, grad norm) {mg[i].tolist()} graphed, "
                     f"{me[i].tolist()} eager (bitwise run to run)")
        else:
            rel = ((mg[i] - me[i]).abs() / me[i].abs()).tolist()
            if rel[0] > SMOKE_LOSS_RTOL or rel[-1] > SMOKE_GNORM_RTOL:
                fail(f"{what}: step {i + 1}'s (loss, grad norm) off by {rel} relative")
    if set(lg) != set(le):
        fail(f"{what}: the graphed run's leaves differ from the eager run's")
    worst, worst_leaf = 0.0, None
    for k, x in le.items():
        diff = float((lg[k].float() - x.float()).abs().max())
        if k not in leaves:
            if not torch.equal(lg[k], x):
                fail(f"{what}: {k} graphed differs from eager (bitwise run to run) by {diff:.3e}")
            continue
        if diff > worst:
            worst, worst_leaf = diff, k
        if diff > bound:
            fail(f"{what}: {k} graphed off by {diff:.3e} (bound {bound:.3e})")
    res = {"steps": me.shape[0], "leaves": len(le), "bitwise_leaves": len(le) - len(leaves),
           "nondeterministic_leaves": sorted(str(k) for k in leaves),
           "nondeterministic_steps": steps, "worst_nondet_diff": worst,
           "worst_nondet_leaf": str(worst_leaf), "bound": bound}
    print(f"{what}: graph == eager over {res['steps']} steps: {res['bitwise_leaves']} of "
          f"{res['leaves']} weights and moments bitwise, and the losses and grad norms"
          + ("" if not leaves and not steps else
             f"; varying run to run: {len(leaves)} leaves (worst {worst:.3e} of {bound:.3e}), "
             f"steps {steps}"))
    return res


def train_graph_gate(what, model, run, batches):
    """``len(batches)`` steps (batches on the card, keys 0, 1, ...) of copies
    of ``model`` from a fresh optimizer state: eager, eager again, then
    through ``jit_train_step``; :func:`check_graph_equals_eager` on weights,
    moments, losses and grad norms, one capture and a replay a later step,
    the graphed run's launches the eager run's. Returns the gate's record
    with each run's step ms (the graphed run's first step captures)."""
    import copy

    from repro_torch import prng
    from repro_torch.kernels import launches
    from repro_torch.optim import build_optimizer
    from repro_torch.training import TrainState, jit_train_step, make_train_step

    def one_run(jit):
        m = copy.deepcopy(model)
        opt = build_optimizer(run)
        step = make_train_step(m, m.cfg, run, opt)
        step = jit_train_step(step) if jit else step
        state = TrainState.create(m, opt)
        torch.cuda.synchronize()
        launches.clear()
        events, metrics = [], []
        for i, b in enumerate(batches):
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            state, mt = step(state, b, prng.key(i))
            metrics.append(torch.stack([mt["loss"], mt["grad_norm"]]))
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        events[-1].synchronize()
        rec = {"step_ms": [a.elapsed_time(b) for a, b in zip(events, events[1:])],
               "launches": dict(launches), "step": int(state.step),
               "optimizer_step": int(state.opt_state.step)}
        if jit:
            rec["graphs"] = step.graphs.stats()
        out = (torch.stack(metrics), train_leaves(state))
        del m, state, step
        gc_collect()
        return out, rec

    eager, rec_e = one_run(False)
    eager2, _ = one_run(False)
    nondet = run_to_run(eager, eager2)
    del eager2
    graph, rec_g = one_run(True)
    sched = build_optimizer(run).learning_rate
    bound = 2 * sum(sched(i) for i in range(1, len(batches) + 1))
    res = check_graph_equals_eager(what, graph, eager, nondet, bound)
    del graph, eager
    gc_collect()
    n = len(batches)
    if rec_g["graphs"]["captures"] != 1 or rec_g["graphs"]["replays"] != n - 1 \
            or rec_g["launches"] != rec_e["launches"] or rec_g["step"] != n \
            or rec_g["optimizer_step"] != n:
        fail(f"{what}: the graphed run {rec_g}, the eager run {rec_e}: expected one capture, "
             f"{n - 1} replays, the eager launches and {n} steps")
    res.update({"eager": rec_e, "graphed": rec_g})
    return res


def _train_category(name: str) -> str:
    if "flash_attn_kernel" in name:
        return "flash_attn"
    low = name.lower()
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "gemm"
    if "multi_tensor_apply" in name:
        return "foreach (optimizer)"
    return "other"


def _phase_profile(run, what):
    """Device ms of ``run`` by kind of kernel, and the attention backward's
    products (the kernels of ``aten::bmm``: the backbone's dense layers are
    ``aten::mm``), under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in avgs
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not kernels:
        print(f"profile of the {what}: the trace holds no device time (not measured)")
        return {"device_ms": None}
    by_kind = {}
    for name, ms, _ in kernels:
        by_kind[_train_category(name)] = by_kind.get(_train_category(name), 0.0) + ms
    bmm = sum(e.device_time_total / 1e3 for e in avgs
              if e.device_type == DeviceType.CPU and e.key == "aten::bmm")
    res = {"device_ms": sum(ms for _, ms, _ in kernels), "wall_ms": wall_ms,
           "kernel_launches": sum(c for _, _, c in kernels), "by_kind_ms": by_kind,
           "bmm_ms": bmm}
    print(f"profile of the {what}: device {res['device_ms']:.2f} ms of {wall_ms:.2f} ms wall, "
          f"{res['kernel_launches']} kernels; by kind "
          + json.dumps({k: round(v, 3) for k, v in by_kind.items()})
          + f"; aten::bmm {bmm:.3f} ms")
    return res


def profile_train_step(trainer, state, batch, key):
    """One more step, phase by phase under the profiler (forward: the loss;
    backward: ``torch.autograd.grad``; optimizer: clipping and the AdamW
    update), eager launches; then three whole steps for the device's busy
    share, eager (the un-jitted step) and graphed (the trainer's: three
    replays of the graph ``fit`` captured)."""
    from repro_torch.convert import jax_leaves
    from repro_torch.training.train_step import apply_gradients, grads_of, make_loss_fn

    model = state.params
    leaves = jax_leaves(model)
    loss_fn = make_loss_fn(model, model.cfg, trainer.path)
    held = {}

    def forward():
        held["loss"] = loss_fn(model, batch, key)[0]

    def backward():
        held["grads"] = grads_of(held["loss"], leaves)

    def optimizer():
        held["state"] = apply_gradients(state, leaves, held["grads"], trainer.optimizer,
                                        trainer.run.grad_clip)[0]

    phases = {"forward": _phase_profile(forward, "train step's forward"),
              "backward": _phase_profile(backward, "train step's backward"),
              "optimizer": _phase_profile(optimizer, "train step's optimizer")}
    bwd = phases["backward"]
    if bwd.get("device_ms") is not None:
        bwd["attn_backward_matmul_ms"] = bwd["bmm_ms"]
        bwd["backbone_gemm_ms"] = bwd["by_kind_ms"].get("gemm", 0.0) - bwd["bmm_ms"]
    st = held["state"]
    replays = trainer._step_fn.graphs.replays

    def three_steps(step_fn):
        def run():
            nonlocal st
            for _ in range(3):
                st, _ = step_fn(st, batch, key)
        return run

    phases["steps_busy"] = busy_share(three_steps(trainer._step_fn.step),
                                      "three train steps (eager)")
    phases["steps_busy_graphed"] = busy_share(three_steps(trainer._step_fn),
                                              "three train steps (graph replays)")
    if trainer._step_fn.graphs.replays != replays + 3:
        fail("the trainer's graphed steps did not replay the graph fit captured")
    return phases


def moons_experiment():
    """The paper's two-moons study (§4.1) in the structure of the JAX
    package's ``examples/quickstart.py``: a 4 x 128 DiT, vocab 128, trained
    300 steps cold (t0 = 0, noise sources) and warm (t0 = 0.8, KNN pairs of
    a pretty-good corruption draft), then ``WarmStartPipeline.generate`` of
    4000 samples each: SKL against held-out moons, NFE 20 cold and 4 warm."""
    import numpy as np
    from repro_torch import prng
    from repro_torch.configs.base import ModelConfig, RunConfig
    from repro_torch.core import CorruptionDraft, WarmStartPath, WarmStartPipeline
    from repro_torch.core.coupling import KNNRefinementCoupling, pair_iterator
    from repro_torch.data import moons_dataset, symmetric_kl
    from repro_torch.kernels import launches
    from repro_torch.models import build_model
    from repro_torch.training import Trainer

    cfg = ModelConfig(
        name="moons", family="dense", num_layers=4, d_model=128, num_heads=4,
        num_kv_heads=4, d_ff=512, vocab_size=MOONS_GRID, pattern=("attn",),
        norm="layernorm", mlp_gated=False, act="gelu", tie_embeddings=False,
        dtype="float32", max_seq_len=2)

    def train(src, tgt, t0, seed):
        run = RunConfig(total_steps=MOONS_STEPS, batch_size=256, learning_rate=1e-3,
                        warmup_steps=20, log_every=100, seed=seed)
        trainer = Trainer(build_model(cfg, device="cuda", seed=seed), cfg, run,
                          path=WarmStartPath(t0=t0))
        t = time.perf_counter()
        state = trainer.fit(trainer.init_state(),
                            pair_iterator(src, tgt, 256, np.random.default_rng(seed)))
        torch.cuda.synchronize()
        ce = [m["ce"] for _, m in trainer.history]
        if not all(math.isfinite(float(x)) for x in trainer.step_losses):
            fail(f"moons t0={t0}: a non-finite loss")
        return state.params, {"train_s": time.perf_counter() - t, "ce": ce,
                              "median_step_ms": statistics.median(trainer.step_ms()[1:])}

    data = moons_dataset(8192, seed=0)
    eval_ref = moons_dataset(4000, seed=42)
    rng = np.random.default_rng(0)
    out = {}
    launches.clear()
    src = rng.integers(0, MOONS_GRID, size=data.shape).astype(np.int32)
    model, out["cold_train"] = train(src, data, 0.0, 0)
    pipe = WarmStartPipeline(model_fn=model.dfm_apply, draft=None, path=WarmStartPath(0.0),
                             cold_nfe=MOONS_COLD_NFE, vocab_size=MOONS_GRID, seq_len=2,
                             device="cuda")
    x_cold, rep = pipe.generate(prng.key(1), 4000)
    draft = CorruptionDraft(data=data, vocab_size=MOONS_GRID, corruption=0.05, jitter=2,
                            device="cuda")
    drafts = draft.generate(prng.key(2), 4096).cpu().numpy()
    src_w, tgt_w = KNNRefinementCoupling(k=3, k_inject=2).build(data, drafts, rng)
    model_w, out["warm_train"] = train(src_w, tgt_w, 0.8, 1)
    pipe_w = WarmStartPipeline(model_fn=model_w.dfm_apply, draft=draft,
                               path=WarmStartPath(0.8), cold_nfe=MOONS_COLD_NFE,
                               vocab_size=MOONS_GRID, seq_len=2, device="cuda")
    x_warm, rep_w = pipe_w.generate(prng.key(3), 4000)
    counts = dict(launches)
    for what, x in (("cold", x_cold), ("warm", x_warm)):
        if x.shape != (4000, 2) or int(x.min()) < 0 or int(x.max()) >= MOONS_GRID:
            fail(f"moons {what}: samples {tuple(x.shape)} outside the grid")
    skl_cold = symmetric_kl(x_cold.cpu().numpy(), eval_ref)
    skl_warm = symmetric_kl(x_warm.cpu().numpy(), eval_ref)
    if (rep.warm_nfe, rep_w.warm_nfe, rep_w.cold_nfe) != (MOONS_COLD_NFE, 4, MOONS_COLD_NFE):
        fail(f"moons NFE: cold {rep.warm_nfe}, warm {rep_w.warm_nfe} of {rep_w.cold_nfe}")
    if not (math.isfinite(skl_cold) and math.isfinite(skl_warm)):
        fail(f"moons SKL not finite: cold {skl_cold}, warm {skl_warm}")
    out.update({"skl_cold": skl_cold, "skl_warm": skl_warm, "nfe_cold": rep.warm_nfe,
                "nfe_warm": rep_w.warm_nfe, "guaranteed_factor": rep_w.guaranteed_factor,
                "launches": counts})
    print(f"moons: SKL cold {skl_cold:.4f} at {rep.warm_nfe} NFE, warm {skl_warm:.4f} at "
          f"{rep_w.warm_nfe} NFE (x{rep_w.guaranteed_factor:.1f} guaranteed); training "
          f"{out['cold_train']['train_s']:.1f} s / {out['warm_train']['train_s']:.1f} s "
          f"({out['cold_train']['median_step_ms']:.2f} / "
          f"{out['warm_train']['median_step_ms']:.2f} ms a step); launches {counts}")
    return out


def train_path():
    """The training path at full width: the gradient gate, then
    ``launch/train.main`` (``dfm_dit`` CONFIG, 32 x 256, t0 = 0.8, AMSGrad,
    TRAIN_STEPS steps, a checkpoint) with exact launch counts, finite loss
    and grad norm at every step, the checkpoint restored bitwise (weights,
    optimizer state, logits), a profile of one step by phase, and the moons
    study."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.checkpoint.io import flatten
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels import launches
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build_model
    from repro_torch.training import Trainer

    t_phase = time.perf_counter()
    cfg = get_config("dfm-dit").replace(max_seq_len=max(4096, SEQ))
    batch, key = train_batch(cfg)
    grad_gate = check_train_gradients(cfg, batch, key)
    torch.cuda.empty_cache()
    graph_gate = train_graph_gate(
        "the DiT's train step (32 x 256)", build_model(cfg, device="cuda", seed=0),
        RunConfig(arch=cfg.name, t0=T0, batch_size=NUM, total_steps=TRAIN_STEPS),
        [batch] * TRAIN_GATE_STEPS)

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()    # what earlier phases still hold
        launches.clear()
        t = time.perf_counter()
        trainer, state, path = launch_train.main(train_argv(ckpt_dir))
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t
        counts = dict(launches)
        peak = torch.cuda.max_memory_allocated()
        want = {"flash_attn": cfg.num_layers * TRAIN_STEPS}
        graphs = trainer._step_fn.graphs.stats()
        if counts != want or (graphs["captures"], graphs["replays"]) != (1, TRAIN_STEPS - 1):
            fail(f"training: launches {counts}, expected {want}; graphs {graphs}, expected one "
                 f"capture and {TRAIN_STEPS - 1} replays")
        losses = torch.stack(trainer.step_losses).cpu()
        gnorms = torch.stack(trainer.step_grad_norms).cpu()
        if len(losses) != TRAIN_STEPS or not bool(torch.isfinite(losses).all()) \
                or not bool(torch.isfinite(gnorms).all()):
            fail(f"training: losses {losses.tolist()} grad norms {gnorms.tolist()}")
        step_ms = trainer.step_ms()
        model = state.params
        n_params = sum(p.numel() for p in model.parameters())

        other = build_model(cfg, device="cuda", seed=1)
        template = Trainer(other, cfg, RunConfig(t0=T0)).init_state()
        restored = restore_checkpoint(ckpt_dir, template)
        mine, theirs = flatten(state), flatten(restored)
        if sorted(mine) != sorted(theirs) or any(
                mine[k].dtype != theirs[k].dtype or mine[k].tobytes() != theirs[k].tobytes()
                for k in mine):
            fail("checkpoint: the restored state differs from the trained one")
        with torch.no_grad():
            t_b = torch.full((NUM,), T0, device="cuda")
            if not torch.equal(model(batch["x_src"], t_b), other(batch["x_src"], t_b)):
                fail("checkpoint: the restored model's logits differ")
        print(f"checkpoint {path}: {len(mine)} leaves restored bitwise, logits equal")
        del template, restored, other, mine, theirs
        torch.cuda.empty_cache()
        phases = profile_train_step(trainer, state, batch, key)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    tokens = NUM * SEQ
    median_ms = statistics.median(step_ms[1:])
    model_flops = 6 * n_params * tokens
    train = {
        "config": cfg.name, "params": n_params, "batch": NUM, "seq_len": SEQ, "t0": T0,
        "optimizer": "adamw, amsgrad, float32 moments", "steps": TRAIN_STEPS,
        "lr_schedule": "warmup_cosine(3e-4, 100, steps)", "grad_clip": 1.0,
        "step": "one CUDA graph replay a step (jit_train_step); the first step captures",
        "graphs": graphs, "capture_step_ms": step_ms[0],
        "first_step_ms": step_ms[0], "median_step_ms": median_ms, "step_ms": step_ms,
        "tokens_per_s": tokens / median_ms * 1e3,
        "model_flop_share": model_flops / (median_ms / 1e3) / F32_OPS_PER_S,
        "model_flops_per_step": model_flops,
        "max_memory_allocated_bytes": peak, "allocated_before_bytes": base,
        "peak_above_start_bytes": peak - base, "launches": counts,
        "launches_per_step": {"flash_attn": cfg.num_layers},
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "grad_norm_first": float(gnorms[0]), "grad_norm_last": float(gnorms[-1]),
        "launch_train_main_s": main_s, "grad_gate": grad_gate, "graph_gate": graph_gate,
        "phases": phases,
    }
    print(f"training: dfm_dit CONFIG ({n_params / 1e6:.1f}M params), {NUM} x {SEQ}, "
          f"{TRAIN_STEPS} steps through launch.train.main, one graph capture and "
          f"{TRAIN_STEPS - 1} replays: the capturing step {step_ms[0]:.1f} ms, a replay's "
          f"median {median_ms:.2f} ms (eager {statistics.median(graph_gate['eager']['step_ms'][1:]):.2f} ms "
          f"in the graph gate; {train['tokens_per_s']:.0f} tokens/s, model-FLOP "
          f"share {train['model_flop_share']:.1%} of 67 TFLOP/s), peak memory "
          f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB above the "
          f"{base / 2**30:.2f} GiB held before), loss {train['loss_first']:.4f} -> {train['loss_last']:.4f}, "
          f"launches {counts}")
    train["moons"] = moons_experiment()
    train["phase_s"] = time.perf_counter() - t_phase
    return train, counts, model


# -- the drafting policies -------------------------------------------------------------

POLICY_TIMES = (0.3, 0.5, 0.7)      # the multi-time probe
POLICY_PER_TIER = 64                # rows a corruption tier in the calibration


def check_failed_capture_recovers():
    """After a capture that a synchronisation broke, the default CUDA
    generator draws (no ``generator=``) and a fresh GraphCache captures and
    replays a good function, bitwise equal to its eager run."""
    from repro_torch.graphs import GraphCache, GraphCaptureError

    x = torch.arange(8, device="cuda", dtype=torch.float32)
    try:
        GraphCache("a synchronising function")("k", lambda t: t * t.sum().item(), x)
        fail("a capture that reads the card on the host did not raise")
    except GraphCaptureError as err:
        raised = str(err).split(";")[0][:160]
    drew = torch.randn(4, device="cuda")
    good = GraphCache("a good function")
    g = torch.Generator(device="cuda").manual_seed(0)
    equal = []
    for _ in range(3):
        inp = torch.randn(4096, generator=g, device="cuda")
        equal.append(torch.equal(good("k", lambda t: torch.sin(t) * 2 + torch.cumsum(t, 0),
                                      inp), torch.sin(inp) * 2 + torch.cumsum(inp, 0)))
    torch.cuda.synchronize()
    res = {"raised": raised, "default_generator_draws": bool(torch.isfinite(drew).all()),
           "fresh_capture_equal": equal, "captures": good.captures, "replays": good.replays}
    print(f"failed capture: {raised}; then the default generator draws, a fresh capture "
          f"replays bitwise {equal} ({good.captures} capture, {good.replays} replays)")
    if not all(equal) or (good.captures, good.replays) != (1, 3):
        fail(f"after a failed capture: {res}")
    return res


class TimedScorer:
    """A probe with each call timed to the card's end and recorded."""

    def __init__(self, score):
        self.score, self.calls = score, []

    @property
    def graphs(self):
        return self.score.graphs

    def __call__(self, tokens):
        t = time.perf_counter()
        out = self.score(tokens).cpu()
        self.calls.append({"rows": int(out.shape[0]), "ms": (time.perf_counter() - t) * 1e3,
                           "scores": out.numpy()})
        return out


class RecordingDraft:
    """``draft_fn`` with each call timed to its stream's end and its rows
    kept on the host by their key words."""

    def __init__(self, draft_fn):
        self.draft_fn, self.calls, self.rows = draft_fn, [], {}

    def __call__(self, keys, seq_len):
        t = time.perf_counter()
        x = self.draft_fn(keys, seq_len)
        host = x.cpu()
        self.calls.append({"rows": int(keys.shape[0]), "seq_len": int(seq_len),
                           "ms": (time.perf_counter() - t) * 1e3})
        for k, row in zip(keys.tolist(), host):
            self.rows[(tuple(k), int(seq_len))] = row
        return x


def request_draft(draft, req, blen):
    """A request's rows as the pre-pass drafted them (by their row keys)."""
    import numpy as np

    from repro_torch.serving.scheduler import _derive_row_keys

    keys, _ = _derive_row_keys(np.full(req.num_samples, req.seed),
                               np.arange(req.sample_offset, req.sample_offset + req.num_samples))
    return torch.stack([draft.rows[(tuple(k), blen)] for k in keys.tolist()])


def request_min_scores(reqs, calls, min_bucket, max_bucket):
    """Each scored request's minimum row score in one pre-pass: its probe
    calls are one a bucket, ascending, each over the bucket's scored
    requests' rows in request order."""
    from repro_torch.serving import bucket_seq_len

    by_bucket = {}
    for r in reqs:
        if r.t0 is None:
            blen = bucket_seq_len(r.seq_len, min_bucket=min_bucket, max_bucket=max_bucket)
            by_bucket.setdefault(blen, []).append(r)
    out = {}
    for (blen, rs), call in zip(sorted(by_bucket.items()), calls):
        at = 0
        for r in rs:
            out[r.request_id] = float(call["scores"][at:at + r.num_samples].min())
            at += r.num_samples
    return out


def check_small_policy_against_cpu():
    """A small policy scheduler (smoke DiT, its probe, per-row t0,
    speculative, 5 requests) on the card equals the same on the CPU: tokens,
    t0s, per-row t0s, the accepted set, the t0 histogram and the speculative
    counts."""
    from repro_torch.configs.dfm_dit import smoke_config
    from repro_torch.drafting import AdaptiveT0Policy, T0Calibration, make_quality_scorer
    from repro_torch.models import Model
    from repro_torch.serving import ServeRequest, WarmStartScheduler, uniform_draft

    spec = [(32, 3, None), (24, 2, None), (32, 1, 0.5), (14, 4, None), (18, 2, None)]
    out = []
    for device in ("cuda", "cpu"):
        model = Model(smoke_config(), device="cpu", seed=3).to(device)
        pol = AdaptiveT0Policy(
            scorer=make_quality_scorer(model.dfm_apply, device=device),
            calibration=T0Calibration(scores=(-3.6, -3.0), t0s=(0.5, 0.9), t0_floor=0.5,
                                      t0_ceil=0.9), bin_width=0.1)
        sched = WarmStartScheduler(flow_model=model, draft_fn=uniform_draft(VOCAB, device=device),
                                   cold_nfe=16, default_t0=T0, max_rows=8, t0_policy=pol,
                                   per_row_t0=True, speculative=True, accept_score=-3.3,
                                   device=device)
        reqs = [ServeRequest(request_id=i, seq_len=L, num_samples=n, seed=30 + i, t0=t0)
                for i, (L, n, t0) in enumerate(spec)]
        res, rep = sched.serve_requests(reqs)
        out.append(({rid: (r.tokens.tolist(), r.nfe, r.t0, r.row_t0s, r.micro_batch)
                     for rid, r in sorted(res.items())},
                    rep["policy"]["t0_histogram"], rep["speculative"]["eligible"],
                    rep["speculative"]["accepted"]))
    card, cpu = out
    accepted = sorted(rid for rid, v in card[0].items() if v[1] == 0)
    print(f"small policy scheduler (smoke config, probe, per-row t0, speculative, 5 "
          f"requests): card == CPU {card == cpu}; accepted {accepted}, t0 histogram "
          f"{card[1]}, eligible {card[2]}")
    if card != cpu:
        fail("the small policy scheduler on the card disagrees with the CPU")
    return {"equal": True, "accepted": accepted, "t0_histogram": card[1]}


def policy_path(model, engine):
    """The drafting policies at full width on the trained DiT, drafted by the
    full-width AR engine, over the 16 scheduler requests (explicit t0s kept,
    the rest scored): (a) AdaptiveT0Policy on a calibration fitted to the
    text corpus, single- and multi-time probe; (b) the same with per-row t0
    and speculative accept (accept_score between the smallest and largest
    request minimum), against speculation off; (c) BanditT0Policy (epsilon
    0, per-row t0) through serve_requests and serve_stream. Every run's
    launch counts, every request ending once, accepted = its drafts, rejected
    = speculation off, bandit pulls = priors + rows refined, one draft_fn
    call a bucket in the pre-pass and none in the draft stage."""
    import numpy as np

    from repro_torch.core.guarantees import warm_nfe
    from repro_torch.data import SyntheticCorpus
    from repro_torch.drafting import (
        AdaptiveT0Policy, BanditT0Policy, fit_t0_calibration, make_quality_scorer,
    )
    from repro_torch.serving import WarmStartScheduler, bucket_seq_len

    t_phase = time.perf_counter()
    layers = model.cfg.num_layers
    reqs = sched_requests()
    data = SyntheticCorpus(seed=0).sequences(4 * POLICY_PER_TIER, SEQ, seed=11)
    probes = {"single": TimedScorer(make_quality_scorer(model.dfm_apply, device="cuda")),
              "multi": TimedScorer(make_quality_scorer(model.dfm_apply, device="cuda",
                                                       probe_times=POLICY_TIMES))}
    n_times = {"single": 1, "multi": len(POLICY_TIMES)}
    cals = {}
    for name, probe in probes.items():
        t = time.perf_counter()
        cals[name] = fit_t0_calibration(probe, data, VOCAB, num_per_tier=POLICY_PER_TIER,
                                        device="cuda")
        torch.cuda.synchronize()
        print(f"calibration ({name}-time probe, {POLICY_PER_TIER} rows a tier, 3 tiers): "
              f"anchors {list(zip(cals[name].scores, cals[name].t0s))}, floor "
              f"{cals[name].t0_floor}, ceil {cals[name].t0_ceil}, "
              f"{(time.perf_counter() - t) * 1e3:.1f} ms")
    probe_captures = {n: p.graphs.captures for n, p in probes.items()}

    def scheduler(draft, **kw):
        return WarmStartScheduler(flow_model=model, draft_fn=draft, device="cuda", **SCHED,
                                  **kw)

    def counted(what, sched, draft, probe_name, fn):
        """``fn()`` gated: exact launches (pre-pass drafts, probe evaluations
        incl. capture warm-ups, refine), one draft_fn call a bucket."""
        probe = probes[probe_name]
        c0, p0, d0 = len(probe.calls), probe.graphs.captures, len(draft.calls)
        t = time.perf_counter()
        out, rep, got = run_counted(
            what, sched, fn, engine, layers,
            drafts=lambda: [c["seq_len"] for c in draft.calls[d0:]],
            probe_evals=lambda: n_times[probe_name] * (len(probe.calls) - c0
                                                       + probe.graphs.captures - p0))
        wall = time.perf_counter() - t
        launches_by_run[what] = got
        buckets = sorted({bucket_seq_len(r.seq_len, min_bucket=SCHED["min_bucket"],
                                         max_bucket=SCHED["max_bucket"]) for r in reqs})
        streamed = isinstance(out, list)
        calls = [c["seq_len"] for c in draft.calls[d0:]]
        if (not streamed and calls != buckets) or (streamed and set(calls) != set(buckets)):
            fail(f"{what}: draft_fn calls {calls}, expected one a bucket {buckets} in the "
                 f"pre-pass and none in the draft stage")
        return out, rep, wall, probe.calls[c0:], draft.calls[d0:]

    launches_by_run = {}

    def results_of(out):
        return {c.request_id: c for c in out} if isinstance(out, list) else out

    def gate_requests(what, out, rep):
        res = results_of(out)
        ids = [c.request_id for c in out] if isinstance(out, list) else list(res)
        if sorted(ids) != list(range(len(reqs))):
            fail(f"{what}: requests ended {sorted(ids)}, expected each of {len(reqs)} once")
        for r in reqs:
            got = res[r.request_id]
            toks = np.asarray(got.tokens)
            if toks.shape != (r.num_samples, r.seq_len) or toks.min() < 0 or toks.max() >= VOCAB:
                fail(f"{what}: request {r.request_id} tokens {toks.shape}")
            if r.t0 is not None and (got.nfe == 0 or got.t0 != r.t0):
                fail(f"{what}: explicit-t0 request {r.request_id} served at {got.t0}, "
                     f"nfe {got.nfe}")
            if got.nfe and (got.nfe != warm_nfe(COLD_NFE, got.t0)
                            or (got.row_t0s and got.t0 != min(got.row_t0s))):
                fail(f"{what}: request {r.request_id} nfe {got.nfe} t0 {got.t0} rows "
                     f"{got.row_t0s}")
        if isinstance(out, list) and not rep["conservation"]["balanced"]:
            fail(f"{what}: ledger {rep['conservation']}")

    def mean_nfe(out):
        vals = []
        for c in results_of(out).values():
            vals.append(float(np.mean([warm_nfe(COLD_NFE, t) for t in c.row_t0s]))
                        if c.row_t0s else float(c.nfe))
        return float(np.mean(vals))

    runs = {}
    rows = sum(r.num_samples for r in reqs)
    # a batch pre-pass probes once a bucket that holds a scored request
    n_prepass = len({bucket_seq_len(r.seq_len, min_bucket=SCHED["min_bucket"],
                                    max_bucket=SCHED["max_bucket"])
                     for r in reqs if r.t0 is None})

    def record(name, out, rep, wall, pcalls, dcalls, probe_name):
        """The run's numbers; a batch run's probe calls split into the
        pre-pass's and the bandit's reward probes after them."""
        streamed = isinstance(out, list)
        pre = pcalls if streamed else pcalls[:n_prepass]
        runs[name] = {
            "probe": probe_name, "wall_s": wall, "report_wall_s": rep.get("wall_time_s"),
            "prepass_ms": rep["policy"]["prepass_time_s"] * 1e3,
            "prepass_draft_ms": sum(c["ms"] for c in dcalls),
            "prepass_probe_ms": sum(c["ms"] for c in pre),
            "probe_ms_each": [c["ms"] for c in pcalls], "probe_rows_each":
            [c["rows"] for c in pcalls],
            "reward_probe_ms_each": None if streamed else [c["ms"] for c in pcalls[n_prepass:]],
            "draft_calls": [[c["rows"], c["seq_len"], c["ms"]] for c in dcalls],
            "scored_requests": rep["policy"]["scored_requests"],
            "t0_histogram": rep["policy"].get("t0_histogram"),
            "speculative": rep.get("speculative"), "mean_request_nfe": mean_nfe(out),
            "requests_per_s": len(reqs) / wall, "samples_per_s": rows / wall,
            "micro_batches": len(rep["batches"]),
            "nfe_per_micro_batch": [b["nfe"] for b in rep["batches"]],
            "flow_s": rep["flow_time_s"], "draft_s": rep["draft_time_s"],
        }

    # the fixed-t0 yardstick on the same requests and weights
    base_draft = RecordingDraft(engine.as_draft_fn())
    fixed = scheduler(base_draft)
    t = time.perf_counter()
    res_fixed, rep_fixed = fixed.serve_requests(reqs)
    torch.cuda.synchronize()
    wall_fixed = time.perf_counter() - t
    t = time.perf_counter()
    res_fixed, rep_fixed = fixed.serve_requests(reqs)       # replays only
    torch.cuda.synchronize()
    wall_fixed = time.perf_counter() - t

    # (a) the calibrated policy, single- and multi-time
    for name in ("single", "multi"):
        pol = AdaptiveT0Policy(scorer=probes[name], calibration=cals[name])
        draft = RecordingDraft(engine.as_draft_fn())
        sched = scheduler(draft, t0_policy=pol)
        out, rep, wall, pc, dc = counted(f"policy ({name}-time)", sched, draft, name,
                                         lambda sched=sched: sched.serve_requests(reqs))
        gate_requests(f"policy ({name}-time)", out, rep)
        record(f"adaptive_{name}", out, rep, wall, pc, dc, name)
        out, rep, wall, pc, dc = counted(f"policy ({name}-time), again", sched, draft, name,
                                         lambda sched=sched: sched.serve_requests(reqs))
        record(f"adaptive_{name}_again", out, rep, wall, pc, dc, name)

    # (b) per-row t0 with speculation off, then on at a threshold that splits
    pol = AdaptiveT0Policy(scorer=probes["single"], calibration=cals["single"])
    draft = RecordingDraft(engine.as_draft_fn())
    sched_off = scheduler(draft, t0_policy=pol, per_row_t0=True)
    res_off, rep_off, wall, pc, dc = counted("per-row t0, speculation off", sched_off, draft,
                                             "single", lambda: sched_off.serve_requests(reqs))
    gate_requests("per-row t0, speculation off", res_off, rep_off)
    record("per_row", res_off, rep_off, wall, pc, dc, "single")
    mins = request_min_scores(reqs, pc, SCHED["min_bucket"], SCHED["max_bucket"])
    # halfway between the two middle request minima: both sides accept and
    # reject, and no minimum lies near the threshold
    vals = sorted(set(mins.values()))
    if len(vals) < 2:
        fail(f"speculative: the request minima {mins} do not split")
    thr = (vals[(len(vals) - 1) // 2] + vals[(len(vals) + 1) // 2]) / 2.0 if len(vals) > 2 \
        else (vals[0] + vals[1]) / 2.0
    draft_on = RecordingDraft(engine.as_draft_fn())
    sched_on = scheduler(draft_on, t0_policy=pol, per_row_t0=True, speculative=True,
                         accept_score=thr)
    res_on, rep_on, wall, pc, dc = counted("per-row t0, speculative", sched_on, draft_on,
                                           "single", lambda: sched_on.serve_requests(reqs))
    gate_requests("per-row t0, speculative", res_on, rep_on)
    record("speculative", res_on, rep_on, wall, pc, dc, "single")
    accepted = sorted(rid for rid, r in res_on.items() if r.nfe == 0)
    rejected_diff = 0
    for r in reqs:
        got = res_on[r.request_id]
        if got.nfe == 0:
            blen = bucket_seq_len(r.seq_len, min_bucket=SCHED["min_bucket"],
                                  max_bucket=SCHED["max_bucket"])
            want = request_draft(draft_on, r, blen)[:, :r.seq_len].numpy()
            if (got.micro_batch != -1 or r.t0 is not None or mins[r.request_id] < thr
                    or not np.array_equal(got.tokens, want)):
                fail(f"accepted request {r.request_id}: not its pre-pass drafts, or not "
                     f"eligible (min score {mins.get(r.request_id)} vs {thr})")
        else:
            other = res_off[r.request_id]
            rejected_diff += int((np.asarray(got.tokens) != np.asarray(other.tokens)).sum())
            if (got.t0, got.row_t0s, got.nfe) != (other.t0, other.row_t0s, other.nfe):
                fail(f"rejected request {r.request_id}: t0s differ from speculation off")
    spec = rep_on["speculative"]
    print(f"speculative: accept_score {thr:.6f} (request minima {json.dumps(mins)}); "
          f"accepted {accepted}, eligible {spec['eligible']}; rejected requests' tokens "
          f"differing from speculation off: {rejected_diff}")
    if rejected_diff or not (0 < len(accepted) < spec["eligible"]):
        fail(f"speculative: {rejected_diff} rejected tokens differ, accepted {accepted} of "
             f"{spec['eligible']}")

    # (c) the bandit, epsilon 0, per-row t0: batch and stream
    scored_rows = sum(r.num_samples for r in reqs if r.t0 is None)
    bandit = {}
    for how in ("batch", "stream"):
        pol = BanditT0Policy(scorer=probes["single"], calibration=cals["single"],
                             exploration="epsilon", epsilon=0.0)
        draft = RecordingDraft(engine.as_draft_fn())
        sched = scheduler(draft, t0_policy=pol, per_row_t0=True)
        if how == "batch":
            fn = lambda sched=sched: sched.serve_requests(reqs)         # noqa: E731
        else:
            fn = lambda sched=sched: (list(sched.serve_stream(reqs)),   # noqa: E731
                                      sched.stream_report)
        out, rep, wall, pc, dc = counted(f"bandit ({how})", sched, draft, "single", fn)
        gate_requests(f"bandit ({how})", out, rep)
        record(f"bandit_{how}", out, rep, wall, pc, dc, "single")
        stats = rep["bandit"]
        pulls = sum(a["count"] for ctx in stats.values() for a in ctx["arms"].values())
        want = len(stats) * pol.prior_weight + scored_rows
        bandit[how] = {"contexts": len(stats), "pulls": pulls, "priors_plus_rows": want,
                       "reward_probes": sched._c_reward_probes.value, "arm_stats": stats}
        print(f"bandit ({how}): {len(stats)} contexts, pulls {pulls} = priors "
              f"{len(stats) * pol.prior_weight} + rows refined {scored_rows}; "
              f"{sched._c_reward_probes.value} reward probes, probe ms "
              f"{[round(c['ms'], 2) for c in pc]}")
        if abs(pulls - want) > 1e-9:
            fail(f"bandit ({how}): pulls {pulls}, expected {want}")

    small = check_small_policy_against_cpu()
    res = {"config": model.cfg.name, "weights": f"trained {TRAIN_STEPS} steps (the training "
           "phase)", "requests": len(reqs), "scored": sum(r.t0 is None for r in reqs),
           "calibration": {n: {"scores": c.scores, "t0s": c.t0s, "floor": c.t0_floor,
                               "ceil": c.t0_ceil} for n, c in cals.items()},
           "probe_times": POLICY_TIMES, "probe_captures": {n: p.graphs.stats()
                                                         for n, p in probes.items()},
           "probe_captures_by_calibration": probe_captures,
           "fixed": {"wall_s": wall_fixed, "requests_per_s": len(reqs) / wall_fixed,
                     "samples_per_s": rep_fixed["rows"] / wall_fixed,
                     "mean_request_nfe": rep_fixed["mean_request_nfe"],
                     "nfe_per_micro_batch": [b["nfe"] for b in rep_fixed["batches"]]},
           "runs": runs, "accept_score": thr, "request_min_scores": mins,
           "accepted": accepted, "bandit": bandit, "small_vs_cpu": small,
           "launches_by_run": launches_by_run,
           "launches": {k: sum(c.get(k, 0) for c in launches_by_run.values())
                        for k in ("flash_attn", "ws_step_rows") + DRAFT_KERNELS},
           "phase_s": time.perf_counter() - t_phase}
    print(f"policy: fixed t0 {wall_fixed:.3f} s ({len(reqs) / wall_fixed:.2f} requests/s); "
          + "; ".join(f"{k} {v['wall_s']:.3f} s (pre-pass {v['prepass_ms']:.1f} ms: draft "
                      f"{v['prepass_draft_ms']:.1f}, probe {v['prepass_probe_ms']:.1f}; mean "
                      f"NFE {v['mean_request_nfe']:.2f})" for k, v in runs.items()))
    return res, probes["single"], cals["single"]


DISTILL_NFE = 1          # K of the served mix; the head is also timed at K = 2
DISTILL_EPOCHS = 8       # the launcher's


class TimedPairBuffer:
    """A ``PairBuffer`` whose ``add_batch`` calls are timed."""

    def __init__(self):
        from repro_torch.drafting import PairBuffer

        self.buf, self.add_ms = PairBuffer(), []

    def add_batch(self, *args, **kw):
        t = time.perf_counter()
        out = self.buf.add_batch(*args, **kw)
        self.add_ms.append((time.perf_counter() - t) * 1e3)
        return out


def one_micro_batch(tier, t0, k=DISTILL_NFE, seed=5000):
    """32 one-row requests of 256 tokens at ``t0`` packed: one (256, 32) micro-batch."""
    from repro_torch.serving import ServeRequest, pack_requests

    reqs = [ServeRequest(request_id=i, seq_len=SEQ, num_samples=1, seed=seed + i, t0=t0,
                         tier=tier) for i in range(NUM)]
    (mb,) = pack_requests(reqs, cold_nfe=COLD_NFE, default_t0=T0, max_rows=NUM,
                          row_quantum=4, distilled_nfe=k)
    return mb


def distilled_train_runs(head, buffer):
    """``train_distilled`` as the phase calls it, through its graphs (one
    capture a batch shape), then twice with its step un-jitted
    (``jit_distill_step`` patched to the identity: eager launches), each
    step's outputs recorded: :func:`check_graph_equals_eager` on each step's
    loss and agreement, the head's weights and AdamW's moments; one capture
    a batch shape and a replay every other step. Returns the graphed run's
    (params, report, ms) and the gate's record."""
    from repro_torch.drafting import distill

    real = distill.jit_distill_step
    runs = {}
    for name in ("graph", "eager", "eager_again"):
        log, made = [], []

        def wrap(step, graphed=name == "graph"):
            inner = real(step) if graphed else step
            made.append(inner)

            def recording(opt_state, draft, refined, t0):
                out = inner(opt_state, draft, refined, t0)
                log.append(out)
                return out
            return recording

        distill.jit_distill_step = wrap
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, rep = distill.train_distilled(head, buffer, key=13, epochs=DISTILL_EPOCHS,
                                                  device="cuda")
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
        finally:
            distill.jit_distill_step = real
        leaves = {("param", k): v.clone() for k, v in params.items()}
        leaves.update({(f, k): v.clone() for f in ("mu", "nu")
                       for k, v in getattr(log[-1][0], f).items()})
        metrics = torch.stack([torch.stack([loss.float(), agree.float()]) for _, loss, agree in log])
        runs[name] = (params, rep, ms, (metrics, leaves), made[0])
    params, rep, ms, graph, jitted = runs["graph"]
    bound = 2 * 3e-2 * rep.steps       # train_distilled's constant learning rate
    res = check_graph_equals_eager("the distilled head's train step", graph, runs["eager"][3],
                                   run_to_run(runs["eager"][3], runs["eager_again"][3]), bound)
    stats = jitted.graphs.stats()
    res.update({"graphs": stats, "graphed_ms": ms, "eager_ms": runs["eager"][2],
                "eager_again_ms": runs["eager_again"][2]})
    if stats["captures"] != stats["graphs"] or stats["captures"] + stats["replays"] != rep.steps:
        fail(f"distilled training: graphs {stats} for {rep.steps} steps: expected one capture "
             f"a batch shape and a replay every other step")
    print(f"distilled training: {rep.steps} steps, {stats['captures']} captures (one a batch "
          f"shape) and {stats['replays']} replays in {ms:.1f} ms; eager "
          f"{runs['eager'][2]:.1f} ms and {runs['eager_again'][2]:.1f} ms")
    return params, rep, ms, res


def distilled_path(model, engine, probe, cal):
    """The distilled tier at full width behind the trained DiT (the teacher),
    drafted by the full-width AR engine, on the policy phase's probe and
    calibration: harvest the 16 requests' pairs from a guaranteed run, train
    the head on them, calibrate the floor over the requests routed
    distilled, serve the mix (alternate requests distilled) through
    serve_requests and serve_stream with a tracer, time the head, the gate
    probe and a guaranteed micro-batch at (32, 256), then run the launcher's
    ``--check-distilled``. Every gate fails the run."""
    import os
    import tempfile

    import numpy as np

    from repro_torch.core.guarantees import warm_nfe
    from repro_torch.core.sampler import refine_schedule_rows
    from repro_torch.drafting import (
        AdaptiveT0Policy, DistilledRefiner, restore_distilled, save_distilled, train_distilled,
    )
    from repro_torch.kernels import launches
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.obs import SpanTracer, load_trace, validate_trace, write_chrome_trace
    from repro_torch.serving import (
        DISTILLED, DISTILLED_TIER, GUARANTEED_TIER, WarmStartScheduler, bucket_seq_len,
    )
    from repro_torch.serving.scheduler import _derive_row_keys

    t_phase = time.perf_counter()
    layers = model.cfg.num_layers
    reqs = sched_requests()
    rows = sum(r.num_samples for r in reqs)
    totals = {}
    walls = {}

    def scheduler(draft, **kw):
        return WarmStartScheduler(flow_model=model, draft_fn=draft, device="cuda", **SCHED,
                                  t0_policy=AdaptiveT0Policy(scorer=probe, calibration=cal),
                                  **kw)

    def counted(what, sched, draft, fn):
        """``fn()`` with exact launch counts (pre-pass drafts of every round,
        probe evaluations incl. the gate's and capture warm-ups, refine and
        head steps)."""
        c0, p0, d0 = len(probe.calls), probe.graphs.captures, len(draft.calls)
        t = time.perf_counter()
        out, rep, got = run_counted(
            what, sched, fn, engine, layers,
            drafts=lambda: [c["seq_len"] for c in draft.calls[d0:]],
            probe_evals=lambda: len(probe.calls) - c0 + probe.graphs.captures - p0)
        walls[what] = time.perf_counter() - t
        for k, v in got.items():
            totals[k] = totals.get(k, 0) + v
        return out, rep

    def results_of(out):
        return {c.request_id: c for c in out} if isinstance(out, list) else out

    # 1. harvest: the 16 requests guaranteed, a pair buffer attached
    buf = TimedPairBuffer()
    draft_g = RecordingDraft(engine.as_draft_fn())
    sched_g = scheduler(draft_g, pair_buffer=buf)
    res_g, rep_g = counted("distilled: harvest", sched_g, draft_g,
                           lambda: sched_g.serve_requests(reqs))
    pairs = len(buf.buf)
    pool = {n: refined.tolist() for n, (_, refined, _) in buf.buf.snapshot().items()}
    unmatched = 0
    for r in reqs:
        blen = bucket_seq_len(r.seq_len, min_bucket=SCHED["min_bucket"],
                              max_bucket=SCHED["max_bucket"])
        for row in np.asarray(res_g[r.request_id].tokens).tolist():
            at = next((i for i, h in enumerate(pool.get(blen, [])) if h[:r.seq_len] == row),
                      None)
            if at is None:
                unmatched += 1
            else:
                pool[blen].pop(at)
    print(f"distilled harvest: {pairs} pairs of {rows} rows ({buf.buf.stats()}), served rows "
          f"without their harvested row: {unmatched}; add_batch ms "
          f"{[round(v, 3) for v in buf.add_ms]}")
    if pairs != rows or unmatched or any(pool.values()):
        fail(f"harvest: {pairs} pairs for {rows} rows, {unmatched} served rows unmatched")
    x32 = torch.randint(0, VOCAB, (NUM, SEQ), generator=torch.Generator(device="cuda")
                        .manual_seed(25), device="cuda", dtype=torch.int32)
    copy_ms = time_ms(lambda: x32.cpu(), reps=5, inner=10)
    sched_g.pair_buffer = None
    res_g2, rep_g2 = counted("distilled: all guaranteed, again", sched_g, draft_g,
                             lambda: sched_g.serve_requests(reqs))
    if any(not np.array_equal(res_g[i].tokens, res_g2[i].tokens) for i in res_g):
        fail("the all-guaranteed run is not deterministic")

    # 2. train the head on the card (one graph a batch shape, held against its eager
    # steps); the checkpoint round trip bitwise
    head = DistilledRefiner(vocab_size=VOCAB)
    dparams, drep, train_ms, distill_graph = distilled_train_runs(head, buf.buf)
    with tempfile.TemporaryDirectory() as d:
        save_distilled(d, dparams, step=drep.steps)
        back = restore_distilled(d, head, device="cuda")
    ckpt_equal = all(torch.equal(back[k], dparams[k]) for k in dparams)
    print(f"distilled head trained: {drep.as_dict()}, {train_ms:.1f} ms "
          f"({train_ms / max(drep.steps, 1):.2f} ms a step); checkpoint round trip bitwise "
          f"{ckpt_equal}")
    if not (math.isfinite(drep.first_loss) and math.isfinite(drep.final_loss)
            and math.isfinite(drep.final_agreement)) or not ckpt_equal:
        fail(f"distilled training: {drep.as_dict()}, checkpoint bitwise {ckpt_equal}")

    # 3. the floor: the mix served with the floor open, then the median of the
    # minimum scores of the requests routed distilled
    routed = {r.request_id for r in reqs if r.request_id % 2}
    mix = [dataclasses.replace(r, tier=DISTILLED_TIER) if r.request_id in routed else r
           for r in reqs]
    draft_d = RecordingDraft(engine.as_draft_fn())
    sched_d = scheduler(draft_d, distilled_model=head, distilled_params=dparams,
                        distilled_nfe=DISTILL_NFE, distilled_accept_score=-1e9)
    gates, gate_ms = {}, []
    loops = []
    gate_fn, loop_fn = sched_d._distill_gate, sched_d._distill_loop

    def recording_gate(mb, x):
        t = time.perf_counter()
        out = gate_fn(mb, x)
        gate_ms.append((time.perf_counter() - t) * 1e3)
        gates.update(out)
        return out

    def recording_loop(key, x, inputs):
        out = loop_fn(key, x, inputs)
        loops.append((key, x.clone(), inputs, out.clone()))
        return out

    sched_d._distill_gate, sched_d._distill_loop = recording_gate, recording_loop
    res_open, rep_open = counted("distilled: floor open", sched_d, draft_d,
                                 lambda: sched_d.serve_requests(mix))
    mins = {rid: gates[rid][1] for rid in sorted(routed)}
    vals = sorted(set(mins.values()))
    if rep_open["distilled"]["served"] != len(routed) or len(vals) < 2:
        fail(f"floor calibration: served {rep_open['distilled']}, minima {mins}")
    floor = (vals[len(vals) // 2 - 1] + vals[len(vals) // 2]) / 2.0
    sched_d.distilled_accept_score = floor
    print(f"distilled floor {floor:.6f}: the median of the routed requests' minimum scores "
          f"{json.dumps(mins)}")

    # 4. the mix behind the floor: batch (twice: captures, then replays) and stream
    def gate_run(what, out, rep):
        res = results_of(out)
        d = rep["distilled"]
        if sorted(res) != list(range(len(reqs))) or not (d["served"] > 0 and d["fallbacks"] > 0):
            fail(f"{what}: requests {sorted(res)}, distilled {d}")
        for r in reqs:
            got, want = res[r.request_id], res_g[r.request_id]
            served = r.request_id in routed and gates[r.request_id][0]
            if isinstance(out, list) and (got.status == DISTILLED) != served:
                fail(f"{what}: request {r.request_id} status {got.status}")
            if served:
                if got.nfe != DISTILL_NFE or gates[r.request_id][1] < floor:
                    fail(f"{what}: distilled request {r.request_id} nfe {got.nfe} score "
                         f"{gates[r.request_id][1]} under the floor {floor}")
            elif (not np.array_equal(got.tokens, want.tokens) or got.nfe != want.nfe
                  or got.t0 != want.t0 or got.nfe != warm_nfe(COLD_NFE, got.t0)):
                kind = "fallback" if r.request_id in routed else "guaranteed"
                fail(f"{what}: {kind} request {r.request_id} differs from the all-guaranteed "
                     f"run (nfe {got.nfe}/{want.nfe}, t0 {got.t0}/{want.t0})")
        return res

    gates.clear()
    out_b, rep_b = counted("distilled: mix (batch)", sched_d, draft_d,
                           lambda: sched_d.serve_requests(mix))
    gate_run("distilled: mix (batch)", out_b, rep_b)
    gates.clear()
    loops.clear()
    out_b2, rep_b2 = counted("distilled: mix (batch), again", sched_d, draft_d,
                             lambda: sched_d.serve_requests(mix))
    res_b2 = gate_run("distilled: mix (batch), again", out_b2, rep_b2)
    replays = {}
    for key, x, inputs, out in loops:
        if key in replays:
            continue
        eager = sched_d._distill_loop_eager(x, inputs)
        before = dict(launches)
        again = loop_fn(key, x, inputs)
        torch.cuda.synchronize()
        grew = {k: c - before.get(k, 0) for k, c in launches.items() if c != before.get(k, 0)}
        replays[str(key)] = {"equal_eager": bool(torch.equal(eager, out)),
                             "equal_again": bool(torch.equal(again, out)), "launches": grew}
        if not (torch.equal(eager, out) and torch.equal(again, out)) \
                or grew != {"ws_step_rows": DISTILL_NFE}:
            fail(f"distilled graph {key}: {replays[str(key)]}")
    d_keys = sorted(str(k) for k in sched_d._compiled if k[-1] == DISTILLED_TIER)
    captured = sorted(str(k) for k in sched_d.graphs.capture_s if k[-1] == DISTILLED_TIER)
    if not d_keys or d_keys != captured or sched_d.graphs.captures != len(
            sched_d.graphs.capture_s) or sorted(replays) != d_keys:
        fail(f"distilled captures: keys {d_keys}, captured {captured}, replayed {sorted(replays)}")

    gates.clear()
    tracer = SpanTracer()
    sched_d.tracer = tracer
    m0 = sched_d.metrics.snapshot()
    out_s, rep_s = counted("distilled: mix (stream)", sched_d, draft_d,
                           lambda: (list(sched_d.serve_stream(mix)), sched_d.stream_report))
    res_s = gate_run("distilled: mix (stream)", out_s, rep_s)
    sched_d.tracer = None
    ledger = {s_: sched_d.metrics.sum_counters("serve.terminal", m0, status=s_)
              for s_ in rep_s["terminal"]}
    with tempfile.TemporaryDirectory() as d:
        doc = write_chrome_trace(os.path.join(d, "trace.json"), tracer)
    problems = validate_trace(doc, expected_requests=len(reqs))
    n_fallback_events = sum(e.get("name") == "request_fallback" for e in doc["traceEvents"])
    stream_equal = all(np.array_equal(res_s[i].tokens, res_b2[i].tokens)
                       and res_s[i].nfe == res_b2[i].nfe for i in res_s)
    print(f"distilled mix: batch {rep_b2['distilled']}, stream {rep_s['distilled']}; stream == "
          f"batch {stream_equal}; ledger {rep_s['conservation']}; trace problems {problems}, "
          f"{n_fallback_events} request_fallback events; replays {replays}")
    if (not rep_s["conservation"]["balanced"] or ledger != rep_s["terminal"]
            or sched_d.metrics.sum_counters("distilled.fallbacks", m0)
            != rep_s["distilled"]["fallbacks"]
            or sched_d.metrics.sum_counters("serve.admitted", m0) != len(reqs)
            or problems or n_fallback_events != rep_s["distilled"]["fallbacks"]
            or not stream_equal):
        fail(f"distilled stream: ledger {rep_s['conservation']}, report {rep_s['terminal']} vs "
             f"registry {ledger}, trace {problems}, fallback events {n_fallback_events}, "
             f"stream == batch {stream_equal}")
    phase_launches = dict(totals)

    # 5. (32, 256): the head at K = 1 and 2, the gate probe, a guaranteed micro-batch
    heads = {}
    for k in (1, 2):
        s_k = sched_d if k == DISTILL_NFE else scheduler(
            draft_d, distilled_model=head, distilled_params=dparams, distilled_nfe=k,
            distilled_accept_score=floor)
        mb = one_micro_batch(DISTILLED_TIER, T0, k)
        _, inputs = s_k._distill_inputs(mb)
        loop = s_k._distill_loop if s_k is not sched_d else loop_fn
        out = loop(mb.compile_key, x32, inputs)
        before = dict(launches)
        out = loop(mb.compile_key, x32, inputs)
        torch.cuda.synchronize()
        grew = {n: c - before.get(n, 0) for n, c in launches.items() if c != before.get(n, 0)}
        graph = s_k.graphs._graphs[mb.compile_key].graph
        heads[k] = {"key": str(mb.compile_key), "replay_ms": time_ms(graph.replay),
                    "call_ms": time_ms(lambda: loop(mb.compile_key, x32, inputs)),
                    "eager_ms": time_ms(lambda: s_k._distill_loop_eager(x32, inputs)),
                    "equal_eager": bool(torch.equal(out, s_k._distill_loop_eager(x32, inputs))),
                    "launches_a_replay": grew}
        if not heads[k]["equal_eager"] or grew != {"ws_step_rows": k}:
            fail(f"the head at K = {k}, (32, 256): {heads[k]}")
    gate_probe_ms = time_ms(lambda: probe.score(x32), reps=5, inner=3)
    g_mb = one_micro_batch(GUARANTEED_TIER, T0)
    ts, hs, active, key_idx, _ = refine_schedule_rows(g_mb.row_t0s, 1.0 / COLD_NFE, COLD_NFE)
    _, flow_keys = _derive_row_keys(*sched_d._mb_row_streams(g_mb))
    refine_ms = time_ms(lambda: sched_d._refine_loop(g_mb.compile_key, flow_keys, x32, ts, hs,
                                                     active, key_idx), reps=3, inner=1)
    print(f"(32, 256): the head a replay {heads[1]['replay_ms'] * 1e3:.1f} us at K = 1, "
          f"{heads[2]['replay_ms'] * 1e3:.1f} us at K = 2 (a call {heads[1]['call_ms']:.3f} / "
          f"{heads[2]['call_ms']:.3f} ms, eager {heads[1]['eager_ms']:.3f} / "
          f"{heads[2]['eager_ms']:.3f} ms); gate probe {gate_probe_ms:.2f} ms; a guaranteed "
          f"micro-batch {g_mb.compile_key} {refine_ms:.2f} ms")

    # 6. the launcher at its own defaults
    with tempfile.TemporaryDirectory() as d:
        trace_path = os.path.join(d, "trace.json")
        argv = ["--scheduler", "--draft", "ar-kv", "--tier", "distilled", "--check-distilled",
                "--stream", "--trace-out", trace_path]
        t = time.perf_counter()
        try:
            serve_launcher.main(argv)
        except SystemExit as err:
            if err.code not in (0, None):
                fail(f"launch.serve {' '.join(argv)} exited {err.code}")
        launcher_s = time.perf_counter() - t
        launcher_problems = validate_trace(load_trace(trace_path))
    print(f"launch.serve --check-distilled: exit 0 in {launcher_s:.1f} s, trace problems "
          f"{launcher_problems}")
    if launcher_problems:
        fail(f"the launcher's trace: {launcher_problems}")

    def mean_nfe(res):
        return float(np.mean([r.nfe for r in res.values()]))

    wall_g, wall_mix = walls["distilled: all guaranteed, again"], \
        walls["distilled: mix (batch), again"]
    res = {
        "config": model.cfg.name, "teacher": f"trained {TRAIN_STEPS} steps (the training phase)",
        "head": dataclasses.asdict(head), "k": DISTILL_NFE, "requests": len(reqs),
        "routed_distilled": sorted(routed), "pairs": pairs,
        "harvest_add_ms_each": buf.add_ms, "harvest_copy_ms_32x256": copy_ms,
        "train": {**drep.as_dict(), "ms": train_ms, "ms_a_step": train_ms / max(drep.steps, 1),
                  "graph_gate": distill_graph},
        "checkpoint_bitwise": ckpt_equal, "floor": floor, "request_min_scores": mins,
        "served": {"batch": rep_b2["distilled"]["served"], "stream": rep_s["distilled"]["served"]},
        "fallbacks": {"batch": rep_b2["distilled"]["fallbacks"],
                      "stream": rep_s["distilled"]["fallbacks"]},
        "gate_ms_each": gate_ms,
        "head_32x256": heads, "gate_probe_ms_32x256": gate_probe_ms,
        "guaranteed_micro_batch_32x256": {"key": str(g_mb.compile_key), "ms": refine_ms},
        "distilled_micro_batch_32x256_ms": heads[DISTILL_NFE]["call_ms"] + gate_probe_ms,
        "mean_request_nfe": {"mix": mean_nfe(res_b2), "all_guaranteed": mean_nfe(res_g2)},
        "requests_per_s": {"mix": len(reqs) / wall_mix, "all_guaranteed": len(reqs) / wall_g},
        "wall_s": walls, "batches_mix": [{k: b[k] for k in ("bucket_len", "padded_rows", "nfe",
                                                            "tier", "flow_time_s")}
                                         for b in rep_b2["batches"]],
        "graphs": {"distilled_keys": d_keys, "captures": sched_d.graphs.stats()},
        "replays": replays, "trace_events": len(doc["traceEvents"]),
        "fallback_events": n_fallback_events, "stream_equals_batch": stream_equal,
        "launcher_s": launcher_s, "launches": phase_launches,
        "phase_s": time.perf_counter() - t_phase,
    }
    print(f"distilled: {len(reqs) / wall_mix:.2f} requests/s (mean NFE "
          f"{res['mean_request_nfe']['mix']:.2f}) against all guaranteed "
          f"{len(reqs) / wall_g:.2f} (mean NFE {res['mean_request_nfe']['all_guaranteed']:.2f}); "
          f"phase {res['phase_s']:.1f} s")
    return res


# -- the dense zoo -------------------------------------------------------------------

ZOO_ARCH, ZOO_ROWS = "starcoder2-3b", 8   # at its published widths; 8 rows (the DiT: 32)
ZOO_LOGIT_TOKENS = 64                      # the full-width logits against the CPU, 1 x 64
GEMMA_TOKENS = 600                         # past gemma3-1b's 512-token local window
SMOKE_ARCHS = ("starcoder2-3b", "minitron-4b", "command-r-plus-104b", "gemma3-1b")
# the draft kernels at the zoo's layers (the fields of DRAFT_CASES): starcoder2-3b's
# decode (R = 8) and prefill (R = 32) layer, minitron-4b's at R = 8 and 32 (F = 9216),
# command-r-plus-104b's smoke layer (head_dim 16)
ZOO_DRAFT_CASES = [
    ("starcoder2-3b decode", ZOO_ROWS, 1, MAX_LEN, 3072, 12288, 24, 2, 128, "layernorm",
     True, False, "gelu", True),
    ("starcoder2-3b prefill", 2, PROMPT, MAX_LEN, 3072, 12288, 24, 2, 128, "layernorm",
     True, False, "gelu", True),
    ("minitron-4b decode", ZOO_ROWS, 1, 64, 3072, 9216, 24, 8, 128, "layernorm", False,
     False, "relu", True),
    ("minitron-4b 32 rows", 32, 1, 64, 3072, 9216, 24, 8, 128, "layernorm", False, False,
     "relu", True),
    ("command-r-plus-104b smoke", 8, 4, 64, 128, 256, 8, 2, 16, "layernorm", False, True,
     "silu", True),
]


def check_zoo_head(d, v, tied, r, seed):
    """The head at (D, V) (``tied``: the table transposed) against its plain
    version on R rows."""
    from repro_torch.kernels.draft_decode import head, head_ref

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((r, d), generator=g, device="cuda")
    fn = {"scale": 1.0 + 0.1 * torch.randn(d, generator=g, device="cuda"),
          "bias": 0.1 * torch.randn(d, generator=g, device="cuda")}
    w = (0.02 * torch.randn((v, d), generator=g, device="cuda")).T if tied else \
        torch.randn((d, v), generator=g, device="cuda") / math.sqrt(d)
    got = head(x, fn, w, norm="layernorm", eps=1e-5)
    want = head_ref(x, fn, w, norm="layernorm", eps=1e-5)
    err, scale = float((got - want).abs().max()), max(1.0, float(want.abs().max()))
    print(f"head D={d} V={v} tied={tied} R={r}: max abs err {err:.3e} (limit "
          f"{PROJ_TOL * scale:.1e})")
    if not math.isfinite(err) or err > PROJ_TOL * scale:
        fail(f"head kernel disagrees with its plain version at ({d}, {v}): {err}")
    return err


def zoo_kernel_gates():
    """Each kernel against its plain version at the zoo's shapes: the draft
    kernels at ZOO_DRAFT_CASES (post_attn's up and down stream their slices
    in stages there), the head at starcoder2-3b's tied (3072, 49152) and
    minitron-4b's untied (3072, 256000), ws_step and ws_step_rows at V =
    49152 (the serve's step) and 262144 (gemma3-1b's vocabulary), flash_attn
    at starcoder2-3b's refine shape and gemma3-1b's head_dim 256 with its
    512-token window in both masks."""
    draft = [check_draft_kernels(c, 50 + i) for i, c in enumerate(ZOO_DRAFT_CASES)]
    errs = {k: max(e[k]["abs"] for e in draft) for k in DRAFT_KERNELS}
    errs["head"] = max(errs["head"], check_zoo_head(3072, 49152, True, ZOO_ROWS, 60),
                       check_zoo_head(3072, 256000, False, ZOO_ROWS, 61),
                       check_zoo_head(3072, 49152, True, 32, 62))
    ws = [check_ws_step(ZOO_ROWS * SEQ, 49152, 1.0, 63), check_ws_step(8, 262144, 0.7, 64)]
    rows = [check_ws_step_rows(ZOO_ROWS, SEQ, 49152, 65), check_ws_step_rows(2, 8, 262144, 66)]
    flash = [check_flash(ZOO_ROWS, SEQ, 24, 2, 128, False, None, 67),
             check_flash(ZOO_ROWS, SEQ, 24, 2, 128, True, None, 68),
             check_flash(4, 1024, 4, 1, 256, False, 512, 69),
             check_flash(4, 1024, 4, 1, 256, True, 512, 70),
             check_flash(2, 100, 8, 2, 16, True, None, 71)]
    errs.update({"ws_step": max(c["max_abs_err"] for c in ws),
                 "ws_step_rows": max(c["max_abs_err"] for c in rows),
                 "flash_attn": max(flash)})
    return errs


def zoo_measure():
    """Device times at the zoo's shapes beside the plain versions, the
    library calls and the bounds: ws_step at the starcoder2-3b serve's step
    (2048 rows x 49152), flash_attn at its refine (8 x 256, 24 heads, kv 2,
    head_dim 128) and at gemma3-1b's local layer (4 x 1024, 4 heads, kv 1,
    head_dim 256, window 512), the draft kernels at its decode (R = 8, T =
    271, three weight sets cycled: each is 384 MB, every read is cold; the
    tied head 3072 x 49152)."""
    res = {"ws_step": measure_ws_step(ZOO_ROWS * SEQ, 49152, plain_n=2),
           "flash_attn": measure_flash(ZOO_ROWS, SEQ, 24, 128, kh=2),
           "flash_attn_hd256": measure_flash(4, 1024, 4, 256, kh=1, window=512)}
    res.update(measure_draft_kernels(ZOO_DRAFT_CASES[0], vocab=49152, n_sets=3, tied=True,
                                     cold_head=False))
    return res


def zoo_path():
    """starcoder2-3b at its published widths (float32, seed 0) served through
    ``WarmStartServer`` at ZOO_ROWS x SEQ, drafted by the same config as a
    causal decoder (seed 1) through the draft kernels: the NFE guarantee,
    exact launch counts a serve, batched prefill == token scan, graph ==
    eager (a serve, bitwise), the full-width logits against the CPU; draft,
    flow and per-NFE time, samples/s, the draft cost ratio, peak memory and
    the busy share (a profiled serve)."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core.guarantees import warm_nfe
    from repro_torch.core.paths import WarmStartPath
    from repro_torch.drafting import ARDraftEngine, TransformerDraftAdapter
    from repro_torch.kernels import launches
    from repro_torch.kernels.ws_step import make_ws_step_fn
    from repro_torch.models import Model
    from repro_torch.serving import WarmStartServer

    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(ZOO_ARCH).replace(dtype="float32")
    model = Model(cfg, device="cuda", seed=0)
    engine = ARDraftEngine(TransformerDraftAdapter(
        model=Model(cfg, device="cuda", seed=DRAFT_SEED), decode_impl="kernel"),
        max_len=MAX_LEN)
    n_params = sum(p.numel() for p in model.parameters())
    check_prefill_equals_scan(engine, rows=ZOO_ROWS)
    prompt = draft_prompt(ZOO_ROWS, cfg.vocab_size)
    path = WarmStartPath(t0=T0)
    server = WarmStartServer(
        flow_model=model, flow_cfg=cfg,
        draft_generate=lambda rng, num: engine.generate_rows(prng.split(rng, num), SEQ, prompt),
        path=path, cold_nfe=COLD_NFE, step_fn=make_ws_step_fn(path), device="cuda")
    nfe = warm_nfe(COLD_NFE, T0)
    layers, steps = cfg.num_layers, (SEQ - 1) * cfg.num_layers
    per_serve = {"ws_step": nfe, "flash_attn": nfe * layers, "qkv_rope": steps,
                 "attn_cached": steps, "post_attn": steps, "head": SEQ - 1}
    prefill = {"qkv_rope": layers, "attn_cached": layers, "post_attn": layers, "head": 1}

    launches.clear()
    reports, last = [], None
    for i in range(3):
        before = dict(launches)
        x, rep = server.serve(prng.key(300 + i), ZOO_ROWS)
        for name, n in per_serve.items():
            want = n * 2 + prefill.get(name, 0) if i == 0 else n   # capture warm-ups
            if launches[name] - before.get(name, 0) != want:
                fail(f"{cfg.name} serve {i}: {name} launched "
                     f"{launches[name] - before.get(name, 0)} times, expected {want}")
        if not (rep["nfe"] == rep["backbone_evals"] == nfe):
            fail(f"{cfg.name} serve {i}: nfe {rep['nfe']} backbone_evals "
                 f"{rep['backbone_evals']}, expected {nfe}")
        if x.shape != (ZOO_ROWS, SEQ) or int(x.min()) < 0 or int(x.max()) >= cfg.vocab_size:
            fail(f"{cfg.name} serve {i}: tokens {tuple(x.shape)} outside [0, {cfg.vocab_size})")
        reports.append(rep)
        last = x
    counts = dict(launches)
    for name in per_serve:
        if counts.get(name, 0) <= 0:
            fail(f"{name} was not launched on the {cfg.name} path")
    caps = (engine.graphs.captures, server.graphs.captures)
    if caps != (1, 1):
        fail(f"{cfg.name}: 3 serves must capture the decode and the refine once each: {caps}")
    print(f"zoo path: {cfg.name} ({n_params / 1e9:.3f}B params, float32) x 3 serves of "
          f"{ZOO_ROWS} x {SEQ}, drafted by {cfg.name} as a causal decoder (seed "
          f"{DRAFT_SEED}), t0={T0}, cold_nfe={COLD_NFE}: nfe {nfe} per serve, guarantee gate "
          f"passed, launches {counts} (per serve {per_serve}; the first serve twice that and "
          f"{prefill})")

    # graph == eager: a serve (new key: the decode's and the refine's replays) against
    # the same serve as eager launches, tokens bitwise
    rng = prng.key(310)
    x, _ = server.serve(rng, ZOO_ROWS)
    want, t_draft, t_flow = serve_eager(server, engine, rng, prompt, num=ZOO_ROWS)
    torch.cuda.synchronize()
    vs_eager = {"serve_differ": int((x != want).sum()),
                "eager_draft_ms": t_draft * 1e3, "eager_flow_ms": t_flow * 1e3,
                "captures": [engine.graphs.captures, server.graphs.captures]}
    print(f"{cfg.name} graphs vs eager launches: {vs_eager}")
    if vs_eager["serve_differ"] or (engine.graphs.captures, server.graphs.captures) != caps:
        fail(f"{cfg.name}: the serve's graphs disagree with their eager launches: {vs_eager}")

    logits = check_full_width_logits(model, last[:1, :ZOO_LOGIT_TOKENS],
                                     torch.full((1,), T0, device="cuda"))
    profile = _profile(lambda: server.serve(prng.key(321), ZOO_ROWS), f"{cfg.name} serve")
    steady = reports[1:]
    res = {
        "config": cfg.name, "dtype": cfg.dtype, "params": n_params, "rows": ZOO_ROWS,
        "seq_len": SEQ, "t0": T0, "cold_nfe": COLD_NFE, "nfe": nfe,
        "draft": {"config": cfg.name + " (causal decoder)", "seed": DRAFT_SEED,
                  "prompt": PROMPT, "max_len": MAX_LEN, "decode_steps": SEQ - 1,
                  "stats": engine.stats.as_dict()},
        "warmup_draft_ms": reports[0]["draft_time_s"] * 1e3,
        "warmup_flow_ms": reports[0]["flow_time_s"] * 1e3,
        "draft_ms": statistics.median(r["draft_time_s"] for r in steady) * 1e3,
        "flow_ms": statistics.median(r["flow_time_s"] for r in steady) * 1e3,
        "per_nfe_ms": statistics.median(r["per_nfe_s"] for r in steady) * 1e3,
        "samples_per_s": statistics.median(
            ZOO_ROWS / (r["draft_time_s"] + r["flow_time_s"]) for r in steady),
        "draft_cost_ratio": statistics.median(
            r["speedup_report"].draft_cost_ratio for r in steady),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "busy_share": profile.get("busy_share"), "profile": profile,
        "launches_per_serve": per_serve,
        "vs_eager": vs_eager,
        "logits_vs_cpu": logits, "capture_ms": {"decode": engine.graphs.stats()["capture_ms"],
                                               "refine": server.graphs.stats()["capture_ms"]},
    }
    del model, engine, server
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_start
    print(f"{cfg.name} serve ({ZOO_ROWS} x {SEQ}, {nfe} NFE): draft {res['draft_ms']:.1f} ms, "
          f"flow {res['flow_ms']:.1f} ms ({res['per_nfe_ms']:.1f} ms an NFE), "
          f"{res['samples_per_s']:.2f} samples/s, draft cost ratio "
          f"{res['draft_cost_ratio']:.3f}, peak memory {res['peak_memory_gb']:.1f} GiB; the "
          f"phase took {res['seconds']:.1f} s")
    return res, counts


def check_gemma_logits():
    """gemma3-1b at its published widths (float32, seed 0): dfm_apply on the
    card (flash_attn at head_dim 256 in each of the 26 layers; the local
    ones under the 512-token window) against the CPU plain path at 1 x
    GEMMA_TOKENS tokens."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launches
    from repro_torch.models import Model

    cfg = get_config("gemma3-1b").replace(dtype="float32")
    model = Model(cfg, device="cuda", seed=0)
    toks = torch.randint(0, cfg.vocab_size, (1, GEMMA_TOKENS), dtype=torch.int32,
                         generator=torch.Generator(device="cuda").manual_seed(5), device="cuda")
    before = launches["flash_attn"]
    res = check_full_width_logits(model, toks, torch.full((1,), T0, device="cuda"))
    res["flash_attn_launches"] = launches["flash_attn"] - before
    if res["flash_attn_launches"] != cfg.num_layers:
        fail(f"gemma3-1b's dfm_apply launched flash_attn {res['flash_attn_launches']} times, "
             f"expected {cfg.num_layers}")
    del model
    torch.cuda.empty_cache()
    return res


def check_zoo_smoke_against_cpu(archs=SMOKE_ARCHS):
    """The archs' smoke configs (default: the dense four) served small (4 x
    32 tokens, t0 = 0.8, cold_nfe = 16) on the card and on the CPU, same
    seeded weights, keys and prompt, drafted by the arch as a causal decoder
    through the engine's ``auto`` choice (the draft kernels for the dense
    three, the plain path for gemma3-1b and the recurrent family, as JAX's
    ``auto`` picks): the tokens must be equal."""
    from repro_torch import prng
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.paths import WarmStartPath
    from repro_torch.drafting import ARDraftEngine, TransformerDraftAdapter
    from repro_torch.kernels import launches
    from repro_torch.kernels.draft_decode import draft_decode_supported
    from repro_torch.kernels.ws_step import make_ws_step_fn
    from repro_torch.models import Model
    from repro_torch.serving import WarmStartServer

    res = {}
    for arch in archs:
        cfg = get_smoke_config(arch)
        prompt = draft_prompt(4, cfg.vocab_size)[:, :4]
        out, kernel_path = {}, {}
        for device in ("cuda", "cpu"):
            path = WarmStartPath(t0=T0)
            flow = Model(cfg, device="cpu", seed=3).to(device)
            adapter = TransformerDraftAdapter(model=Model(cfg, device="cpu", seed=4).to(device))
            eng = ARDraftEngine(adapter, max_len=4 + 32 - 1)
            server = WarmStartServer(
                flow_model=flow, flow_cfg=cfg, path=path, cold_nfe=16,
                draft_generate=lambda rng, num, eng=eng: eng.generate_rows(
                    prng.split(rng, num), 32, prompt),
                step_fn=make_ws_step_fn(path, device=device), device=device)
            before = launches["qkv_rope"]
            out[device] = server.serve(prng.key(5), 4)[0].cpu()
            kernel_path[device] = adapter.exact_batched_prefill
            ran = launches["qkv_rope"] > before
            if device == "cuda" and ran != adapter.exact_batched_prefill:
                fail(f"{arch}: the draft kernels ran {launches['qkv_rope'] - before} times "
                     f"with the kernel path {adapter.exact_batched_prefill}")
        diff = int((out["cuda"] != out["cpu"]).sum())
        res[arch] = {"differ": diff, "draft_kernels": kernel_path["cuda"]}
        if kernel_path["cuda"] != draft_decode_supported(cfg):
            fail(f"{arch}: the draft engine's auto choice is {kernel_path['cuda']}")
    print(f"smoke configs served on the card vs the CPU (4 x 32 tokens, 4 steps; "
          f"tokens differing, draft on the kernels): {res}")
    if any(r["differ"] for r in res.values()):
        fail(f"a zoo smoke config's serve on the card disagrees with the CPU: {res}")
    return res


# -- the recurrent family ------------------------------------------------------------

REC_ARCH, XLSTM_ARCH = "zamba2-2.7b", "xlstm-1.3b"      # both at their published widths
REC_SMOKE_ARCHS = (REC_ARCH, XLSTM_ARCH)
# rows a serve: xlstm-1.3b's draft at 8 rows moves 5.6 GB of mLSTM state a decode
# step (9.3 s a draft) and its eager yardstick took 31 s a serve, so it serves 4
REC_ROWS = {REC_ARCH: 8, XLSTM_ARCH: 4}
# layers a serve: zamba2-2.7b at 2 of its 9 groups of 6, at the published widths: at
# full depth its serves took 107.6 s of the phase's 235.4 s and of a 1099.1 s run
# (NVIDIA H100 80GB HBM3, 700 W), at 18 layers 31.7 s, and 32.4 / 34.7 s in the runs that
# first held the VLM phase (941.0 s without it, 1106.9 s with it on a slower host): cut
# to 12 to keep the whole script within its time. At 16
# layers xlstm-1.3b's logits left the 1e-3 gate against the CPU (5.7e-3 of 4.29: its
# out projections' init scales with 1/sqrt(layers), and its normaliser amplifies the
# rounding), so it keeps its 48. The training phase runs both at full depth
REC_LAYERS = {REC_ARCH: 12, XLSTM_ARCH: 48}
REC_HEAD_DIM = 80                              # zamba2-2.7b's shared attention: 32 heads of 80


def rec_kernel_gates():
    """The kernels at the recurrent family's shapes against their plain
    versions: flash_attn at head_dim 80 (zamba2-2.7b's refine, bidirectional
    and causal; a ragged causal window) and at the smoke config's head_dim
    32; ws_step at the serves' (8 x 256, 32000) and (4 x 256, 50304)."""
    rows = REC_ROWS[REC_ARCH]
    flash = [check_flash(rows, SEQ, 32, 32, REC_HEAD_DIM, False, None, 80),
             check_flash(rows, SEQ, 32, 32, REC_HEAD_DIM, True, None, 81),
             check_flash(2, 77, 4, 2, REC_HEAD_DIM, True, 20, 82),
             check_flash(4, 32, 4, 4, 32, False, None, 83)]
    ws = [check_ws_step(rows * SEQ, 32000, 1.0, 84),
          check_ws_step(REC_ROWS[XLSTM_ARCH] * SEQ, 50304, 1.0, 85)]
    return {"flash_attn": max(flash), "ws_step": max(c["max_abs_err"] for c in ws),
            "ws_checks": ws}


def rec_measure():
    """Device times at the recurrent serves' shapes beside the plain versions,
    SDPA and the bounds: flash_attn at zamba2-2.7b's refine (8 x 256, 32
    heads of 80), ws_step at its (2048, 32000) and xlstm-1.3b's (1024, 50304)."""
    rows = REC_ROWS[REC_ARCH]
    return {"flash_attn": measure_flash(rows, SEQ, 32, REC_HEAD_DIM),
            "ws_step_v32000": measure_ws_step(rows * SEQ, 32000, plain_n=2),
            "ws_step_v50304": measure_ws_step(REC_ROWS[XLSTM_ARCH] * SEQ, 50304, plain_n=2)}


def check_recurrent_vs_eager(server, engine, prompt, rng, served, warm_draft, warm_x):
    """The first serve's graphs against their capture warm-ups (each key's
    eager launches on that serve's inputs), bitwise: the refine's replay
    against its warm-up, and R7 on the card: the decode replayed for that
    serve's draft keys with the prefix now reused against the warm-up's
    decode, which followed a fresh prefill. No new capture."""
    from repro_torch import prng

    caps = (engine.graphs.captures, server.graphs.captures)
    keys = prng.split(prng.split(rng, 2)[0], prompt.shape[0])
    reused = engine.generate_rows(keys, SEQ, prompt)
    torch.cuda.synchronize()
    res = {"serve_differ": int((served != warm_x).sum()),
           "draft_differ": int((reused != warm_draft).sum()),
           "new_captures": [engine.graphs.captures - caps[0], server.graphs.captures - caps[1]],
           "stats": engine.stats.as_dict()}
    print(f"{engine.adapter.model.cfg.name} first serve's refine (graph) vs its eager warm-up, "
          f"and the draft replayed with the prefix reused vs the warm-up's eager decode after "
          f"a fresh prefill (bitwise): {res}")
    if res["serve_differ"] or res["draft_differ"] or any(res["new_captures"]):
        fail(f"{engine.adapter.model.cfg.name}: the serve's graphs or its reused prefix "
             f"differ from the eager launches after a fresh prefill: {res}")
    return res


def recurrent_serve(arch, profile=True):
    """``arch`` at its published widths and REC_LAYERS layers (float32, seed
    0) served through ``WarmStartServer`` at REC_ROWS x SEQ, t0 = 0.8, cold_nfe = 64 (13 NFE),
    drafted by the same config as a causal decoder (seed 1; the plain decode
    path, prompt prefilled by scan, the decode one graph replay). Two
    serves: the first captures the decode and the refine, the second
    replays them with the prefix reused. Gates: the NFE guarantee and exact
    launches a serve (``ws_step`` 13, ``flash_attn`` 13 x the zshared
    layers; the first serve twice that), one capture per key, the first
    serve's graphs == their eager warm-ups and its draft replayed with the
    prefix reused == the warm-up's fresh decode (:func:`check_recurrent_vs_eager`;
    a serve of eager launches costs ~24 s here), the full-width logits at 1
    x 64 against the CPU. Reports draft, flow and
    per-NFE time, samples/s, the draft cost ratio, peak memory, the capture
    times and (``profile``) a serve profiled with its draft given (the flow
    stage: the draft's graph holds ~740k launches, more than the profile's
    trace is worth reading)."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core.guarantees import warm_nfe
    from repro_torch.core.paths import WarmStartPath
    from repro_torch.drafting import ARDraftEngine, TransformerDraftAdapter
    from repro_torch.kernels import launches
    from repro_torch.kernels.ws_step import make_ws_step_fn
    from repro_torch.models import Model
    from repro_torch.models.model import layer_kinds
    from repro_torch.serving import WarmStartServer

    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rows = REC_ROWS[arch]
    cfg = get_config(arch).replace(dtype="float32", num_layers=REC_LAYERS[arch])
    model = Model(cfg, device="cuda", seed=0)
    adapter = TransformerDraftAdapter(model=Model(cfg, device="cuda", seed=DRAFT_SEED))
    engine = ARDraftEngine(adapter, max_len=MAX_LEN)
    if adapter.exact_batched_prefill or engine.prefill_mode != "scan":
        fail(f"{arch}: the draft must take the plain path with a scanned prefill")
    n_params = sum(p.numel() for p in model.parameters())
    prompt = draft_prompt(rows, cfg.vocab_size)
    path = WarmStartPath(t0=T0)
    server = WarmStartServer(
        flow_model=model, flow_cfg=cfg,
        draft_generate=lambda rng, num: engine.generate_rows(prng.split(rng, num), SEQ, prompt),
        path=path, cold_nfe=COLD_NFE, step_fn=make_ws_step_fn(path), device="cuda")
    nfe = warm_nfe(COLD_NFE, T0)
    shared = sum(k == "zshared" for k in layer_kinds(cfg))
    per_serve = {"ws_step": nfe, **({"flash_attn": nfe * shared} if shared else {})}

    launches.clear()
    reports, outs = [], []
    for i in range(2):
        before = dict(launches)
        served, rep = server.serve(prng.key(400 + i), rows)
        if i == 0:     # the eager warm-ups of the two captures, on this serve's inputs
            warm_draft, warm_x = engine.graphs.last_warmup, server.graphs.last_warmup
        grew = grown(before)
        want = {k: 2 * n if i == 0 else n for k, n in per_serve.items()}  # capture warm-ups
        if grew != want:
            fail(f"{arch} serve {i}: launches {grew}, expected {want}")
        if not (rep["nfe"] == rep["backbone_evals"] == nfe):
            fail(f"{arch} serve {i}: nfe {rep['nfe']} backbone_evals {rep['backbone_evals']}")
        if served.shape != (rows, SEQ) or int(served.min()) < 0 \
                or int(served.max()) >= cfg.vocab_size:
            fail(f"{arch} serve {i}: tokens {tuple(served.shape)} outside [0, {cfg.vocab_size})")
        reports.append(rep)
        outs.append(served)
    counts = dict(launches)
    caps = (engine.graphs.captures, server.graphs.captures)
    if caps != (1, 1) or engine.stats.prefill_reuses != 1:
        fail(f"{arch}: two serves must capture the decode and the refine once each and reuse "
             f"the prefix once: captures {caps}, {engine.stats.as_dict()}")
    print(f"recurrent path: {arch} ({n_params / 1e9:.3f}B params, float32) x 2 serves of "
          f"{rows} x {SEQ}, drafted by {arch} as a causal decoder (seed {DRAFT_SEED}), "
          f"t0={T0}, cold_nfe={COLD_NFE}: nfe {nfe} per serve, guarantee gate passed, launches "
          f"{counts} (per serve {per_serve}, the first twice that); capture ms (warm-up and "
          f"capture): decode {engine.graphs.stats()['capture_ms']}, refine "
          f"{server.graphs.stats()['capture_ms']}")

    vs_eager = check_recurrent_vs_eager(server, engine, prompt, prng.key(400), outs[0],
                                        warm_draft, warm_x)
    logits = check_full_width_logits(model, served[:1, :ZOO_LOGIT_TOKENS],
                                     torch.full((1,), T0, device="cuda"))
    prof = {"device_ms": None}
    if profile:
        holder = {}
        server.draft_generate = lambda rng, num: warm_draft

        def run():
            holder["rep"] = server.serve(prng.key(421), rows)[1]

        prof = _profile(run, f"{arch} serve with its draft given (the flow stage)")
        prof["flow_ms"] = holder["rep"]["flow_time_s"] * 1e3
    steady = reports[1]
    res = {
        "config": arch, "dtype": cfg.dtype, "params": n_params, "rows": rows,
        "seq_len": SEQ, "t0": T0, "cold_nfe": COLD_NFE, "nfe": nfe,
        "draft": {"config": arch + " (causal decoder)", "seed": DRAFT_SEED, "prompt": PROMPT,
                  "max_len": MAX_LEN, "decode_steps": SEQ - 1, "prefill": engine.prefill_mode,
                  "stats": engine.stats.as_dict()},
        "warmup_draft_ms": reports[0]["draft_time_s"] * 1e3,
        "warmup_flow_ms": reports[0]["flow_time_s"] * 1e3,
        "draft_ms": steady["draft_time_s"] * 1e3,
        "flow_ms": steady["flow_time_s"] * 1e3,
        "per_nfe_ms": steady["per_nfe_s"] * 1e3,
        "samples_per_s": rows / (steady["draft_time_s"] + steady["flow_time_s"]),
        "draft_cost_ratio": steady["speedup_report"].draft_cost_ratio,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "flow_busy_share": prof.get("busy_share"), "flow_profile": prof,
        "launches_per_serve": per_serve, "vs_eager": vs_eager, "logits_vs_cpu": logits,
        "capture_ms": {"decode": engine.graphs.stats()["capture_ms"],
                       "refine": server.graphs.stats()["capture_ms"]},
    }
    del model, adapter, engine, server
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_start
    print(f"{arch} serve ({rows} x {SEQ}, {nfe} NFE): draft {res['draft_ms']:.1f} ms, "
          f"flow {res['flow_ms']:.1f} ms ({res['per_nfe_ms']:.1f} ms an NFE), "
          f"{res['samples_per_s']:.2f} samples/s, draft cost ratio "
          f"{res['draft_cost_ratio']:.3f}, peak memory {res['peak_memory_gb']:.1f} GiB; "
          f"{res['seconds']:.1f} s")
    return res, counts


def recurrent_path():
    """The recurrent family's phase: the kernels at its shapes, zamba2-2.7b
    served (profiled), xlstm-1.3b served, both smoke configs card == CPU.
    Returns (the {"recurrent": ...} record, zamba2-2.7b's serve launches)."""
    t0 = time.perf_counter()
    res = {"kernel_errors": rec_kernel_gates(), "kernels": rec_measure()}
    res[REC_ARCH], counts = recurrent_serve(REC_ARCH)
    res[XLSTM_ARCH], xlstm_counts = recurrent_serve(XLSTM_ARCH, profile=False)
    res["smoke_vs_cpu"] = check_zoo_smoke_against_cpu(REC_SMOKE_ARCHS)
    res["phase_seconds"] = time.perf_counter() - t0
    counts = {k: counts.get(k, 0) + xlstm_counts.get(k, 0) for k in set(counts) | set(xlstm_counts)}
    print(f"recurrent phases (kernel gates, measurements, {REC_ARCH} and {XLSTM_ARCH} serves, "
          f"smoke configs): {res['phase_seconds']:.1f} s")
    return res, counts


# -- the encoder-decoder family ------------------------------------------------------

ENCDEC_ARCH = "whisper-medium"       # at its published widths
ENCDEC_ROWS = 8
# its serves at a sixth of its depth: 4 of its 24 encoder and 4 of its 24 decoder
# layers. At full depth they took 94.5 s of a 941.0 s run (NVIDIA H100 80GB HBM3, 700 W;
# the eager draft 12 045 ms a serve), at 8 + 8 39.2 s, and 43.3 s in a 1106.9 s run on a
# slower host: cut to make room for the VLM phase. The training phase runs it at full
# depth
ENCDEC_LAYERS = ENCDEC_ENCODER_LAYERS = 4
ENCDEC_FRAMES_SEED = 7               # the frames: 0.1 N(0, 1) from numpy, copied to the card
ENCDEC_SMOKE_SEQ = 24                # the smoke config served 2 x 24 on the card and the CPU


def encdec_launches(cfg, nfe, seq=SEQ):
    """Kernel launches of one whisper serve: (the refine's, the draft's). A
    NFE runs flash_attn in every encoder layer, every decoder self
    attention and every cross attention, and one ws_step; the draft of
    ``seq`` tokens (``ar_generate`` at seq_len ``seq + 1``, reference fault
    R8) runs the encoder and the cross attention at its prefill, then the
    cross attention of each of its ``seq`` decode steps (the self attention
    over the cache is plain torch)."""
    per_nfe = cfg.num_encoder_layers + 2 * cfg.num_layers
    refine = {"flash_attn": nfe * per_nfe, "ws_step": nfe}
    draft = {"flash_attn": cfg.num_encoder_layers + cfg.num_layers * (1 + seq)}
    return refine, draft


def encdec_serve_launches(refine, draft, first):
    """A whisper serve's launches: its refine's and its draft's, each one
    graph replay, and each twice on the first serve (the capture's warm-up,
    then the replay)."""
    k = 2 if first else 1
    return {n: k * (refine.get(n, 0) + draft.get(n, 0)) for n in sorted({*refine, *draft})}


def encdec_frames(cfg, rows, device="cuda"):
    import numpy as np

    rng = np.random.default_rng(ENCDEC_FRAMES_SEED)
    frames = 0.1 * rng.standard_normal((rows, cfg.num_audio_frames, cfg.d_model))
    return torch.from_numpy(frames.astype(np.float32)).to(device)


def encdec_kernel_gates():
    """The kernels at whisper-medium's shapes against their plain versions:
    flash_attn over its 1500 frames (23 full 64-key tiles and a 28-key
    tail), bidirectional 1500 x 1500 (the encoder), 256 queries x 1500 keys
    (the refine's cross attention) and 1 x 1500 (the draft's decode: one
    live query row in a tile), and at the smoke config's (2, 24, 4, 32) and
    (2, 24, T = 32, 4, 32); ws_step at the serve's (2048, 51 865)."""
    rows, frames = ENCDEC_ROWS, 1500
    flash = [check_flash(rows, frames, 16, 16, 64, False, None, 90),
             check_flash(rows, SEQ, 16, 16, 64, False, None, 91, t=frames),
             check_flash(rows, 1, 16, 16, 64, False, None, 92, t=frames),
             check_flash(2, ENCDEC_SMOKE_SEQ, 4, 4, 32, False, None, 93),
             check_flash(2, ENCDEC_SMOKE_SEQ, 4, 4, 32, False, None, 94, t=32)]
    ws = [check_ws_step(rows * SEQ, 51865, 1.0, 95)]
    return {"flash_attn": max(flash), "ws_step": max(c["max_abs_err"] for c in ws),
            "ws_checks": ws}


def encdec_measure():
    """Device times at whisper-medium's serve shapes beside the plain
    versions, SDPA and the bounds: flash_attn at the encoder's (8, 1500, 16,
    64), the cross attention's (8, 256, T = 1500) and the decode's (8, 1,
    T = 1500); ws_step at (2048, 51 865)."""
    rows, frames = ENCDEC_ROWS, 1500
    return {"flash_attn_encoder": measure_flash(rows, frames, 16, 64),
            "flash_attn_cross": measure_flash(rows, SEQ, 16, 64, t=frames),
            "flash_attn_decode": measure_flash(rows, 1, 16, 64, t=frames),
            "ws_step_v51865": measure_ws_step(rows * SEQ, 51865, plain_n=2)}


def encdec_nfe_shares(model, frames, x, t):
    """One eager NFE (``dfm_apply`` at the serve's shape), its encoder and its
    cross k/v apart: device ms and shares under the profiler, and the same
    three timed by CUDA events. A profile is complete when it holds every
    flash_attn launch (encoder + 2 x decoder layers an NFE, the encoder
    layers the encoder) and both cross GEMMs of each decoder layer; the
    profiler has been seen to drop a window's first kernels, so the shares
    by events stand beside them."""
    cfg = model.cfg
    fns = {"nfe": lambda: model.dfm_apply(x, t, extras={"frames": frames}),
           "encoder": lambda: model.encode(frames)}
    want = {"nfe": ("flash_attn", cfg.num_encoder_layers + 2 * cfg.num_layers),
            "encoder": ("flash_attn", cfg.num_encoder_layers),
            "cross_kv": ("matmul", 2 * cfg.num_layers)}
    with torch.inference_mode():
        enc = model.encode(frames)
        fns["cross_kv"] = lambda: model._layer_kvs(enc)
        parts = {k: _profile(lambda fn=fn: (fn(), torch.cuda.synchronize()),
                             f"whisper-medium {k} (eager)") for k, fn in fns.items()}
        events = {k: time_ms(fn, reps=3, inner=2) for k, fn in fns.items()}
    ms = {k: p.get("device_ms") for k, p in parts.items()}
    complete = {k: parts[k].get("by_kind_launches", {}).get(kind) == n
                for k, (kind, n) in want.items()}
    res = {"device_ms": ms, "profile_complete": complete, "event_ms": events,
           "encoder_share_events": events["encoder"] / events["nfe"],
           "cross_kv_share_events": events["cross_kv"] / events["nfe"]}
    if all(v is not None for v in ms.values()):
        res["encoder_share"] = ms["encoder"] / ms["nfe"]
        res["cross_kv_share"] = ms["cross_kv"] / ms["nfe"]
    print(f"whisper-medium NFE, profiler device ms {ms} (complete: {complete}): encoder share "
          f"{res.get('encoder_share')}, cross k/v share {res.get('cross_kv_share')}; by CUDA "
          f"events ms {events}: encoder share {res['encoder_share_events']:.4f}, cross k/v "
          f"share {res['cross_kv_share_events']:.4f}")
    return res


def check_encdec_logits(model, frames, tokens, t):
    """whisper-medium's dfm_apply at 1 x len(tokens) with all 1500 frames
    through the kernels on the card against the plain CPU path on the same
    weights (a copy of the model moved to the host), within 1e-3 x max(1,
    max |logit|)."""
    import copy

    ref_model = copy.deepcopy(model).to("cpu")
    with torch.inference_mode():
        got = model.dfm_apply(tokens, t, extras={"frames": frames}).cpu()
        want = ref_model.dfm_apply(tokens.cpu(), t.cpu(), extras={"frames": frames.cpu()})
    del ref_model
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    print(f"full-width dfm_apply ({model.cfg.name}), {tokens.shape[0]} x {tokens.shape[1]} "
          f"tokens, {frames.shape[1]} frames, card kernels vs CPU plain: max abs err {err:.3e} "
          f"(logits up to {scale:.2f}; limit 1e-3 relative)")
    if not math.isfinite(err) or err > 1e-3 * max(1.0, scale):
        fail(f"full-width logits of {model.cfg.name} disagree with the plain path: {err}")
    return {"config": model.cfg.name, "tokens": list(tokens.shape),
            "frames": frames.shape[1], "max_abs_err": err, "max_abs_logit": scale}


def check_encdec_smoke_against_cpu():
    """whisper-medium's smoke config served 2 x ENCDEC_SMOKE_SEQ (t0 = 0.8,
    cold_nfe = 16) on the card and on the CPU, same seeded weights, frames
    and key, drafted by ``ar_generate`` (seq_len + 1: R8) on a second smoke
    model: the tokens must be equal."""
    from repro_torch import prng
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.paths import WarmStartPath
    from repro_torch.kernels.ws_step import make_ws_step_fn
    from repro_torch.models import Conditioned, EncDecModel
    from repro_torch.serving import WarmStartServer, ar_generate

    cfg = get_smoke_config(ENCDEC_ARCH)
    frames = encdec_frames(cfg, 2, device="cpu")
    out = {}
    for device in ("cuda", "cpu"):
        path = WarmStartPath(t0=T0)
        flow = EncDecModel(cfg, device="cpu", seed=3).to(device)
        drafter = EncDecModel(cfg, device="cpu", seed=4).to(device)
        fr = frames.to(device)
        server = WarmStartServer(
            flow_model=Conditioned(flow, {"frames": fr}), flow_cfg=cfg, path=path,
            cold_nfe=16, step_fn=make_ws_step_fn(path, device=device), device=device,
            draft_generate=lambda rng, num, drafter=drafter, fr=fr: ar_generate(
                drafter, cfg, rng, batch_size=num, seq_len=ENCDEC_SMOKE_SEQ + 1,
                extras={"frames": fr}))
        out[device] = server.serve(prng.key(5), 2)[0].cpu()
    diff = int((out["cuda"] != out["cpu"]).sum())
    print(f"{cfg.name} served on the card vs the CPU (2 x {ENCDEC_SMOKE_SEQ} tokens, "
          f"{cfg.num_audio_frames} frames, 4 steps): {diff} tokens differ")
    if diff or out["cuda"].shape != (2, ENCDEC_SMOKE_SEQ):
        fail(f"{cfg.name}'s serve on the card disagrees with the CPU: {diff} tokens, "
             f"shape {tuple(out['cuda'].shape)}")
    return {"differ": diff, "shape": list(out["cuda"].shape)}


class LastDraft:
    """A draft_generate that keeps its last tokens (the yardstick's input)."""

    def __init__(self, fn):
        self.fn, self.last = fn, None

    def __call__(self, rng, num):
        self.last = self.fn(rng, num)
        return self.last


def encdec_serve():
    """whisper-medium at its published widths, ENCDEC_ENCODER_LAYERS +
    ENCDEC_LAYERS of its 24 + 24 layers (float32, seed 0)
    served through ``WarmStartServer`` on ``Conditioned(model, {"frames":
    frames})``, ENCDEC_ROWS x SEQ tokens over 1500 frames each, t0 = 0.8,
    cold_nfe = 64 (13 NFE), drafted by ``ar_generate`` on the same config
    (seed 1) with the same frames at seq_len SEQ + 1 (R8), one CUDA graph
    replay a draft. Two serves. Gates: the NFE guarantee, exact launches a
    serve (the refine encoder + 2 x decoder layers flash_attn and 1 ws_step
    a NFE; the draft encoder + decoder layers at its prefill and decoder
    layers in each of its SEQ decode steps; the first serve twice both, the
    captures' warm-ups), one capture of the refine and one of the draft,
    the second serve's refine replay == its eager launches on its draft and
    its draft's replay == the eager draft (``_ar_generate_eager``, the key
    split on the host) on the same key, bitwise with the same launches, the
    draft's length, the logits at 1 x 64 against the host. Reports draft,
    flow and per-NFE time, samples/s, the draft cost ratio, the eager
    draft's ms, the captures' ms, the draft graph's pool, peak memory, the
    busy shares of the flow stage (a serve with its draft given, profiled)
    and of one whole draft replay (profiled), and an NFE's encoder and
    cross k/v shares."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core.guarantees import warm_nfe
    from repro_torch.core.paths import WarmStartPath
    from repro_torch.core.sampler import refine_loop_inputs
    from repro_torch.kernels import launches
    from repro_torch.kernels.ws_step import make_ws_step_fn
    from repro_torch.models import Conditioned, EncDecModel
    from repro_torch.serving import WarmStartServer, ar_generate
    from repro_torch.serving.engine import _ar_generate_eager, ar_graphs

    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rows = ENCDEC_ROWS
    cfg = get_config(ENCDEC_ARCH).replace(dtype="float32", num_layers=ENCDEC_LAYERS,
                                          num_encoder_layers=ENCDEC_ENCODER_LAYERS)
    model = EncDecModel(cfg, device="cuda", seed=0)
    drafter = EncDecModel(cfg, device="cuda", seed=DRAFT_SEED)
    n_params = sum(p.numel() for p in model.parameters())
    frames = encdec_frames(cfg, rows)
    path = WarmStartPath(t0=T0)
    draft = LastDraft(lambda rng, num: ar_generate(
        drafter, cfg, rng, batch_size=num, seq_len=SEQ + 1, extras={"frames": frames}))
    server = WarmStartServer(
        flow_model=Conditioned(model, {"frames": frames}), flow_cfg=cfg, draft_generate=draft,
        path=path, cold_nfe=COLD_NFE, step_fn=make_ws_step_fn(path), device="cuda")
    nfe = warm_nfe(COLD_NFE, T0)
    refine, per_draft = encdec_launches(cfg, nfe)
    draft_graphs = ar_graphs(drafter)

    launches.clear()
    reports = []
    for i in range(2):
        before = dict(launches)
        rng = prng.key(500 + i)
        served, rep = server.serve(rng, rows)
        grew = grown(before)
        want = encdec_serve_launches(refine, per_draft, first=i == 0)
        if grew != want:
            fail(f"{cfg.name} serve {i}: launches {grew}, expected {want}")
        if not (rep["nfe"] == rep["backbone_evals"] == nfe):
            fail(f"{cfg.name} serve {i}: nfe {rep['nfe']} backbone_evals {rep['backbone_evals']}")
        if draft.last.shape != (rows, SEQ) or served.shape != (rows, SEQ) \
                or int(served.min()) < 0 or int(served.max()) >= cfg.vocab_size:
            fail(f"{cfg.name} serve {i}: draft {tuple(draft.last.shape)} (R8: seq_len {SEQ + 1} "
                 f"gives {SEQ}), tokens {tuple(served.shape)} in [0, {cfg.vocab_size})")
        reports.append(rep)
    counts = dict(launches)
    if server.graphs.captures != 1 or draft_graphs.captures != 1:
        fail(f"{cfg.name}: two serves must capture the refine and the draft once each: "
             f"{server.graphs.captures}, {draft_graphs.captures}")
    print(f"encdec path: {cfg.name} ({n_params / 1e9:.3f}B params, float32) x 2 serves of "
          f"{rows} x {SEQ} over {cfg.num_audio_frames} frames, drafted by ar_generate on "
          f"{cfg.name} (seed {DRAFT_SEED}, seq_len {SEQ + 1}: R8), t0={T0}, cold_nfe={COLD_NFE}: "
          f"nfe {nfe} per serve, guarantee gate passed, launches {counts} (the refine {refine}, "
          f"the draft {per_draft}, the first serve twice both); capture ms (warm-up and "
          f"capture): refine {server.graphs.stats()['capture_ms']}, draft "
          f"{draft_graphs.stats()['capture_ms']}")

    # the second serve's draft (a replay) against the eager draft on the same key
    k_draft = prng.split(rng, 2)[0]
    before = dict(launches)
    t_eager = time.perf_counter()
    eager_draft = _ar_generate_eager(drafter, cfg, k_draft, batch_size=rows, seq_len=SEQ + 1,
                                     extras={"frames": frames})
    torch.cuda.synchronize()
    draft_vs_eager = {"differ": int((draft.last != eager_draft).sum()),
                      "eager_draft_ms": (time.perf_counter() - t_eager) * 1e3,
                      "launches": grown(before), "captures": draft_graphs.captures,
                      "replays": draft_graphs.replays}
    print(f"{cfg.name} second serve's draft (graph) vs the eager draft (bitwise): "
          f"{draft_vs_eager}")
    if draft_vs_eager["differ"] or draft_vs_eager["launches"] != per_draft \
            or (draft_graphs.captures, draft_graphs.replays) != (1, 2):
        fail(f"{cfg.name}: the draft's graph disagrees with its eager launches: "
             f"{draft_vs_eager}, expected launches {per_draft}")

    # the second serve's replay against its eager launches on the same draft and keys
    k_flow = prng.split(rng, 2)[1]
    keys, ts, hs = refine_loop_inputs(k_flow, T0, 1.0 / COLD_NFE, nfe)
    t_eager = time.perf_counter()
    with torch.inference_mode():
        want = server._refine_loop_eager(keys, draft.last, ts, hs)
    torch.cuda.synchronize()
    vs_eager = {"differ": int((served != want).sum()),
                "eager_flow_ms": (time.perf_counter() - t_eager) * 1e3,
                "captures": server.graphs.captures}
    print(f"{cfg.name} second serve's refine (graph) vs its eager launches (bitwise): {vs_eager}")
    if vs_eager["differ"] or server.graphs.captures != 1:
        fail(f"{cfg.name}: the refine's graph disagrees with its eager launches: {vs_eager}")

    t_one = torch.full((1,), T0, device="cuda")
    logits = check_encdec_logits(model, frames[:1], served[:1, :ZOO_LOGIT_TOKENS], t_one)
    shares = encdec_nfe_shares(model, frames, served, torch.full((rows,), T0, device="cuda"))
    given = draft.last
    server.draft_generate = lambda rng, num: given
    holder = {}

    def run():
        holder["rep"] = server.serve(prng.key(521), rows)[1]

    prof = _profile(run, f"{cfg.name} serve with its draft given (the flow stage)")
    prof["flow_ms"] = holder["rep"]["flow_time_s"] * 1e3
    draft_prof = _profile(lambda: (ar_generate(
        drafter, cfg, prng.key(522), batch_size=rows, seq_len=SEQ + 1,
        extras={"frames": frames}), torch.cuda.synchronize()),
        f"{cfg.name} draft, one graph replay (prefill and {SEQ} decode steps)")
    if draft_graphs.captures != 1:
        fail(f"{cfg.name}: the profiled draft captured again: {draft_graphs.captures}")
    steady = reports[1]
    res = {
        "config": cfg.name, "dtype": cfg.dtype, "params": n_params, "rows": rows,
        "seq_len": SEQ, "frames": cfg.num_audio_frames, "t0": T0, "cold_nfe": COLD_NFE,
        "nfe": nfe,
        "draft": {"config": cfg.name + " (ar_generate)", "seed": DRAFT_SEED,
                  "seq_len_asked": SEQ + 1, "tokens": SEQ, "decode_steps": SEQ},
        "warmup_draft_ms": reports[0]["draft_time_s"] * 1e3,
        "warmup_flow_ms": reports[0]["flow_time_s"] * 1e3,
        "draft_ms": steady["draft_time_s"] * 1e3,
        "flow_ms": steady["flow_time_s"] * 1e3,
        "per_nfe_ms": steady["per_nfe_s"] * 1e3,
        "samples_per_s": rows / (steady["draft_time_s"] + steady["flow_time_s"]),
        "draft_cost_ratio": steady["speedup_report"].draft_cost_ratio,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "flow_busy_share": prof.get("busy_share"), "flow_profile": prof,
        "draft_busy_share": draft_prof.get("busy_share"), "draft_profile": draft_prof,
        "nfe_shares": shares, "launches_per_refine": refine, "launches_per_draft": per_draft,
        "vs_eager": vs_eager, "logits_vs_cpu": logits,
        "capture_ms": server.graphs.stats()["capture_ms"],
        "draft_graph": {**draft_vs_eager, "capture_ms": draft_graphs.stats()["capture_ms"]},
    }
    # the draft graph's pool: what the card keeps reserved for it, released with it
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    draft_graphs.clear()
    torch.cuda.empty_cache()
    res["draft_graph"]["pool_gib"] = (held - torch.cuda.memory_reserved()) / 2 ** 30
    del model, drafter, server, draft, frames, draft_graphs
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_start
    print(f"{cfg.name} serve ({rows} x {SEQ}, {nfe} NFE): draft {res['draft_ms']:.1f} ms "
          f"(one graph replay; eager {draft_vs_eager['eager_draft_ms']:.1f} ms, busy "
          f"{res['draft_busy_share']}, its pool {res['draft_graph']['pool_gib']:.3f} GiB), "
          f"flow {res['flow_ms']:.1f} ms ({res['per_nfe_ms']:.1f} ms an NFE), "
          f"{res['samples_per_s']:.3f} samples/s, draft cost ratio "
          f"{res['draft_cost_ratio']:.3f}, peak memory {res['peak_memory_gb']:.1f} GiB; "
          f"{res['seconds']:.1f} s")
    return res, counts


def encdec_path():
    """The encoder-decoder family's phase: the kernels at whisper-medium's
    shapes, its serve at full width and depth, the smoke config card == CPU.
    Returns (the {"encdec": ...} record, the serves' launches)."""
    t0 = time.perf_counter()
    res = {"kernel_errors": encdec_kernel_gates(), "kernels": encdec_measure()}
    res[ENCDEC_ARCH], counts = encdec_serve()
    res["smoke_vs_cpu"] = check_encdec_smoke_against_cpu()
    res["phase_seconds"] = time.perf_counter() - t0
    print(f"encdec phases (kernel gates, measurements, {ENCDEC_ARCH} serve, smoke config): "
          f"{res['phase_seconds']:.1f} s")
    return res, counts


# -- the MoE family ------------------------------------------------------------------

MOE_ARCH = "arctic-480b"
MOE_ROWS = 8
# one of its 35 layers at the published widths: a layer's 128 experts are 53.6 GB in
# float32, with its attention, dense residual, embedding and head 56.3 GB of the card's
# 80; two layers would take 110 GB. The draft is the same model as a causal decoder
MOE_LAYERS = 1
MOE_HEADS, MOE_KV_HEADS, MOE_HEAD_DIM = 56, 8, 128
MOE_SERVES = 3
MOE_FFN_TOKENS = 64          # the full-width FFN against float64, 1 x 64 hidden states
MOE_FFN_TOL = 1e-4           # x max |float64 reference|
# the device time an eager NFE and an eager decode step spend in each kind of op (the
# op's kernels, by the profiler): the dropless path's weight gathers, the experts'
# batched GEMMs, every other GEMM (attention projections, router, residual, head)
MOE_OP_KINDS = {"aten::index_select": "dropless_gather", "aten::bmm": "expert_gemms",
                "aten::mm": "dense_gemms", "aten::addmm": "dense_gemms"}


def moe_kernel_gates():
    """The kernels at arctic-480b's serve shapes against their plain versions:
    flash_attn<128> at (8, 256, 56 heads, kv 8, 128) bidirectional (the
    refine) and ws_step at (2048, 32000), the device-key launch against the
    host key's too."""
    rows = MOE_ROWS
    flash = check_flash(rows, SEQ, MOE_HEADS, MOE_KV_HEADS, MOE_HEAD_DIM, False, None, 90)
    ws = check_ws_step(rows * SEQ, 32000, 1.0, 91)
    keys = check_device_keys(rows * SEQ, 32000, 92)
    return {"flash_attn": flash, "ws_step": ws["max_abs_err"], "ws_check": ws,
            "device_keys": keys}


def _under(event, name):
    """True when a host op of the profile runs inside a host op ``name``."""
    parent = getattr(event, "cpu_parent", None)
    while parent is not None:
        if parent.name == name:
            return True
        parent = getattr(parent, "cpu_parent", None)
    return False


def _profile_ops(run, what):
    """``run`` of eager launches under ``torch.profiler``: device ms by
    MOE_OP_KINDS (a host op's kernels), of the cached attention's einsums
    (their GEMMs counted there, not among the experts' or the dense ones)
    and of the flash_attn
    and ws_step kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    res = {kind: 0.0 for kind in sorted(set(MOE_OP_KINDS.values()))}
    res.update(attention_einsums=0.0, flash_attn=0.0, ws_step=0.0, all_kernels=0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in MOE_OP_KINDS \
                and _under(e, "aten::einsum"):
            res[MOE_OP_KINDS[e.name]] -= e.device_time_total / 1e3
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU and e.key in MOE_OP_KINDS:
            res[MOE_OP_KINDS[e.key]] += e.device_time_total / 1e3
        elif e.device_type == DeviceType.CPU and e.key == "aten::einsum":
            res["attention_einsums"] += e.device_time_total / 1e3
        elif e.device_type == DeviceType.CUDA:
            res["all_kernels"] += e.self_device_time_total / 1e3
            if _category(e.key) in ("flash_attn", "ws_step"):
                res[_category(e.key)] += e.self_device_time_total / 1e3
    if not res["all_kernels"]:
        print(f"profile of {what}: the trace holds no device time (not measured)")
        return {"device_ms": None}
    print(f"profile of {what}: device ms by kind "
          + json.dumps({k: round(v, 3) for k, v in res.items()}))
    return res


def check_moe_ffn_float64(moe, seed=93):
    """The layer's MoE FFN at full width on 1 x MOE_FFN_TOKENS hidden states
    (N(0, 1), a seed), both dispatches, against float64: the routing (the
    port's, float32) given, each routed expert's three products and the dense
    residual in float64, expert by expert over the routed experts only (no
    float64 copy of the 53.6 GB), beside the layer's dense branches: the
    shared expert (DeepSeek) and the dense residual (Arctic), whichever it
    has. Within MOE_FFN_TOL of max |reference|."""
    from repro_torch.models.common import activation
    from repro_torch.models.moe import capacity, dispatch_slots, route

    cfg = moe.cfg
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((1, MOE_FFN_TOKENS, cfg.d_model), generator=g, device="cuda")
    with torch.no_grad():
        got = {"capacity": moe.capacity_ffn(x)[0][0], "dropless": moe.dropless(x)[0][0]}
        xt = x[0]
        _, gate_w, gate_i = route(xt, moe.router, cfg.moe.num_experts_per_tok)
        _, keep = dispatch_slots(gate_i, cfg.moe.num_experts, capacity(MOE_FFN_TOKENS, cfg))
        x64 = xt.double()
        dense = torch.zeros_like(x64)
        for mlp in (moe.shared, moe.residual):
            if mlp is not None:
                dense = dense + torch.matmul(activation(cfg.act, x64 @ mlp.gate.w.double())
                                             * (x64 @ mlp.up.w.double()), mlp.down.w.double())
        experts = torch.zeros((MOE_FFN_TOKENS, gate_i.shape[1], cfg.d_model),
                              dtype=torch.float64, device="cuda")
        for e in sorted(set(gate_i.flatten().tolist())):
            t, j = (gate_i == e).nonzero(as_tuple=True)
            xe = x64[t]
            h = (activation(cfg.act, xe @ moe.gate[e].double()) * (xe @ moe.up[e].double()))
            experts[t, j] = h @ moe.down[e].double()
        w = gate_w.double()[..., None]
        want = {"dropless": dense + (experts * w).sum(1),
                "capacity": dense + (experts * w * keep[..., None]).sum(1)}
    res = {"tokens": MOE_FFN_TOKENS, "experts_routed": len(set(gate_i.flatten().tolist())),
           "dense_branches": [n for n in ("shared", "residual") if getattr(moe, n) is not None],
           "dropped_slots": int((~keep).sum()), "tolerance": f"{MOE_FFN_TOL} x max|ref|"}
    for name in ("capacity", "dropless"):
        scale = float(want[name].abs().max())
        err = float((got[name].double() - want[name]).abs().max())
        res[name] = {"max_abs_err": err, "max_abs_ref": scale, "rel": err / scale}
    print(f"{cfg.name} MoE FFN at full width (1 x {MOE_FFN_TOKENS}) against float64: {res}")
    if any(not math.isfinite(res[n]["rel"]) or res[n]["rel"] > MOE_FFN_TOL
           for n in ("capacity", "dropless")):
        fail(f"the full-width MoE FFN disagrees with its float64 reference: {res}")
    return res


def moe_serve():
    """arctic-480b at its published widths, MOE_LAYERS of its 35 layers
    (float32, seed 0), served through ``WarmStartServer`` at MOE_ROWS x SEQ,
    t0 = 0.8, cold_nfe = 64 (13 NFE; the capacity path in every NFE's graph),
    drafted by the same model as a causal decoder (the plain decode path:
    the draft kernels refuse MoE; the prompt prefilled by scan, the decode one
    graph replay on the dropless path). MOE_SERVES serves: the first captures
    the decode and the refine. Gates: NFE == warm_nfe, exact launches a serve
    (``flash_attn`` 13, ``ws_step`` 13, no draft kernel; the first serve twice
    that), one capture each, the first serve's graphs == their eager
    warm-ups, the FFN against float64 (:func:`check_moe_ffn_float64`).
    Reports draft, flow and per-NFE ms, samples/s, the draft cost ratio,
    peak memory, the flow stage's busy share (profiled with its draft given)
    and the device ms by kind of an eager NFE and an eager decode step."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core.guarantees import warm_nfe
    from repro_torch.core.paths import WarmStartPath
    from repro_torch.drafting import ARDraftEngine, TransformerDraftAdapter
    from repro_torch.kernels import launches
    from repro_torch.kernels.ws_step import make_ws_step_fn
    from repro_torch.models import Model
    from repro_torch.serving import WarmStartServer

    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rows = MOE_ROWS
    cfg = get_config(MOE_ARCH).replace(dtype="float32", num_layers=MOE_LAYERS)
    model = Model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_start
    weights_gb = torch.cuda.memory_allocated() / 2 ** 30
    adapter = TransformerDraftAdapter(model=model, decode_impl="xla")
    engine = ARDraftEngine(adapter, max_len=MAX_LEN)
    if adapter.exact_batched_prefill or engine.prefill_mode != "scan":
        fail(f"{MOE_ARCH}: the draft must take the plain path with a scanned prefill")
    n_params = sum(p.numel() for p in model.parameters())
    prompt = draft_prompt(rows, cfg.vocab_size)
    path = WarmStartPath(t0=T0)
    server = WarmStartServer(
        flow_model=model, flow_cfg=cfg,
        draft_generate=lambda rng, num: engine.generate_rows(prng.split(rng, num), SEQ, prompt),
        path=path, cold_nfe=COLD_NFE, step_fn=make_ws_step_fn(path), device="cuda")
    nfe = warm_nfe(COLD_NFE, T0)
    per_serve = {"ws_step": nfe, "flash_attn": nfe * MOE_LAYERS}

    launches.clear()
    reports, outs = [], []
    for i in range(MOE_SERVES):
        before = dict(launches)
        served, rep = server.serve(prng.key(500 + i), rows)
        if i == 0:     # the eager warm-ups of the two captures, on this serve's inputs
            warm_draft, warm_x = engine.graphs.last_warmup, server.graphs.last_warmup
        grew = grown(before)
        want = {k: 2 * n if i == 0 else n for k, n in per_serve.items()}   # capture warm-ups
        if grew != want:
            fail(f"{MOE_ARCH} serve {i}: launches {grew}, expected {want}")
        if not (rep["nfe"] == rep["backbone_evals"] == nfe):
            fail(f"{MOE_ARCH} serve {i}: nfe {rep['nfe']} backbone_evals "
                 f"{rep['backbone_evals']}, guaranteed {nfe}")
        if served.shape != (rows, SEQ) or int(served.min()) < 0 \
                or int(served.max()) >= cfg.vocab_size:
            fail(f"{MOE_ARCH} serve {i}: tokens {tuple(served.shape)} outside "
                 f"[0, {cfg.vocab_size})")
        reports.append(rep)
        outs.append(served)
    counts = dict(launches)
    caps = (engine.graphs.captures, server.graphs.captures)
    if caps != (1, 1) or engine.stats.prefill_reuses != MOE_SERVES - 1:
        fail(f"{MOE_ARCH}: {MOE_SERVES} serves must capture the decode and the refine once "
             f"each and reuse the prefix: captures {caps}, {engine.stats.as_dict()}")
    print(f"moe path: {MOE_ARCH} ({n_params / 1e9:.3f}B params, float32, {MOE_LAYERS} of 35 "
          f"layers, {weights_gb:.2f} GiB of weights, init {init_s:.1f} s) x {MOE_SERVES} "
          f"serves of {rows} x {SEQ}, drafted by the same model as a causal decoder, "
          f"t0={T0}, cold_nfe={COLD_NFE}: nfe {nfe} per serve, guarantee gate passed, "
          f"launches {counts} (per serve {per_serve}, the first twice that); capture ms "
          f"(warm-up and capture): decode {engine.graphs.stats()['capture_ms']}, refine "
          f"{server.graphs.stats()['capture_ms']}")

    vs_eager = check_recurrent_vs_eager(server, engine, prompt, prng.key(500), outs[0],
                                        warm_draft, warm_x)
    ffn = check_moe_ffn_float64(model.blocks[0].moe)

    holder = {}
    server.draft_generate = lambda rng, num: warm_draft

    def run():
        holder["rep"] = server.serve(prng.key(521), rows)[1]

    flow_prof = _profile(run, f"{MOE_ARCH} serve with its draft given (the flow stage)")
    flow_prof["flow_ms"] = holder["rep"]["flow_time_s"] * 1e3
    x, t = outs[-1], torch.full((rows,), T0 + 0.05, device="cuda")
    cache = adapter.init_cache(rows, MAX_LEN)
    with torch.no_grad():
        nfe_ops = _profile_ops(lambda: model.dfm_apply(x, t), "an eager NFE (8 x 256)")
        step_ops = _profile_ops(lambda: model.decode_step(x[:, :1], cache, PROMPT),
                                "an eager decode step (8 rows, dropless)")
    del cache
    steady = reports[-1]
    res = {
        "config": MOE_ARCH, "dtype": cfg.dtype, "params": n_params, "layers": MOE_LAYERS,
        "experts": cfg.moe.num_experts, "top_k": cfg.moe.num_experts_per_tok,
        "rows": rows, "seq_len": SEQ, "t0": T0, "cold_nfe": COLD_NFE, "nfe": nfe,
        "serves": MOE_SERVES, "weights_gib": weights_gb, "init_s": init_s,
        "draft": {"config": MOE_ARCH + " (the flow model as a causal decoder)",
                  "prompt": PROMPT, "max_len": MAX_LEN, "decode_steps": SEQ - 1,
                  "prefill": engine.prefill_mode, "decode_impl": adapter.decode_impl,
                  "stats": engine.stats.as_dict()},
        "warmup_draft_ms": reports[0]["draft_time_s"] * 1e3,
        "warmup_flow_ms": reports[0]["flow_time_s"] * 1e3,
        "draft_ms_per_serve": [r["draft_time_s"] * 1e3 for r in reports[1:]],
        "flow_ms_per_serve": [r["flow_time_s"] * 1e3 for r in reports[1:]],
        "draft_ms": steady["draft_time_s"] * 1e3,
        "flow_ms": steady["flow_time_s"] * 1e3,
        "per_nfe_ms": steady["per_nfe_s"] * 1e3,
        "samples_per_s": rows / (steady["draft_time_s"] + steady["flow_time_s"]),
        "draft_cost_ratio": steady["speedup_report"].draft_cost_ratio,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "flow_busy_share": flow_prof.get("busy_share"), "flow_profile": flow_prof,
        "nfe_device_ms_by_kind": nfe_ops, "decode_step_device_ms_by_kind": step_ops,
        "launches_per_serve": per_serve, "vs_eager": vs_eager, "ffn_vs_float64": ffn,
        "capture_ms": {"decode": engine.graphs.stats()["capture_ms"],
                       "refine": server.graphs.stats()["capture_ms"]},
    }
    del model, adapter, engine, server, holder, warm_draft, warm_x, outs, x
    gc_collect()
    res["seconds"] = time.perf_counter() - t_start
    print(f"{MOE_ARCH} serve ({rows} x {SEQ}, {nfe} NFE): draft {res['draft_ms']:.1f} ms, "
          f"flow {res['flow_ms']:.1f} ms ({res['per_nfe_ms']:.2f} ms an NFE), "
          f"{res['samples_per_s']:.3f} samples/s, draft cost ratio "
          f"{res['draft_cost_ratio']:.2f}, peak memory {res['peak_memory_gb']:.2f} GiB, flow "
          f"busy {res['flow_busy_share']}; {res['seconds']:.1f} s")
    return res, counts


def moe_path():
    """The MoE family's phase: the kernels at arctic-480b's shapes, its serve
    at published widths (one layer), the smoke config served and trained 3
    steps card == CPU. Returns (the {"moe": ...} record, the serves' launches)."""
    t0 = time.perf_counter()
    gc_collect()
    res = {"kernel_errors": moe_kernel_gates(),
           "kernels": {"flash_attn": measure_flash(MOE_ROWS, SEQ, MOE_HEADS, MOE_HEAD_DIM,
                                                   kh=MOE_KV_HEADS)}}
    res[MOE_ARCH], counts = moe_serve()
    res["smoke_vs_cpu"] = check_zoo_smoke_against_cpu((MOE_ARCH,))
    res["smoke_train_vs_cpu"] = check_train_zoo_smoke_against_cpu((MOE_ARCH,))
    res["phase_seconds"] = time.perf_counter() - t0
    print(f"moe phases (kernel gates, measurements, {MOE_ARCH} serves, smoke config served "
          f"and trained): {res['phase_seconds']:.1f} s")
    return res, counts


# -- the MLA family ----------------------------------------------------------------

MLA_ARCH = "deepseek-v3-671b"
MLA_ROWS = 8
# one of its 3 dense mla prefix layers and 1 mla_moe layer of its 61, at the published
# widths: 51.0 GB of float32 weights of the card's 80 (the mla_moe layer's 256 routed
# experts are 45.1 GB); a second mla_moe layer would take 106 GB. With all 3 prefix
# layers (60.4 GB) its serves took 56.7 s of a 941.0 s run (NVIDIA H100 80GB HBM3, 700
# W; the draft 6641.5 ms): 2 are cut to make room for the VLM phase. The draft is the
# same model as a causal decoder
MLA_PREFIX = 1
MLA_LAYERS = MLA_PREFIX + 1
MLA_HEADS, MLA_QK_DIM, MLA_V_DIM = 128, 192, 128     # qk_nope 128 + qk_rope 64; v 128
MLA_SMOKE_DIMS = (48, 32)                            # the smoke config's qk 32 + 16; v 32
MLA_SERVES = 2
MLA_TOKENS = 64               # a prefix layer's MLA and the MoE FFN against float64, 1 x 64
MLA_F64_TOL = 1e-4            # x max |float64 reference|
MLA_ABSORB_TOL = 1e-4         # the absorbed step's logits against the naive's, x max |logit|
MLA_PHASE_S = 120             # the phase's time limit


def mla_kernel_gates():
    """The kernels at deepseek-v3-671b's serve shapes against their plain
    versions: flash_attn<192, 128> at (8, 256, 128 heads, kv 128)
    bidirectional (the refine) and causal at a small shape with a ragged
    tail, S != T too; flash_attn<48, 32> at the smoke config's serve (4 x
    32) both ways; ws_step at (2048, 129 280), the device-key launch against
    the host key's too."""
    rows = MLA_ROWS
    qk, v = MLA_QK_DIM, MLA_V_DIM
    flash = [check_flash(rows, SEQ, MLA_HEADS, MLA_HEADS, qk, False, None, 100, dv=v),
             check_flash(2, 77, 4, 4, qk, True, None, 101, dv=v),
             check_flash(2, 50, 4, 4, qk, False, 20, 102, t=130, dv=v),
             check_flash(4, 32, 4, 4, MLA_SMOKE_DIMS[0], False, None, 103,
                         dv=MLA_SMOKE_DIMS[1]),
             check_flash(4, 32, 4, 4, MLA_SMOKE_DIMS[0], True, None, 104,
                         dv=MLA_SMOKE_DIMS[1])]
    ws = check_ws_step(rows * SEQ, 129280, 1.0, 105)
    keys = check_device_keys(rows * SEQ, 129280, 106)
    return {"flash_attn": max(flash), "flash_checks": flash, "ws_step": ws["max_abs_err"],
            "ws_check": ws, "device_keys": keys}


def mla_measure():
    """Device times at deepseek-v3-671b's serve shapes beside the plain
    versions, SDPA and the bounds: flash_attn<192, 128> at the refine's (8,
    256, 128 heads, kv 128), flash_attn<48, 32> at the smoke config's serve
    (4 x 32, 4 heads), both bidirectional, and ws_step at (2048, 129 280)."""
    return {"flash_attn": measure_flash(MLA_ROWS, SEQ, MLA_HEADS, MLA_QK_DIM, dv=MLA_V_DIM),
            "flash_attn_smoke": measure_flash(4, 32, 4, MLA_SMOKE_DIMS[0],
                                              dv=MLA_SMOKE_DIMS[1]),
            "ws_step": measure_ws_step(MLA_ROWS * SEQ, 129280, plain_n=2)}


def mla_float64(mla, x, sin, cos, causal):
    """A layer's MLA on ``x`` (B, S, d) in float64 from its weights: the
    naive expansion of the latent, the softmax over every key (``causal``:
    the earlier ones)."""
    from repro_torch.models.rope import apply_rope

    def dense(lin, z):
        return z @ lin.w.double()

    def rms(norm, z):
        z = z * torch.rsqrt(z.square().mean(-1, keepdim=True) + norm.eps)
        return z * (1.0 + norm.scale.double())

    x = x.double()
    b, s, _ = x.shape
    h, nd, rd, vd, r = mla.h, mla.nd, mla.rd, mla.vd, mla.r
    sin, cos = sin.double(), cos.double()
    q = dense(mla.wq_b, rms(mla.q_norm, dense(mla.wq_a, x))).reshape(b, s, h, nd + rd)
    q_nope, q_rope = q[..., :nd], apply_rope(q[..., nd:], sin, cos)
    kv_a = dense(mla.wkv_a, x)
    c_kv = rms(mla.kv_norm, kv_a[..., :r])
    k_pe = apply_rope(kv_a[..., r:][:, :, None, :], sin, cos)[:, :, 0]
    kv = dense(mla.wkv_b, c_kv).reshape(b, s, h, nd + vd)
    scores = (torch.einsum("bshd,bthd->bhst", q_nope, kv[..., :nd])
              + torch.einsum("bshd,btd->bhst", q_rope, k_pe)) / math.sqrt(nd + rd)
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    out = torch.einsum("bhst,bthd->bshd", torch.softmax(scores, -1), kv[..., nd:])
    return dense(mla.wo, out.reshape(b, s, h * vd))


def check_mla_float64(model, seed=107):
    """The first prefix layer's MLA at full width on 1 x MLA_TOKENS hidden
    states (N(0, 1), a seed) against float64: without a cache (the refine's
    path: flash_attn<192, 128>, bidirectional), and as a 64-token prefill
    into a fresh latent cache, naive and absorbed (causal). Within MLA_F64_TOL
    of max |reference|; the cache's latent against the float64 one too."""
    from repro_torch.kernels import launches
    from repro_torch.models.attention import init_mla_cache
    from repro_torch.models.rope import rope_angles

    cfg, mla = model.cfg, model.blocks[0].attn
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((1, MLA_TOKENS, cfg.d_model), generator=g, device="cuda")
    pos = torch.arange(MLA_TOKENS, dtype=torch.int32, device="cuda")
    sin, cos = rope_angles(pos, cfg.mla.qk_rope_head_dim, cfg.rope_theta)
    res = {"tokens": MLA_TOKENS, "tolerance": f"{MLA_F64_TOL} x max|ref|"}
    with torch.no_grad():
        before = launches["flash_attn"]
        got = {"kernel": mla(x, sin=sin, cos=cos, mode="bidir")}
        res["flash_attn_launches"] = launches["flash_attn"] - before
        for name, absorb in (("cached_naive", False), ("cached_absorbed", True)):
            cache = init_mla_cache(cfg, 1, MLA_TOKENS, torch.float32, "cuda")
            got[name], _ = mla.forward_cached(x, cache, sin=sin, cos=cos, q_pos=pos[None],
                                              absorb=absorb)
        want = {"kernel": mla_float64(mla, x, sin, cos, causal=False)}
        want["cached_naive"] = want["cached_absorbed"] = mla_float64(mla, x, sin, cos,
                                                                     causal=True)
    for name in got:
        scale = float(want[name].abs().max())
        err = float((got[name].double() - want[name]).abs().max())
        res[name] = {"max_abs_err": err, "max_abs_ref": scale, "rel": err / scale}
    print(f"{cfg.name} MLA layer at full width (1 x {MLA_TOKENS}) against float64: {res}")
    if res["flash_attn_launches"] != 1 or any(
            not math.isfinite(res[n]["rel"]) or res[n]["rel"] > MLA_F64_TOL for n in got):
        fail(f"the full-width MLA layer disagrees with its float64 reference: {res}")
    return res


def check_absorbed_first_step(model, absorbed, prompt):
    """The prompt prefilled, then the first decode step on the naive
    prefill's most likely tokens, through the naive and the absorbed model
    (the same weights): the prefill's and the step's logits within
    MLA_ABSORB_TOL of max |naive logit|."""
    res, outs, tok = {}, [], None
    prompt = prompt.to(model.device)
    with torch.no_grad():
        for m in (model, absorbed):
            cache = m.init_cache(prompt.shape[0], MAX_LEN, torch.float32)
            last, cache = m.prefill({"tokens": prompt}, cache)
            if tok is None:
                tok = last[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            outs.append((last, m.decode_step(tok, cache, prompt.shape[1])[0]))
            del cache
    for i, name in enumerate(("prefill", "first_step")):
        naive, absd = outs[0][i], outs[1][i]
        scale = float(naive.abs().max())
        err = float((absd - naive).abs().max())
        res[name] = {"max_abs_err": err, "max_abs_logit": scale, "rel": err / scale}
    res["tolerance"] = f"{MLA_ABSORB_TOL} x max|logit|"
    print(f"{model.cfg.name}: the absorbed decode against the naive one (prompt "
          f"{tuple(prompt.shape)} prefilled, then a step): {res}")
    if any(not math.isfinite(res[n]["rel"]) or res[n]["rel"] > MLA_ABSORB_TOL
           for n in ("prefill", "first_step")):
        fail(f"the absorbed decode disagrees with the naive one: {res}")
    return res


def mla_serve():
    """deepseek-v3-671b at its published widths, one of its 3 dense mla layers and 1
    mla_moe layer (256 experts top-8 beside a shared one; float32, seed 0),
    served through ``WarmStartServer`` at MLA_ROWS x SEQ, t0 = 0.8,
    cold_nfe = 64 (13 NFE; flash_attn<192, 128> in every layer and the
    capacity path in every NFE's graph), drafted by the same model as a
    causal decoder (the plain decode path: the draft kernels refuse MLA; the
    prompt prefilled by scan, the decode one graph replay: the naive latent
    expansion, the dropless path). MLA_SERVES serves: the first captures the
    decode and the refine. Gates: NFE == warm_nfe, exact launches a serve
    (``flash_attn`` 4 x 13, ``ws_step`` 13, no draft kernel; the first serve
    twice that), one capture each, the first serve's graphs == their eager
    warm-ups, a prefix layer's MLA and the MoE FFN against float64, the
    absorbed decode's first step against the naive one. Reports draft, flow
    and per-NFE ms, samples/s, the draft cost ratio, peak memory, the flow's
    busy share, an eager NFE and decode step by op kind (naive and
    absorbed), the absorbed draft's ms."""
    import copy

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core.guarantees import warm_nfe
    from repro_torch.core.paths import WarmStartPath
    from repro_torch.drafting import ARDraftEngine, TransformerDraftAdapter
    from repro_torch.kernels import launches
    from repro_torch.kernels.ws_step import make_ws_step_fn
    from repro_torch.models import Model
    from repro_torch.serving import WarmStartServer

    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rows = MLA_ROWS
    cfg = get_config(MLA_ARCH).replace(dtype="float32", num_layers=MLA_LAYERS,
                                       prefix=("mla",) * MLA_PREFIX)
    model = Model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_start
    weights_gb = torch.cuda.memory_allocated() / 2 ** 30
    adapter = TransformerDraftAdapter(model=model, decode_impl="xla")
    engine = ARDraftEngine(adapter, max_len=MAX_LEN)
    if adapter.exact_batched_prefill or engine.prefill_mode != "scan":
        fail(f"{MLA_ARCH}: the draft must take the plain path with a scanned prefill")
    n_params = sum(p.numel() for p in model.parameters())
    prompt = draft_prompt(rows, cfg.vocab_size)
    path = WarmStartPath(t0=T0)
    server = WarmStartServer(
        flow_model=model, flow_cfg=cfg,
        draft_generate=lambda rng, num: engine.generate_rows(prng.split(rng, num), SEQ, prompt),
        path=path, cold_nfe=COLD_NFE, step_fn=make_ws_step_fn(path), device="cuda")
    nfe = warm_nfe(COLD_NFE, T0)
    per_serve = {"ws_step": nfe, "flash_attn": nfe * MLA_LAYERS}

    launches.clear()
    reports, outs = [], []
    for i in range(MLA_SERVES):
        before = dict(launches)
        served, rep = server.serve(prng.key(600 + i), rows)
        if i == 0:     # the eager warm-ups of the two captures, on this serve's inputs
            warm_draft, warm_x = engine.graphs.last_warmup, server.graphs.last_warmup
        grew = grown(before)
        want = {k: 2 * n if i == 0 else n for k, n in per_serve.items()}   # capture warm-ups
        if grew != want:
            fail(f"{MLA_ARCH} serve {i}: launches {grew}, expected {want}")
        if not (rep["nfe"] == rep["backbone_evals"] == nfe):
            fail(f"{MLA_ARCH} serve {i}: nfe {rep['nfe']} backbone_evals "
                 f"{rep['backbone_evals']}, guaranteed {nfe}")
        if served.shape != (rows, SEQ) or int(served.min()) < 0 \
                or int(served.max()) >= cfg.vocab_size:
            fail(f"{MLA_ARCH} serve {i}: tokens {tuple(served.shape)} outside "
                 f"[0, {cfg.vocab_size})")
        reports.append(rep)
        outs.append(served)
    counts = dict(launches)
    caps = (engine.graphs.captures, server.graphs.captures)
    if caps != (1, 1) or engine.stats.prefill_reuses != MLA_SERVES - 1:
        fail(f"{MLA_ARCH}: {MLA_SERVES} serves must capture the decode and the refine once "
             f"each and reuse the prefix: captures {caps}, {engine.stats.as_dict()}")
    print(f"mla path: {MLA_ARCH} ({n_params / 1e9:.3f}B params, float32, {MLA_LAYERS} of 61 "
          f"layers, {weights_gb:.2f} GiB of weights, init {init_s:.1f} s) x {MLA_SERVES} "
          f"serves of {rows} x {SEQ}, drafted by the same model as a causal decoder, "
          f"t0={T0}, cold_nfe={COLD_NFE}: nfe {nfe} per serve, guarantee gate passed, "
          f"launches {counts} (per serve {per_serve}, the first twice that); capture ms "
          f"(warm-up and capture): decode {engine.graphs.stats()['capture_ms']}, refine "
          f"{server.graphs.stats()['capture_ms']}")

    vs_eager = check_recurrent_vs_eager(server, engine, prompt, prng.key(600), outs[0],
                                        warm_draft, warm_x)
    # what follows runs eagerly but the flow's profile: the decode graph's pool (the
    # draft's noise, a chunk of gathered experts) is given back first
    engine.reset()
    gc_collect()
    mla_f64 = check_mla_float64(model)
    ffn = check_moe_ffn_float64(model.blocks[MLA_LAYERS - 1].moe)

    # the absorbed decode: the same weights under cfg.mla_absorb
    absorbed = copy.copy(model)
    absorbed.cfg = cfg.replace(mla_absorb=True)
    first_step = check_absorbed_first_step(model, absorbed, prompt)
    absorbed_engine = ARDraftEngine(TransformerDraftAdapter(model=absorbed, decode_impl="xla"),
                                    max_len=MAX_LEN)
    keys = prng.split(prng.split(prng.key(600), 2)[0], rows)      # the first serve's draft keys
    torch.cuda.synchronize()
    t = time.perf_counter()
    absorbed_draft = absorbed_engine._generate_rows_eager(keys, SEQ, prompt)
    torch.cuda.synchronize()
    absorbed_ms = (time.perf_counter() - t) * 1e3
    absorbed_res = {"draft_ms_eager": absorbed_ms, "first_step": first_step,
                    # the first serve's naive draft drew from the same keys: equal off
                    # near ties (a token past the first tie follows another prefix)
                    "tokens_differ_from_the_naive_draft": int((absorbed_draft
                                                               != warm_draft).sum())}
    del absorbed_engine, absorbed_draft

    holder = {}
    server.draft_generate = lambda rng, num: warm_draft

    def run():
        holder["rep"] = server.serve(prng.key(621), rows)[1]

    flow_prof = _profile(run, f"{MLA_ARCH} serve with its draft given (the flow stage)")
    flow_prof["flow_ms"] = holder["rep"]["flow_time_s"] * 1e3
    server.graphs.clear()          # the refine graph's pool too, before the eager profiles
    gc_collect()
    x, tt = outs[-1], torch.full((rows,), T0 + 0.05, device="cuda")
    cache = adapter.init_cache(rows, MAX_LEN)
    last = PROMPT + SEQ - 2                # the draft's last decode step: the longest cache
    with torch.no_grad():
        nfe_ops = _profile_ops(lambda: model.dfm_apply(x, tt), "an eager NFE (8 x 256)")
        step_ops = {name: _profile_ops(lambda m=m: m.decode_step(x[:, :1], cache, last),
                                       f"an eager decode step (8 rows, {name}, dropless)")
                    for name, m in (("naive", model), ("absorbed", absorbed))}
        step_ms = {name: time_ms(lambda m=m: m.decode_step(x[:, :1], cache, last), reps=3,
                                 inner=5)
                   for name, m in (("naive", model), ("absorbed", absorbed))}
    absorbed_res["decode_step_ms"] = step_ms
    print(f"{MLA_ARCH} decode step at position {last} (8 rows, eager, CUDA events): {step_ms}; "
          f"the absorbed draft, eager: {absorbed_ms:.1f} ms")
    del cache
    steady = reports[-1]
    res = {
        "config": MLA_ARCH, "dtype": cfg.dtype, "params": n_params, "layers": MLA_LAYERS,
        "prefix": list(cfg.prefix), "pattern": list(cfg.pattern),
        "experts": cfg.moe.num_experts, "top_k": cfg.moe.num_experts_per_tok,
        "shared_experts": cfg.moe.num_shared_experts,
        "rows": rows, "seq_len": SEQ, "t0": T0, "cold_nfe": COLD_NFE, "nfe": nfe,
        "serves": MLA_SERVES, "weights_gib": weights_gb, "init_s": init_s,
        "draft": {"config": MLA_ARCH + " (the flow model as a causal decoder)",
                  "prompt": PROMPT, "max_len": MAX_LEN, "decode_steps": SEQ - 1,
                  "prefill": engine.prefill_mode, "decode_impl": adapter.decode_impl,
                  "mla": "naive expansion", "stats": engine.stats.as_dict()},
        "warmup_draft_ms": reports[0]["draft_time_s"] * 1e3,
        "warmup_flow_ms": reports[0]["flow_time_s"] * 1e3,
        "draft_ms": steady["draft_time_s"] * 1e3,
        "flow_ms": steady["flow_time_s"] * 1e3,
        "per_nfe_ms": steady["per_nfe_s"] * 1e3,
        "samples_per_s": rows / (steady["draft_time_s"] + steady["flow_time_s"]),
        "draft_cost_ratio": steady["speedup_report"].draft_cost_ratio,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "flow_busy_share": flow_prof.get("busy_share"), "flow_profile": flow_prof,
        "nfe_device_ms_by_kind": nfe_ops, "decode_step_device_ms_by_kind": step_ops,
        "absorbed": absorbed_res,
        "launches_per_serve": per_serve, "vs_eager": vs_eager, "mla_vs_float64": mla_f64,
        "ffn_vs_float64": ffn,
        "capture_ms": {"decode": engine.graphs.stats()["capture_ms"],
                       "refine": server.graphs.stats()["capture_ms"]},
    }
    del model, absorbed, adapter, engine, server, holder, warm_draft, warm_x, outs, x
    gc_collect()
    res["seconds"] = time.perf_counter() - t_start
    print(f"{MLA_ARCH} serve ({rows} x {SEQ}, {nfe} NFE): draft {res['draft_ms']:.1f} ms, "
          f"flow {res['flow_ms']:.1f} ms ({res['per_nfe_ms']:.2f} ms an NFE), "
          f"{res['samples_per_s']:.3f} samples/s, draft cost ratio "
          f"{res['draft_cost_ratio']:.2f}, peak memory {res['peak_memory_gb']:.2f} GiB, flow "
          f"busy {res['flow_busy_share']}; {res['seconds']:.1f} s")
    return res, counts


def mla_path():
    """The MLA family's phase: the kernels at deepseek-v3-671b's shapes, its
    serve at published widths (one dense layer and one MoE layer), the
    smoke config served and trained 3 steps card == CPU, all within
    MLA_PHASE_S. Returns (the {"mla": ...} record, the serves' launches)."""
    t0 = time.perf_counter()
    gc_collect()
    res = {"kernel_errors": mla_kernel_gates(), "kernels": mla_measure()}
    res[MLA_ARCH], counts = mla_serve()
    res["smoke_vs_cpu"] = check_zoo_smoke_against_cpu((MLA_ARCH,))
    res["smoke_train_vs_cpu"] = check_train_zoo_smoke_against_cpu((MLA_ARCH,))
    res["phase_seconds"] = time.perf_counter() - t0
    print(f"mla phases (kernel gates, measurements, {MLA_ARCH} serves, smoke config served "
          f"and trained): {res['phase_seconds']:.1f} s (limit {MLA_PHASE_S})")
    if res["phase_seconds"] > MLA_PHASE_S:
        fail(f"the MLA phase took {res['phase_seconds']:.1f} s, over its {MLA_PHASE_S} s")
    return res, counts


# -- the VLM family ----------------------------------------------------------------

VLM_ARCH = "qwen2-vl-72b"
VLM_ROWS = 8
# 4 of its 80 layers at the published widths: 3.51 GB of float32 weights a layer, with the
# embedding (4.98 GB), the head (4.98) and patch_proj (0.04) 24.1 GB of the card's 80. The
# draft is the same model as a causal decoder on the text alone (the engine's plain path:
# the draft kernels refuse the VLM, as JAX's rule does)
VLM_LAYERS = 4
VLM_SERVES = 2
VLM_HEADS, VLM_KV_HEADS, VLM_HEAD_DIM = 64, 8, 128
VLM_GRID = (16, 16)          # one image's merged grid: its 256 patches, text from id 16
VLM_SMOKE_GRID = (2, 4)      # the smoke config's 8 patches
VLM_PATCH_SEED = 7           # the patches: 0.1 N(0, 1) from numpy, as whisper's frames
VLM_LOGIT_TOKENS = 64        # the logits at 1 x (256 + 64) against a float64 forward
VLM_F64_TOL = 1e-4           # x max(1, max |float64 logit|)
VLM_SMOKE_SEQ = 32           # the smoke config's forward and serve, 2 x 32 after 8 patches
VLM_SMOKE_TOL = 1e-4         # the smoke forward on the card against the CPU, x max(1, max |logit|)


def vlm_patches(cfg, rows, device="cuda"):
    """(rows, num_vision_tokens, 1280) float32: 0.1 N(0, 1), numpy seed
    VLM_PATCH_SEED (the ViT frontend's stub, as in JAX)."""
    import numpy as np
    from repro_torch.models.model import VISION_DIM

    rng = np.random.default_rng(VLM_PATCH_SEED)
    patches = 0.1 * rng.standard_normal((rows, cfg.num_vision_tokens, VISION_DIM))
    return torch.from_numpy(patches.astype(np.float32)).to(device)


def check_vlm_flash(seed):
    """flash_attn<128> at qwen2-vl-72b's refine shape (8, 256 patches + 256
    text, 64 heads over 8 KV heads, 128), bidirectional, q and k rotated by
    M-RoPE at Qwen2-VL's ids, against its plain version."""
    from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref
    from repro_torch.models.rope import apply_rope, mrope_angles, vlm_positions

    rows, s = VLM_ROWS, VLM_GRID[0] * VLM_GRID[1] + SEQ
    q, k, v = flash_inputs(rows, s, VLM_HEADS, VLM_KV_HEADS, VLM_HEAD_DIM, seed)
    pos = vlm_positions(rows, VLM_GRID, SEQ, device="cuda")
    sin, cos = mrope_angles(pos, VLM_HEAD_DIM, 1e6, (16, 24, 24))
    q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
    got = flash_attention(q, k, v, causal=False)
    want = flash_attention_ref(q, k, v, causal=False)
    err = float((got - want).abs().max())
    print(f"flash_attn at qwen2-vl-72b's refine (B={rows} S={s} H={VLM_HEADS} "
          f"KH={VLM_KV_HEADS} D={VLM_HEAD_DIM}, M-RoPE rotated, bidirectional): max abs err "
          f"{err:.3e} (limit {FLASH_TOL})")
    if not math.isfinite(err) or err > FLASH_TOL:
        fail(f"flash_attn kernel disagrees with its plain version at the VLM shape: {err}")
    return err


def vlm_kernel_gates():
    """The kernels at qwen2-vl-72b's serve shapes against their plain
    versions: flash_attn<128> at (8, 512, 64 heads, kv 8, 128), M-RoPE
    rotated (:func:`check_vlm_flash`), and ws_step at (2048, 152 064), the
    device-key launch against the host key's too."""
    flash = check_vlm_flash(110)
    ws = check_ws_step(VLM_ROWS * SEQ, 152064, 1.0, 111)
    keys = check_device_keys(VLM_ROWS * SEQ, 152064, 112)
    return {"flash_attn": flash, "ws_step": ws["max_abs_err"], "ws_check": ws,
            "device_keys": keys}


def vlm_measure():
    """Device times at qwen2-vl-72b's serve shapes beside the plain versions,
    SDPA (KV repeated) and the bounds: flash_attn at (8, 512, 64, kv 8, 128)
    and ws_step at (2048, 152 064)."""
    s = VLM_GRID[0] * VLM_GRID[1] + SEQ
    return {"flash_attn": measure_flash(VLM_ROWS, s, VLM_HEADS, VLM_HEAD_DIM,
                                        kh=VLM_KV_HEADS),
            "ws_step": measure_ws_step(VLM_ROWS * SEQ, 152064, plain_n=2)}


def vlm_float64_logits(model, tokens, patches, positions, t, device="cuda"):
    """``dfm_apply(tokens, t, extras={"patches", "positions"})`` of a VLM
    ``Model`` in float64 on ``device`` from its weights, written out here
    apart from the model's code: the projected patches before the token
    rows, the time embedding at every position, each layer's rmsnorm,
    q/k/v, M-RoPE at ``positions``, softmax attention over every position
    (GQA), the gated SiLU MLP, the final norm and the head on the text rows.
    A layer's weights are copied to ``device`` one layer at a time."""
    import torch.nn.functional as F

    cfg = model.cfg
    if (cfg.use_bias or cfg.qk_norm or cfg.embed_scale or not cfg.mlp_gated or cfg.act != "silu"
            or cfg.norm != "rmsnorm" or cfg.tie_embeddings):
        fail(f"{cfg.name}: the float64 forward covers an untied rmsnorm SwiGLU stack without "
             f"biases, qk-norm or embedding scale")

    def f64(w):
        return w.detach().to(device=device, dtype=torch.float64)

    def rms(norm, x):
        y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + norm.eps)
        return y * (1.0 + f64(norm.scale))

    def rope(x, sin, cos):
        half = x.shape[-1] // 2
        x1, x2 = x[..., :half], x[..., half:]
        sin, cos = sin[:, :, None], cos[:, :, None]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    with torch.no_grad():
        x = f64(model.embed.table[tokens.long()])
        x = torch.cat([f64(patches) @ f64(model.patch_proj.w), x], dim=1)
        half = model.time.dim // 2
        ar = torch.arange(half, dtype=torch.float64, device=device)
        ang = f64(t)[:, None] * torch.exp(-math.log(10000.0) * ar / half)[None] * 1000.0
        feats = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        x = x + (F.silu(feats @ f64(model.time.w1.w)) @ f64(model.time.w2.w))[:, None]
        b, s, _ = x.shape
        h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        # M-RoPE: frequency slot i of the rotary half turns by its section's stream
        ar = torch.arange(hd // 2, dtype=torch.float64, device=device)
        sec = torch.cat([torch.full((n,), j, dtype=torch.long)
                         for j, n in enumerate(cfg.mrope_sections)]).to(device)
        ang = (positions.to(device)[sec].movedim(0, -1).double()
               * cfg.rope_theta ** (-ar / (hd // 2)))
        sin, cos = torch.sin(ang), torch.cos(ang)
        for block in model.blocks:
            a = block.attn
            hin = rms(block.ln1, x)
            q = rope((hin @ f64(a.wq.w)).reshape(b, s, h, hd), sin, cos)
            k = rope((hin @ f64(a.wk.w)).reshape(b, s, kh, hd), sin, cos)
            v = (hin @ f64(a.wv.w)).reshape(b, s, kh, hd)
            k, v = (z.repeat_interleave(h // kh, dim=2) for z in (k, v))
            scores = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(hd)
            out = torch.einsum("bhst,bthd->bshd", torch.softmax(scores, dim=-1), v)
            x = x + out.reshape(b, s, h * hd) @ f64(a.wo.w)
            hin = rms(block.ln2, x)
            m = block.mlp
            x = x + (F.silu(hin @ f64(m.gate.w)) * (hin @ f64(m.up.w))) @ f64(m.down.w)
        x = rms(model.final_norm, x[:, patches.shape[1]:])
        return x @ f64(model.head.w)


def check_vlm_logits(model, tokens, patches, positions, t):
    """qwen2-vl-72b's dfm_apply at 1 x (256 patches + len(tokens)) with
    Qwen2-VL's ids through the kernels on the card against
    :func:`vlm_float64_logits`, within VLM_F64_TOL x max(1, max |logit|).
    The float64 forward runs on the card: on the host (8 cores) it took 29.8
    s of the phase (NVIDIA H100 80GB HBM3 machine, 700 W)."""
    extras = {"patches": patches, "positions": positions}
    t_f64 = time.perf_counter()
    with torch.inference_mode():
        got = model.dfm_apply(tokens, t, extras=extras).double()
    want = vlm_float64_logits(model, tokens, patches, positions, t)
    f64_s = time.perf_counter() - t_f64
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    print(f"full-width dfm_apply ({model.cfg.name}), 1 x ({patches.shape[1]} patches + "
          f"{tokens.shape[1]} tokens), card kernels vs a float64 forward (plain torch): max abs "
          f"err {err:.3e} (logits up to {scale:.2f}; limit {VLM_F64_TOL} x max(1, max|logit|)); "
          f"{f64_s:.1f} s")
    if not math.isfinite(err) or err > VLM_F64_TOL * max(1.0, scale):
        fail(f"full-width logits of {model.cfg.name} disagree with float64: {err}")
    return {"config": model.cfg.name, "tokens": list(tokens.shape),
            "patches": patches.shape[1], "max_abs_err": err, "max_abs_logit": scale,
            "tolerance": f"{VLM_F64_TOL} x max(1, max|logit|)", "seconds": f64_s}


def vlm_serve():
    """qwen2-vl-72b at its published widths, VLM_LAYERS of its 80 layers
    (float32, seed 0), served through ``WarmStartServer`` on
    ``Conditioned(model, {"patches", "positions"})``: VLM_ROWS x SEQ text
    tokens after 256 patches a row (:func:`vlm_patches`) at Qwen2-VL's ids
    (``vlm_positions``: the patches at (0, row, col) of a 16 x 16 grid, the
    text from 16), t0 = 0.8, cold_nfe = 64 (13 NFE), drafted by the same
    model as a causal decoder on the text alone (the plain decode path, the
    prompt prefilled by scan, the decode one graph replay). Two serves.
    Gates: NFE == warm_nfe, exact launches a serve (``flash_attn`` 4 a NFE,
    ``ws_step`` 1; no draft kernel; the first serve twice that), one capture
    each, the second serve's replay == its eager launches bitwise, the
    refine graph reading the patches' storage (rows flipped in place: the
    tokens move; the eager check runs after they are flipped back), the
    logits at 1 x (256 + 64) against float64 (:func:`check_vlm_logits`).
    Reports draft, flow and per-NFE ms, samples/s, the draft cost ratio,
    peak memory and the flow stage's busy share (the flipped serve,
    profiled, its draft given)."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core.guarantees import warm_nfe
    from repro_torch.core.paths import WarmStartPath
    from repro_torch.core.sampler import refine_loop_inputs
    from repro_torch.drafting import ARDraftEngine, TransformerDraftAdapter
    from repro_torch.kernels import launches
    from repro_torch.kernels.ws_step import make_ws_step_fn
    from repro_torch.models import Conditioned, Model
    from repro_torch.models.rope import vlm_positions
    from repro_torch.serving import WarmStartServer

    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rows = VLM_ROWS
    cfg = get_config(VLM_ARCH).replace(dtype="float32", num_layers=VLM_LAYERS)
    model = Model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_start
    weights_gb = torch.cuda.memory_allocated() / 2 ** 30
    adapter = TransformerDraftAdapter(model=model, decode_impl="xla")
    engine = ARDraftEngine(adapter, max_len=MAX_LEN)
    if adapter.exact_batched_prefill or engine.prefill_mode != "scan":
        fail(f"{VLM_ARCH}: the draft must take the plain path with a scanned prefill")
    n_params = sum(p.numel() for p in model.parameters())
    patches = vlm_patches(cfg, rows)
    positions = vlm_positions(rows, VLM_GRID, SEQ, device="cuda")
    prompt = draft_prompt(rows, cfg.vocab_size)
    draft = LastDraft(lambda rng, num: engine.generate_rows(prng.split(rng, num), SEQ, prompt))
    path = WarmStartPath(t0=T0)
    server = WarmStartServer(
        flow_model=Conditioned(model, {"patches": patches, "positions": positions}),
        flow_cfg=cfg, draft_generate=draft, path=path, cold_nfe=COLD_NFE,
        step_fn=make_ws_step_fn(path), device="cuda")
    nfe = warm_nfe(COLD_NFE, T0)
    per_serve = {"ws_step": nfe, "flash_attn": nfe * VLM_LAYERS}

    launches.clear()
    reports, outs = [], []
    for i in range(VLM_SERVES):
        before = dict(launches)
        rng = prng.key(700 + i)
        served, rep = server.serve(rng, rows)
        grew = grown(before)
        want = {k: 2 * n if i == 0 else n for k, n in per_serve.items()}   # capture warm-ups
        if grew != want:
            fail(f"{VLM_ARCH} serve {i}: launches {grew}, expected {want}")
        if not (rep["nfe"] == rep["backbone_evals"] == nfe):
            fail(f"{VLM_ARCH} serve {i}: nfe {rep['nfe']} backbone_evals "
                 f"{rep['backbone_evals']}, guaranteed {nfe}")
        if served.shape != (rows, SEQ) or int(served.min()) < 0 \
                or int(served.max()) >= cfg.vocab_size:
            fail(f"{VLM_ARCH} serve {i}: tokens {tuple(served.shape)} outside "
                 f"[0, {cfg.vocab_size})")
        reports.append(rep)
        outs.append(served)
    counts = dict(launches)
    caps = (engine.graphs.captures, server.graphs.captures)
    if caps != (1, 1) or engine.stats.prefill_reuses != VLM_SERVES - 1:
        fail(f"{VLM_ARCH}: {VLM_SERVES} serves must capture the decode and the refine once "
             f"each and reuse the prefix: captures {caps}, {engine.stats.as_dict()}")
    print(f"vlm path: {VLM_ARCH} ({n_params / 1e9:.3f}B params, float32, {VLM_LAYERS} of 80 "
          f"layers, {weights_gb:.2f} GiB of weights, init {init_s:.1f} s) x {VLM_SERVES} "
          f"serves of {rows} x ({patches.shape[1]} patches + {SEQ} tokens), drafted by the "
          f"same model as a causal decoder on the text, t0={T0}, cold_nfe={COLD_NFE}: nfe "
          f"{nfe} per serve, guarantee gate passed, launches {counts} (per serve {per_serve}, "
          f"the first twice that); capture ms (warm-up and capture): decode "
          f"{engine.graphs.stats()['capture_ms']}, refine {server.graphs.stats()['capture_ms']}")

    # the refine graph reads the patches' storage: flip the rows in place and serve the
    # second serve's draft with its key again (profiled: the flow stage); then flip them back
    given = draft.last
    server.draft_generate = lambda rng, num: given
    holder = {}
    patches.copy_(torch.flip(patches, dims=[0]))

    def run():
        holder["x"], holder["rep"] = server.serve(rng, rows)

    flow_prof = _profile(run, f"{VLM_ARCH} serve with its draft given and the patches' rows "
                              f"flipped in place (the flow stage)")
    flow_prof["flow_ms"] = holder["rep"]["flow_time_s"] * 1e3
    patches.copy_(torch.flip(patches, dims=[0]))
    # the second serve's replay against its eager launches on the same draft and keys
    k_flow = prng.split(rng, 2)[1]
    keys, ts, hs = refine_loop_inputs(k_flow, T0, 1.0 / COLD_NFE, nfe)
    t_eager = time.perf_counter()
    with torch.inference_mode():
        eager = server._refine_loop_eager(keys, given, ts, hs)
    torch.cuda.synchronize()
    vs_eager = {"differ": int((outs[-1] != eager).sum()),
                "eager_flow_ms": (time.perf_counter() - t_eager) * 1e3,
                "flipped_patches_differ": int((holder["x"] != outs[-1]).sum()),
                "captures": server.graphs.captures}
    print(f"{VLM_ARCH} second serve's refine (graph) vs its eager launches (bitwise), and the "
          f"tokens moved by the patches flipped in place: {vs_eager}")
    if vs_eager["differ"] or server.graphs.captures != 1 \
            or not vs_eager["flipped_patches_differ"]:
        fail(f"{VLM_ARCH}: the refine's graph disagrees with its eager launches or does not "
             f"read the patches in place: {vs_eager}")
    engine.reset()
    server.graphs.clear()
    gc_collect()
    t_one = torch.full((1,), T0, device="cuda")
    logits = check_vlm_logits(model, outs[-1][:1, :VLM_LOGIT_TOKENS], patches[:1],
                              vlm_positions(1, VLM_GRID, VLM_LOGIT_TOKENS, device="cuda"),
                              t_one)
    steady = reports[-1]
    res = {
        "config": VLM_ARCH, "dtype": cfg.dtype, "params": n_params, "layers": VLM_LAYERS,
        "rows": rows, "seq_len": SEQ, "patches": patches.shape[1], "grid": list(VLM_GRID),
        "t0": T0, "cold_nfe": COLD_NFE, "nfe": nfe, "serves": VLM_SERVES,
        "weights_gib": weights_gb, "init_s": init_s,
        "draft": {"config": VLM_ARCH + " (the flow model as a causal decoder, text only)",
                  "prompt": PROMPT, "max_len": MAX_LEN, "decode_steps": SEQ - 1,
                  "prefill": engine.prefill_mode, "decode_impl": adapter.decode_impl,
                  "stats": engine.stats.as_dict()},
        "warmup_draft_ms": reports[0]["draft_time_s"] * 1e3,
        "warmup_flow_ms": reports[0]["flow_time_s"] * 1e3,
        "draft_ms": steady["draft_time_s"] * 1e3,
        "flow_ms": steady["flow_time_s"] * 1e3,
        "per_nfe_ms": steady["per_nfe_s"] * 1e3,
        "samples_per_s": rows / (steady["draft_time_s"] + steady["flow_time_s"]),
        "draft_cost_ratio": steady["speedup_report"].draft_cost_ratio,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "flow_busy_share": flow_prof.get("busy_share"), "flow_profile": flow_prof,
        "launches_per_serve": per_serve, "vs_eager": vs_eager, "logits_vs_float64": logits,
        "capture_ms": {"decode": engine.graphs.stats()["capture_ms"],
                       "refine": server.graphs.stats()["capture_ms"]},
    }
    del model, adapter, engine, server, holder, draft, given, outs, patches, positions
    gc_collect()
    res["seconds"] = time.perf_counter() - t_start
    print(f"{VLM_ARCH} serve ({rows} x {SEQ} after {res['patches']} patches, {nfe} NFE): draft "
          f"{res['draft_ms']:.1f} ms, flow {res['flow_ms']:.1f} ms ({res['per_nfe_ms']:.2f} ms "
          f"an NFE), {res['samples_per_s']:.3f} samples/s, draft cost ratio "
          f"{res['draft_cost_ratio']:.2f}, peak memory {res['peak_memory_gb']:.2f} GiB, flow "
          f"busy {res['flow_busy_share']}; {res['seconds']:.1f} s")
    return res, counts


def check_vlm_smoke_against_cpu():
    """qwen2-vl-72b's smoke config (seed 3) on the card and on the CPU, same
    weights, 2 x (8 patches + VLM_SMOKE_SEQ tokens) at Qwen2-VL's ids of a 2
    x 4 grid: ``dfm_apply`` (the kernel path) and the causal forward (masked
    by the temporal ids, plain torch) within VLM_SMOKE_TOL x max(1, max
    |logit|); a serve through ``Conditioned`` (t0 = 0.8, cold_nfe = 16)
    drafted by a second smoke model (seed 4) on the text: the tokens equal."""
    import numpy as np
    from repro_torch import prng
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.paths import WarmStartPath
    from repro_torch.drafting import ARDraftEngine, TransformerDraftAdapter
    from repro_torch.kernels.ws_step import make_ws_step_fn
    from repro_torch.models import Conditioned, Model
    from repro_torch.models.rope import vlm_positions
    from repro_torch.serving import WarmStartServer

    cfg = get_smoke_config(VLM_ARCH)
    rows, seq = 2, VLM_SMOKE_SEQ
    patches = vlm_patches(cfg, rows, device="cpu")
    positions = vlm_positions(rows, VLM_SMOKE_GRID, seq)
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (rows, seq))
                              .astype(np.int32))
    t = torch.tensor([0.7, 0.9])
    prompt = draft_prompt(rows, cfg.vocab_size)[:, :4]
    out = {}
    for device in ("cuda", "cpu"):
        flow = Model(cfg, device="cpu", seed=3).to(device)
        extras = {"patches": patches.to(device), "positions": positions.to(device)}
        with torch.inference_mode():
            dfm = flow.dfm_apply(tokens.to(device), t.to(device), extras=extras).cpu()
            causal = flow(tokens.to(device), **extras).cpu()
        eng = ARDraftEngine(TransformerDraftAdapter(model=Model(cfg, device="cpu", seed=4)
                                                    .to(device)), max_len=4 + seq - 1)
        path = WarmStartPath(t0=T0)
        server = WarmStartServer(
            flow_model=Conditioned(flow, extras), flow_cfg=cfg, path=path, cold_nfe=16,
            draft_generate=lambda rng, num, eng=eng: eng.generate_rows(
                prng.split(rng, num), seq, prompt),
            step_fn=make_ws_step_fn(path, device=device), device=device)
        out[device] = (dfm, causal, server.serve(prng.key(5), rows)[0].cpu())
    res = {"differ": int((out["cuda"][2] != out["cpu"][2]).sum())}
    for i, name in enumerate(("dfm_apply", "causal_forward")):
        res[name] = {"max_abs_err": float((out["cuda"][i] - out["cpu"][i]).abs().max()),
                     "max_abs_logit": float(out["cpu"][i].abs().max())}
    print(f"{cfg.name} on the card vs the CPU ({rows} x (8 patches + {seq} tokens)): {res}")
    if res["differ"] or any(r["max_abs_err"] > VLM_SMOKE_TOL * max(1.0, r["max_abs_logit"])
                            or not math.isfinite(r["max_abs_err"])
                            for r in (res["dfm_apply"], res["causal_forward"])):
        fail(f"{cfg.name} on the card disagrees with the CPU: {res}")
    return res


def vlm_path():
    """The VLM family's phase: the kernels at qwen2-vl-72b's shapes, its
    serve at published widths (4 of 80 layers), the smoke config's forward,
    serve and 3 train steps card == CPU. Returns (the {"vlm": ...} record,
    the serves' launches)."""
    t0 = time.perf_counter()
    gc_collect()
    res = {"kernel_errors": vlm_kernel_gates(), "kernels": vlm_measure()}
    res[VLM_ARCH], counts = vlm_serve()
    res["smoke_vs_cpu"] = check_vlm_smoke_against_cpu()
    res["smoke_train_vs_cpu"] = check_train_zoo_smoke_against_cpu((VLM_ARCH,))
    res["phase_seconds"] = time.perf_counter() - t0
    res["card"] = card_line()
    fl, ws, serve = res["kernels"]["flash_attn"], res["kernels"]["ws_step"], res[VLM_ARCH]
    print(f"vlm phases (kernel gates, measurements, {VLM_ARCH} serves, smoke config forward, "
          f"served and trained): {res['phase_seconds']:.1f} s on {res['card']}; "
          f"{serve['samples_per_s']:.3f} samples/s, draft {serve['draft_ms']:.1f} ms, flow "
          f"{serve['flow_ms']:.1f} ms ({serve['per_nfe_ms']:.2f} ms an NFE), busy "
          f"{serve['flow_busy_share']}, peak {serve['peak_memory_gb']:.2f} GiB; flash_attn "
          f"{fl['ms']:.4f} ms (bound {fl['bound_ms']:.4f}, {fl['bound_by']}; plain "
          f"{fl['plain_ms']:.4f}, SDPA {fl['library_ms']:.4f}), ws_step {ws['ms']:.4f} ms "
          f"(bound {ws['bound_ms']:.4f}, {ws['bound_by']}; plain {ws['plain_ms']:.2f})")
    return res, counts


# -- training the families the port serves ------------------------------------------

TRAIN_ZOO_ARCHS = (REC_ARCH, XLSTM_ARCH, ENCDEC_ARCH)   # at published widths and depth
TRAIN_ZOO_T0 = 0.8
TRAIN_ZOO_GATE_ROWS = 2            # the gradient gates: 2 x 256 (whisper over 2 x 1500 frames)
TRAIN_ZOO_ROWS = 8                 # the training steps: 8 x 256, remat on
TRAIN_ZOO_STEPS = 3                # timed steps (graph replays), after the capturing step
TRAIN_ZOO_GATE_STEPS = 3           # graph == eager: steps at TRAIN_ZOO_GATE_ROWS rows
# the graph == eager gate's depth: one pattern group of the two 2B models (three copies
# with AMSGrad's three moments, ~42 GB each at full depth, do not fit one card);
# whisper-medium (~15 GB a copy) at its full depth
TRAIN_ZOO_GATE_LAYERS = {REC_ARCH: 6, XLSTM_ARCH: 8}
# the key projection's bias moves every score of a row by one constant, which the
# softmax cancels: its gradient is zero in exact arithmetic, and each path gives
# rounding noise there (~1e-9 of the model's largest |g| on the CPU); held under
# this share of the largest |g| instead of GRAD_TOL of its own
ZERO_GRAD_NOISE = 1e-6
ZERO_GRAD_LEAVES = (".attn.wk.b", ".self_attn.wk.b", ".cross.wk.b")
# remat against no remat, where two identical no-remat backwards already differ (an
# operation whose float32 sums run in a varying order): within this share of the
# parameter's max |g|; everywhere else bitwise
REMAT_NONDET_TOL = 1e-5
# the smoke configs' 3 steps on the card against the CPU. Step 1 (the same weights):
# loss and grad norm within SMOKE_STEP1_RTOL. AdamW's first step follows the sign of
# each gradient, also of one at float32's rounding, so after it an element may differ
# by 2 lr between the devices, and steps 2-3 run on other weights: their losses within
# SMOKE_LOSS_RTOL and grad norms within SMOKE_GNORM_RTOL (xlstm-1.3b's smoke config
# measured 1.07e-3, the other two under 1.2e-6: NVIDIA H100 80GB HBM3, 700 W). Every
# parameter element within 2 x the summed learning rates, and SMOKE_TRAIN_SHARE of all
# elements within 1e-4 of their leaf's max |p| (per leaf the share says little: in
# zamba2's smoke a_log of 4 elements one such element is a quarter)
SMOKE_STEP1_RTOL = 1e-5
SMOKE_LOSS_RTOL = 1e-4
SMOKE_GNORM_RTOL = 1e-2
SMOKE_TRAIN_SHARE = 0.999


def train_zoo_launches(cfg, remat: bool) -> dict:
    """flash_attn launches of one forward and backward: every attention once
    a forward (the backward launches none), twice under remat (the
    checkpointed forward runs again in the backward)."""
    from repro_torch.models.model import layer_kinds
    from repro_torch.models.transformer import ATTN_KINDS

    if cfg.is_encoder_decoder:
        per_fwd = cfg.num_encoder_layers + 2 * cfg.num_layers
    else:
        per_fwd = sum(1 for kind in layer_kinds(cfg) if kind in ATTN_KINDS)
    return {"flash_attn": per_fwd * (2 if remat else 1)} if per_fwd else {}


def train_zoo_batch(cfg, rows, seed, device="cuda"):
    """x_src, x_tgt (rows, SEQ) from numpy ``seed``; whisper's frames as its
    serve phase makes them (``encdec_frames``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, SEQ)).astype(np.int32))
             .to(device) for k in ("x_src", "x_tgt")}
    if cfg.is_encoder_decoder:
        batch["frames"] = encdec_frames(cfg, rows, device=device)
    return batch


def zero_grad_leaves(cfg):
    """The parameters JAX's gradient leaves exactly zero: each ``zshared``
    position's own ``ln1``, which the shared block never reads."""
    from repro_torch.models.model import layer_kinds

    if cfg.is_encoder_decoder:
        return set()
    return {f"blocks.{i}.ln1.{leaf}" for i, kind in enumerate(layer_kinds(cfg))
            if kind == "zshared" for leaf in ("scale", "bias")}


def _grads(model, batch, key, remat):
    """(loss, {name: grad}, flash_attn launches, peak bytes) of one forward
    and backward of the WS-DFM loss; the peak counts from what was allocated
    when it started (the weights, and gradients a caller still holds), so it
    is the forward's saved activations and the new gradients."""
    from repro_torch.convert import jax_leaves
    from repro_torch.core.paths import WarmStartPath
    from repro_torch.kernels import launches
    from repro_torch.training.train_step import loss_and_grads, make_loss_fn

    leaves = jax_leaves(model)
    names = {id(p): n for n, p in model.named_parameters()}
    loss_fn = make_loss_fn(model, model.cfg, WarmStartPath(TRAIN_ZOO_T0), remat=remat)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    launches.clear()
    loss, _, grads = loss_and_grads(loss_fn, model, leaves, batch, key)
    torch.cuda.synchronize()
    flat = {names[id(p)]: g for leaf, ps in leaves.items() for p, g in zip(ps, grads[leaf])}
    return float(loss.detach()), flat, dict(launches), torch.cuda.max_memory_allocated() - base


def check_train_zoo_gradients(model, batch, key):
    """The family's gradient gates at TRAIN_ZOO_GATE_ROWS rows: the kernel
    path against autograd through ``flash_attention_ref`` (every parameter
    within GRAD_TOL of its max |g|; the key biases under ZERO_GRAD_NOISE of
    the largest |g|; no gradient all zero but the leaves JAX leaves zero),
    two no-remat backwards against each other (which parameters vary from run
    to run), remat against no remat (bitwise where no remat is bitwise, else
    within REMAT_NONDET_TOL), and exact flash_attn launches of each."""
    import repro_torch.models.attention as attention
    from repro_torch.kernels.flash_attn import flash_attention_ref

    cfg = model.cfg
    loss, g, counts, peak = _grads(model, batch, key, False)
    if counts != train_zoo_launches(cfg, False):
        fail(f"{cfg.name} gradient gate: launches {counts}, expected "
             f"{train_zoo_launches(cfg, False)}")
    top = max(float(x.abs().max()) for x in g.values())
    zero_want = zero_grad_leaves(cfg) & set(g)
    zero = {n for n, x in g.items() if not bool(x.any())}
    if zero != zero_want or not all(bool(torch.isfinite(x).all()) for x in g.values()):
        fail(f"{cfg.name} gradient gate: all-zero gradients {sorted(zero)}, expected "
             f"{sorted(zero_want)}, or a non-finite one")

    worst, worst_name, noise, loss_plain = 0.0, None, 0.0, None
    if counts:      # without attention (xlstm) the plain path is the same code
        kernel_path = attention.flash_attention
        attention.flash_attention = flash_attention_ref
        try:
            loss_plain, g_plain, counts_plain, _ = _grads(model, batch, key, False)
        finally:
            attention.flash_attention = kernel_path
        if counts_plain:
            fail(f"{cfg.name} gradient gate: the plain path launched {counts_plain}")
    for n, x in (g.items() if counts else ()):
        r = g_plain[n]
        if n.endswith(ZERO_GRAD_LEAVES):
            noise = max(noise, float(x.abs().max()) / top, float(r.abs().max()) / top)
            continue
        if n in zero_want:
            if bool(r.any()):
                fail(f"{cfg.name} gradient gate: {n} is zero on the kernel path only")
            continue
        err = float((x - r).abs().max()) / float(r.abs().max())
        if err > worst:
            worst, worst_name = err, n
    g_plain = None
    if worst > GRAD_TOL or noise > ZERO_GRAD_NOISE:
        fail(f"{cfg.name} gradient gate: {worst_name} off by {worst:.3e} of its max |g| "
             f"(tolerance {GRAD_TOL:g}); key-bias noise {noise:.3e} of the largest |g|")

    loss_2, g_2, _, _ = _grads(model, batch, key, False)
    nondet = {n: float((x - g_2[n]).abs().max()) / max(float(x.abs().max()), 1e-30)
              for n, x in g.items() if not torch.equal(x, g_2[n])}
    del g_2
    loss_r, g_r, counts_r, peak_r = _grads(model, batch, key, True)
    if counts_r != train_zoo_launches(cfg, True):
        fail(f"{cfg.name} remat gate: launches {counts_r}, expected "
             f"{train_zoo_launches(cfg, True)}")
    remat_bitwise = sum(1 for n, x in g.items() if torch.equal(x, g_r[n]))
    remat_worst, remat_name = 0.0, None
    for n, x in g.items():
        err = float((x - g_r[n]).abs().max()) / max(float(x.abs().max()), 1e-30)
        if n not in nondet and err > 0.0 or err > REMAT_NONDET_TOL:
            fail(f"{cfg.name} remat gate: {n} off by {err:.3e} of its max |g| "
                 f"({'varies' if n in nondet else 'bitwise'} from run to run without remat)")
        if err > remat_worst:
            remat_worst, remat_name = err, n
    del g_r, g
    res = {"rows": TRAIN_ZOO_GATE_ROWS, "params": sum(1 for _ in model.parameters()),
           "loss": loss, "loss_plain": loss_plain,
           "loss_second": loss_2, "loss_remat": loss_r,
           "max_rel_err": worst, "worst_param": worst_name, "tolerance": GRAD_TOL,
           "key_bias_noise": noise, "zero_grad_params": sorted(zero),
           "nondeterministic_params": nondet, "remat_bitwise_params": remat_bitwise,
           "remat_max_rel_err": remat_worst, "remat_worst_param": remat_name,
           "launches": counts, "launches_remat": counts_r,
           "peak_above_start_no_remat_bytes": peak, "peak_above_start_remat_bytes": peak_r}
    print(f"{cfg.name} gradient gates ({TRAIN_ZOO_GATE_ROWS} x {SEQ}): loss {loss:.6f} (plain "
          f"{loss_plain}, remat {loss_r:.6f}); worst {worst:.3e} ({worst_name}) of "
          f"{GRAD_TOL:g}; key-bias noise {noise:.2e}; zero {len(zero)}; varying without "
          f"remat {len(nondet)} {sorted(nondet.items(), key=lambda kv: -kv[1])[:3]}; remat "
          f"bitwise {remat_bitwise}/{res['params']}, worst {remat_worst:.3e} ({remat_name}); "
          f"launches {counts} / remat {counts_r}; a backward's peak above its start "
          f"{peak / 2**30:.2f} GiB, remat {peak_r / 2**30:.2f} GiB")
    return res


def _snapshot(model):
    """A few parameters' copies: the embedding, the first and last block's
    weights (cloning all of a 2B model would take 8 GB)."""
    named = dict(model.named_parameters())
    keep = [n for n in named if n.startswith("embed.")][:1]
    blocks = [n for n in named if ".w" in n]
    keep += blocks[:1] + blocks[-1:]
    return {n: named[n].detach().clone() for n in keep}


def train_zoo_steps(model, cfg, key_seed=1):
    """1 capturing + TRAIN_ZOO_STEPS timed steps at TRAIN_ZOO_ROWS x SEQ,
    ``RunConfig(remat="block")``, AdamW, each one CUDA graph replay: the
    decoder-only archs through ``Trainer.fit``, whisper through
    ``jit_train_step(make_train_step(...))`` with its frames (R9: ``fit`` has
    none). Gates finite losses and grad norms, moved weights, exact
    flash_attn launches a step and one capture. Returns the record, the
    state and the jitted step (whose graph a later replay reuses)."""
    from repro_torch import prng
    from repro_torch.core.paths import WarmStartPath
    from repro_torch.kernels import launches
    from repro_torch.optim import build_optimizer
    from repro_torch.training import Trainer, TrainState, jit_train_step, make_train_step

    steps = TRAIN_ZOO_STEPS + 1
    run = _zoo_run(cfg, total_steps=steps, log_every=steps, seed=key_seed)
    before = _snapshot(model)
    gc_collect()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    launches.clear()
    t = time.perf_counter()
    if cfg.is_encoder_decoder:
        opt = build_optimizer(run)
        step = jit_train_step(make_train_step(model, cfg, run, opt, WarmStartPath(TRAIN_ZOO_T0)))
        state = TrainState.create(model, opt)
        events, losses, gnorms = [], [], []
        rng = prng.key(key_seed)
        batches = [train_zoo_batch(cfg, TRAIN_ZOO_ROWS, 100 + i) for i in range(steps)]
        torch.cuda.synchronize()
        for batch in batches:
            rng, sub = prng.split(rng, 2)
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            state, m = step(state, batch, sub)
            losses.append(m["loss"])
            gnorms.append(m["grad_norm"])
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        events[-1].synchronize()
        step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        how = "jit_train_step"
    else:
        trainer = Trainer(model, cfg, run, path=WarmStartPath(TRAIN_ZOO_T0))
        batches = ((b["x_src"].numpy(), b["x_tgt"].numpy())
                   for b in (train_zoo_batch(cfg, TRAIN_ZOO_ROWS, 100 + i, device="cpu")
                             for i in range(steps)))
        state = trainer.fit(trainer.init_state(), batches, steps=steps)
        step_ms = trainer.step_ms()
        losses, gnorms = trainer.step_losses, trainer.step_grad_norms
        step = trainer._step_fn
        how = "Trainer.fit"
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    counts = dict(launches)
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).cpu()
    gnorms = torch.stack(gnorms).cpu()
    per_step = train_zoo_launches(cfg, True)
    want = {k: v * steps for k, v in per_step.items()}
    graphs = step.graphs.stats()
    if counts != want or (graphs["captures"], graphs["replays"]) != (1, steps - 1):
        fail(f"{cfg.name} training: launches {counts}, expected {want}; graphs {graphs}, "
             f"expected one capture and {steps - 1} replays")
    if int(state.step) != steps or not bool(torch.isfinite(losses).all()) \
            or not bool(torch.isfinite(gnorms).all()):
        fail(f"{cfg.name} training: step {int(state.step)}, losses {losses.tolist()}, grad "
             f"norms {gnorms.tolist()}")
    after = dict(model.named_parameters())
    still = [n for n, p in before.items() if torch.equal(p, after[n])]
    if still:
        fail(f"{cfg.name} training: {still} did not move")
    return {"how": how, "steps": steps, "step_ms": step_ms, "wall_s": wall_s,
            "capture_step_ms": step_ms[0], "graphs": graphs,
            "losses": losses.tolist(), "grad_norms": gnorms.tolist(), "launches": counts,
            "launches_per_step": per_step, "peak_bytes": peak, "allocated_before_bytes": base,
            "state": state, "step_fn": step}


def events_ms(fn) -> float:
    """``fn``'s time on the card's clock (CUDA events around it)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def gc_collect():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def train_zoo_family(arch):
    """One family at its published widths and depth (float32, seed 0): the
    gradient gates at 2 rows, the graphed training steps at 8, the busy
    share of a graph replay, an eager step's ms, then the graph == eager
    gate (TRAIN_ZOO_GATE_STEPS steps at 2 rows; zamba2-2.7b and xlstm-1.3b
    cut to TRAIN_ZOO_GATE_LAYERS, one pattern group each, since three
    full-depth copies with AMSGrad moments do not fit one card; whisper-medium
    at full depth)."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    t_family = time.perf_counter()
    cfg = get_config(arch).replace(dtype="float32")     # the configs compute in bfloat16
    model = build_model(cfg, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    res = {"config": cfg.name, "params": n_params, "seq_len": SEQ, "t0": TRAIN_ZOO_T0,
           "optimizer": "adamw, amsgrad, float32 moments, weight decay 0.1",
           "remat": "block (a scanned group; an encoder or decoder block)"}
    res["grad_gate"] = check_train_zoo_gradients(
        model, train_zoo_batch(cfg, TRAIN_ZOO_GATE_ROWS, 0), prng.key(0))
    gc_collect()
    tr = train_zoo_steps(model, cfg)
    state = tr.pop("state")
    step_fn = tr.pop("step_fn")
    timed = tr["step_ms"][1:]
    median_ms = statistics.median(timed)
    tokens = TRAIN_ZOO_ROWS * SEQ
    model_flops = 6 * n_params * tokens
    res.update(tr)
    res.update({"rows": TRAIN_ZOO_ROWS, "first_step_ms": tr["step_ms"][0],
                "median_step_ms": median_ms, "tokens_per_s": tokens / median_ms * 1e3,
                "model_flops_per_step": model_flops,
                "model_flop_share": model_flops / (median_ms / 1e3) / F32_OPS_PER_S})
    if cfg.is_encoder_decoder:
        enc = sum(p.numel() for n, p in model.named_parameters() if n.startswith("enc_blocks."))
        frames = TRAIN_ZOO_ROWS * cfg.num_audio_frames
        with_frames = 6 * (enc * frames + (n_params - enc) * tokens)
        res.update({"encoder_params": enc, "frames": frames,
                    "model_flops_with_frames": with_frames,
                    "model_flop_share_with_frames":
                        with_frames / (median_ms / 1e3) / F32_OPS_PER_S})
    # one more step under the profiler, a replay of the training's graph: the device's
    # busy share; then (the graph's pool released) an eager step on CUDA events, its
    # yardstick (under the profiler xlstm-1.3b's 192k eager kernels took 26 s to trace)
    batch = train_zoo_batch(cfg, TRAIN_ZOO_ROWS, 200)
    held = {"state": state}

    def one_step(step):
        def run():
            held["state"], _ = step(held["state"], batch, prng.key(7))
        return run

    t = time.perf_counter()
    res["busy_graphed"] = trace_busy_share(one_step(step_fn), f"{cfg.name}'s train step "
                                           "(a graph replay)")
    res["busy_graphed"]["profile_s"] = time.perf_counter() - t
    if step_fn.graphs.replays != TRAIN_ZOO_STEPS + 1:
        fail(f"{cfg.name}: the profiled step did not replay the training's graph")
    eager = step_fn.step
    del step_fn
    gc_collect()
    res["eager_step_ms"] = events_ms(one_step(eager))
    del held, state, eager, batch, model
    gc_collect()
    res["graph_gate"] = train_zoo_graph_gate(cfg)
    res["seconds"] = time.perf_counter() - t_family
    print(f"{cfg.name} training ({n_params / 1e9:.3f}B params, {TRAIN_ZOO_ROWS} x {SEQ}, remat, "
          f"{res['how']}, one graph replay a step): capturing step {res['first_step_ms']:.1f} "
          f"ms, a replay's median {median_ms:.1f} ms (an eager step {res['eager_step_ms']:.1f} "
          f"ms; under the profiler a replay {res['busy_graphed']['wall_ms']:.1f} ms, "
          f"{res['busy_graphed']['busy_share']} busy; the "
          f"gate's steps at {TRAIN_ZOO_GATE_ROWS} rows, {res['graph_gate']['layers']} layers: "
          f"eager {res['graph_gate']['eager']['step_ms']} ms, graphed "
          f"{res['graph_gate']['graphed']['step_ms']} ms) "
          f"({res['tokens_per_s']:.0f} tokens/s, model-FLOP share {res['model_flop_share']:.1%} "
          f"of 67 TFLOP/s), peak {res['peak_bytes'] / 2**30:.2f} GiB; losses "
          f"{[round(x, 4) for x in res['losses']]}; launches {res['launches']}; "
          f"{res['seconds']:.1f} s")
    return res


def train_zoo_graph_gate(cfg):
    """:func:`train_graph_gate` at the family's published widths:
    TRAIN_ZOO_GATE_STEPS steps of TRAIN_ZOO_GATE_ROWS x SEQ with remat and
    the families' AdamW, zamba2-2.7b and xlstm-1.3b at TRAIN_ZOO_GATE_LAYERS
    layers, whisper-medium at its full depth."""
    from repro_torch.models import build_model

    layers = TRAIN_ZOO_GATE_LAYERS.get(cfg.name)
    gcfg = cfg.replace(num_layers=layers) if layers else cfg
    model = build_model(gcfg, device="cuda", seed=0)
    batches = [train_zoo_batch(gcfg, TRAIN_ZOO_GATE_ROWS, 300 + i)
               for i in range(TRAIN_ZOO_GATE_STEPS)]
    res = train_graph_gate(f"{cfg.name} ({gcfg.num_layers} layers) train step", model,
                           _zoo_run(gcfg, total_steps=TRAIN_ZOO_GATE_STEPS), batches)
    del model, batches
    gc_collect()
    res["layers"] = gcfg.num_layers
    return res


def _zoo_run(cfg, **kw):
    """The families' RunConfig: RunConfig's AdamW (AMSGrad, weight decay 0.1,
    warmup_cosine(3e-4, 100, ...)), clipping at 1, remat on."""
    from repro_torch.configs.base import RunConfig

    return RunConfig(arch=cfg.name, t0=TRAIN_ZOO_T0, batch_size=TRAIN_ZOO_ROWS, remat="block",
                     **kw)


def check_train_zoo_smoke_against_cpu(archs=TRAIN_ZOO_ARCHS):
    """Each family's smoke config (seed 0, remat, AdamW, lr 1e-3 after one
    warm-up step) trained 3 steps at 2 x 24 on the card, eager and graphed
    (``jit_train_step``: one capture, two replays), and on the CPU from the
    same weights, batches (and frames) and keys: each card run's losses,
    grad norms and parameters against the CPU's within the SMOKE_*
    tolerances (an MoE config's loss with its router's auxiliary term), and
    the graphed run against the eager one by :func:`check_graph_equals_eager`
    (a second eager run says what varies run to run)."""
    import copy

    import numpy as np
    from repro_torch import prng
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import build_model
    from repro_torch.optim import build_optimizer
    from repro_torch.training import TrainState, jit_train_step, make_train_step

    res = {}
    for arch in archs:
        cfg = get_smoke_config(arch)
        run = RunConfig(arch=arch, t0=TRAIN_ZOO_T0, learning_rate=1e-3, warmup_steps=1,
                        total_steps=3, remat="block")
        host = build_model(cfg, device="cpu", seed=0)
        rng = np.random.default_rng(3)
        batches = [{k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24))
                                        .astype(np.int32)) for k in ("x_src", "x_tgt")}
                   for _ in range(3)]
        if cfg.is_encoder_decoder:
            for b in batches:
                b["frames"] = encdec_frames(cfg, 2, device="cpu")
        if cfg.family == "vlm":
            from repro_torch.models.rope import vlm_positions

            for b in batches:
                b["patches"] = vlm_patches(cfg, 2, device="cpu")
                b["positions"] = vlm_positions(2, VLM_SMOKE_GRID, 24)
        out, graphs = {}, None
        for name in ("cuda", "cuda_again", "graph", "cpu"):
            dev = "cpu" if name == "cpu" else "cuda"
            model = host if name == "cpu" else copy.deepcopy(host).to("cuda")
            opt = build_optimizer(run)
            step = make_train_step(model, cfg, run, opt)
            if name == "graph":
                step = jit_train_step(step)
            state = TrainState.create(model, opt)
            metrics = []
            for i, b in enumerate(batches):
                state, m = step(state, {k: v.to(dev) for k, v in b.items()}, prng.key(i))
                metrics.append(torch.stack([m["loss"], m["grad_norm"]]))
            if name == "graph":
                graphs = step.graphs.stats()
            out[name] = (torch.stack(metrics).cpu(),
                         {k: v.cpu() for k, v in train_leaves(state).items()})
        sched = build_optimizer(run).learning_rate
        bound = 2 * sum(sched(i) for i in (1, 2, 3))

        def vs_cpu(name):
            # per step: (loss, grad norm) relative errors
            errs = [tuple(abs(float(a) - float(b)) / abs(float(b)) for a, b in zip(ma, mb))
                    for ma, mb in zip(out[name][0], out["cpu"][0])]
            worst_share, worst_diff, within, total = 1.0, 0.0, 0, 0
            for (kind, n), p in out["cpu"][1].items():
                if kind != "param":
                    continue
                diff = (out[name][1][(kind, n)] - p).abs()
                worst_diff = max(worst_diff, float(diff.max()))
                close = int((diff <= 1e-4 * float(p.abs().max())).sum())
                within, total = within + close, total + p.numel()
                worst_share = min(worst_share, close / p.numel())
            share = within / total
            rec = {"rel_errs_loss_grad_norm": errs, "param_max_abs_diff": worst_diff,
                   "param_bound": bound, "param_share_within_1e-4": share,
                   "param_worst_leaf_share_within_1e-4": worst_share,
                   "losses_card": [float(m[0]) for m in out[name][0]],
                   "losses_cpu": [float(m[0]) for m in out["cpu"][0]]}
            steps_txt = [tuple(f"{e:.2e}" for e in st) for st in errs]
            print(f"{cfg.name} trained 3 steps on the card ({'graphed' if name == 'graph' else 'eager'}) "
                  f"vs the CPU: (loss, grad norm) relative errors a step {steps_txt}; parameters "
                  f"max |diff| {worst_diff:.2e} (bound {bound:.2e}), {share:.6f} of the elements "
                  f"within 1e-4 of their leaf's max (worst leaf {worst_share:.4f})")
            if max(errs[0]) > SMOKE_STEP1_RTOL or any(
                    le > SMOKE_LOSS_RTOL or ge > SMOKE_GNORM_RTOL for le, ge in errs[1:]) \
                    or worst_diff > bound or share < SMOKE_TRAIN_SHARE:
                fail(f"{cfg.name}: 3 steps on the card ({name}) disagree with the CPU: {rec}")
            return rec

        res[arch] = vs_cpu("cuda")
        res[arch]["graph_vs_cpu"] = vs_cpu("graph")
        res[arch]["graph_gate"] = check_graph_equals_eager(
            f"{cfg.name} train step", out["graph"], out["cuda"],
            run_to_run(out["cuda"], out["cuda_again"]), bound)
        res[arch]["graphs"] = graphs
        if (graphs["captures"], graphs["replays"]) != (1, 2):
            fail(f"{cfg.name}: 3 graphed train steps made {graphs}, expected one capture and "
                 f"two replays")
    return res


def check_launch_train_smoke():
    """``python -m repro_torch.launch.train --arch A --smoke --steps 3`` for
    the two decoder-only families, both processes at once: each exits 0."""
    import os
    import tempfile

    procs, res = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        t = time.perf_counter()
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        for arch in (REC_ARCH, XLSTM_ARCH):
            cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch, "--smoke",
                   "--steps", "3", "--checkpoint-dir", str(pathlib.Path(tmp) / arch)]
            procs[arch] = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)
        for arch, p in procs.items():
            out, _ = p.communicate(timeout=300)
            res[arch] = {"rc": p.returncode, "tail": out.strip().splitlines()[-2:]}
        res["seconds"] = time.perf_counter() - t
    print(f"launch.train --smoke --steps 3: {res}")
    if any(res[a]["rc"] != 0 for a in procs):
        fail(f"launch.train on a recurrent smoke config failed: {res}")
    return res


def train_zoo_path():
    """Train every family the port serves at its published widths and depth
    (zamba2-2.7b, xlstm-1.3b, whisper-medium, float32): the gradient gates,
    the training steps, a step's busy share; the smoke configs card == CPU;
    the launcher on the decoder-only families. Returns ({"train_zoo": ...}
    record, its flash_attn launches)."""
    t0 = time.perf_counter()
    gc_collect()
    res = {"held_at_start_bytes": torch.cuda.memory_allocated()}
    print(f"train_zoo: {res['held_at_start_bytes'] / 2**30:.2f} GiB held by earlier phases")
    for arch in TRAIN_ZOO_ARCHS:
        res[arch] = train_zoo_family(arch)
    res["smoke_vs_cpu"] = check_train_zoo_smoke_against_cpu()
    res["launch_train"] = check_launch_train_smoke()
    res["phase_seconds"] = time.perf_counter() - t0
    counts = {"flash_attn": sum(res[a]["launches"].get("flash_attn", 0)
                                + res[a]["grad_gate"]["launches"].get("flash_attn", 0) * 2
                                + res[a]["grad_gate"]["launches_remat"].get("flash_attn", 0)
                                for a in TRAIN_ZOO_ARCHS)}
    print(f"train_zoo phase: {res['phase_seconds']:.1f} s")
    return res, counts


# -- the README's torch quickstart and the torch examples ----------------------------

EXAMPLES = ("quickstart_torch", "serve_pipeline_torch", "text_generation_torch",
            "image_refinement_torch")
# the four that train at a third of their twins' --steps (serve_pipeline at 150 of 250):
# at 300 quickstart and text_generation took 33.4 s and 73.8 s of the 186.1 s the five
# took, and at 150 (serve_pipeline at 250) the five still took 144.9-150.9 s (NVIDIA H100
# 80GB HBM3, 700 W); the training phase runs the moons study at its full 300 steps
EXAMPLE_ARGS = {"quickstart_torch": ["--steps", "100"],
                "serve_pipeline_torch": ["--steps", "150"],
                "text_generation_torch": ["--steps", "100"],
                "image_refinement_torch": ["--steps", "100"]}
# a headline's name -> (regex, its group's type); ``examples_path`` fails where a
# line is missing, and gates the NFEs against warm_nfe
EXAMPLE_HEADLINES = {
    "readme_quickstart_torch": {
        "micro_batches": (r"batch: 6 requests in (\d+) micro-batches", int),
        "nfe": (r"NFE (\d+)/16 per request", int),
        "stream_wall_s": (r"of ([\d.]+)s total", float),
        "slo_attainment_pct": (r"SLO attainment (\d+)%", int)},
    "quickstart_torch": {
        "skl_cold": (r"cold DFM: SKL=([-\d.]+)", float),
        "nfe_cold": (r"cold DFM: .* warm_nfe=(\d+)", int),
        "skl_warm": (r"WS-DFM:  SKL=([-\d.]+)", float),
        "nfe_warm": (r"WS-DFM: .* warm_nfe=(\d+)", int)},
    "serve_pipeline_torch": {
        "server_nfe": (r"request batch 2 \(n=16\): nfe=(\d+)/40", int),
        "server_draft_ms_n16": (r"request batch 2 \(n=16\): .* draft=(\d+)ms", int),
        "server_flow_ms_n16": (r"request batch 2 \(n=16\): .* flow=(\d+)ms", int),
        "scheduler_requests_per_s": (r"12 requests -> \d+ micro-batches, ([\d.]+) req/s", float),
        "adaptive_mean_nfe": (r"mean NFE ([\d.]+)", float)},
    "text_generation_torch": {
        "nll_lstm": (r"LSTM draft  NLL=([-\d.]+)", float),
        "nll_cold": (r"cold DFM    NLL=([-\d.]+)", float),
        "nfe_cold": (r"cold DFM .* NFE=(\d+)", int),
        "nll_warm": (r"WS-DFM      NLL=([-\d.]+)", float),
        "nfe_warm": (r"WS-DFM .* NFE=(\d+)", int)},
    "image_refinement_torch": {
        "fid_draft": (r"draft FID-proxy: ([-\d.]+)", float),
        "fid_cold": (r"cold  FID-proxy: ([-\d.]+)", float),
        "nfe_cold": (r"cold  FID-proxy: [-\d.]+  NFE=(\d+)", int),
        "fid_warm": (r"warm  FID-proxy: ([-\d.]+)", float),
        "nfe_warm": (r"warm  FID-proxy: [-\d.]+  NFE=(\d+)", int)},
}
EXAMPLE_NFES = {"readme_quickstart_torch": {"nfe": (16, 0.8)},
                "quickstart_torch": {"nfe_cold": (20, 0.0), "nfe_warm": (20, 0.8)},
                "serve_pipeline_torch": {"server_nfe": (40, 0.8)},
                "text_generation_torch": {"nfe_cold": (64, 0.0), "nfe_warm": (64, 0.8)},
                "image_refinement_torch": {"nfe_cold": (48, 0.0), "nfe_warm": (48, 0.5)}}


def readme_torch_snippet() -> str:
    """The README's executable torch quickstart, as the driver of the docs
    extracts the JAX one."""
    import re

    text = (ROOT / "README.md").read_text(encoding="utf-8")
    region = text.split("<!-- quickstart-torch:begin -->", 1)[1]
    region = region.split("<!-- quickstart-torch:end -->", 1)[0]
    return re.search(r"```python\n(.*?)```", region, re.DOTALL).group(1)


def examples_path():
    """The README's torch quickstart and the four ``examples/*_torch.py`` on
    the card (``--device cuda``, their defaults but EXAMPLE_ARGS), one
    subprocess each, all five at once (as ``check_launch_train_smoke`` runs
    its two: the phase took 74.5-87.7 s one after the other): each must exit
    0, print its headline lines and the NFEs ``warm_nfe`` guarantees. Returns
    the {"examples": ...} record; each one's seconds ran beside the others."""
    import os
    import re
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core.guarantees import warm_nfe

    res = {}
    t_phase = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        snippet = pathlib.Path(tmp) / "readme_quickstart_torch.py"
        snippet.write_text(readme_torch_snippet(), encoding="utf-8")
        runs = [("readme_quickstart_torch", snippet)] + [
            (name, ROOT / "examples" / f"{name}.py") for name in EXAMPLES]

        def run(name_path):
            name, path = name_path
            t = time.perf_counter()
            p = subprocess.run([sys.executable, str(path), *EXAMPLE_ARGS.get(name, [])],
                               cwd=ROOT, env=env, text=True,
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=600)
            return p, time.perf_counter() - t

        with ThreadPoolExecutor(max_workers=len(runs)) as pool:
            done = list(pool.map(run, runs))
        for (name, _), (p, seconds) in zip(runs, done):
            if p.returncode != 0:
                fail(f"{name} exited {p.returncode}:\n{p.stdout[-3000:]}")
            heads = {}
            for key, (pattern, kind) in EXAMPLE_HEADLINES[name].items():
                m = re.search(pattern, p.stdout)
                if m is None:
                    fail(f"{name}: no line matches {pattern!r}:\n{p.stdout[-3000:]}")
                heads[key] = kind(m.group(1))
            for key, (cold_nfe, t0) in EXAMPLE_NFES[name].items():
                if heads[key] != warm_nfe(cold_nfe, t0):
                    fail(f"{name}: {key} {heads[key]}, guaranteed {warm_nfe(cold_nfe, t0)}")
            if name == "serve_pipeline_torch":
                heads["server_samples_per_s_n16"] = 16 / (
                    (heads["server_draft_ms_n16"] + heads["server_flow_ms_n16"]) / 1e3)
            res[name] = {"seconds": seconds, **heads}
            print(f"{name}: exit 0 in {seconds:.1f} s; {heads}")
    res["phase_seconds"] = time.perf_counter() - t_phase
    print(f"examples phase: {res['phase_seconds']:.1f} s")
    return res


def _category(name: str) -> str:
    if "flash_attn_kernel" in name:
        return "flash_attn"
    if "ws_step_kernel" in name or "ws_step_dkey_kernel" in name:
        return "ws_step"
    if "ws_step_rows_kernel" in name:
        return "ws_step_rows"
    if "ws_step_gumbel_kernel" in name or "ws_step_gumbel_dkey_kernel" in name:
        return "ws_step_gumbel"
    if "ws_fused_kernel" in name:
        return "ws_fused"
    if "qkv_rope_kernel" in name:
        return "qkv_rope"
    if "attn_cached_kernel" in name or "attn_cached_solo_kernel" in name:
        return "attn_cached"
    if "post_attn_proj_kernel" in name:     # post_attn's three projections
        return "post_attn"
    if "proj_kernel" in name:               # the head's projection, head_proj_kernel
        return "head"
    if "gemm" in name.lower() or "cutlass" in name.lower():
        return "matmul"
    return "other"


def profile_serve(server, key):
    """One more serve under ``torch.profiler``: device time by kernel and
    the device's busy share of the serve's wall time (profiler on)."""
    holder = {}

    def run():
        holder["rep"] = server.serve(key, NUM)[1]

    res = _profile(run, "serve")
    if res.get("device_ms") is not None:
        res["flow_ms"] = holder["rep"]["flow_time_s"] * 1e3
        res["draft_ms"] = holder["rep"]["draft_time_s"] * 1e3
    return res


def profile_draft(engine, key, prompt, eager=False):
    """The draft stage alone (one ``generate_rows``, prefix reused: one decode
    graph replay, or with ``eager`` its eager launches) under
    ``torch.profiler``: its device time by kernel and busy share."""
    from repro_torch import prng

    gen = engine._generate_rows_eager if eager else engine.generate_rows

    def run():
        gen(prng.split(key, NUM), SEQ, prompt)
        torch.cuda.synchronize()

    return _profile(run, "draft stage" + (" (eager launches)" if eager else " (graph)"))


def _profile(run, what):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: a host op (aten::mm) also carries its kernels' device time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        print(f"profile of the {what}: the trace holds no device time (not measured)")
        return {"device_ms": None}
    device_ms = sum(ms for _, ms, _ in rows)
    by_cat, n_by_cat = {}, {}
    for name, ms, count in rows:
        by_cat[_category(name)] = by_cat.get(_category(name), 0.0) + ms
        n_by_cat[_category(name)] = n_by_cat.get(_category(name), 0) + count
    top = sorted(rows, key=lambda r: -r[1])[:8]
    n_launch = sum(c for _, _, c in rows)
    print(f"profile of the {what}: device busy {device_ms:.1f} ms of {wall_ms:.1f} ms wall "
          f"({device_ms / wall_ms:.1%}), {n_launch} kernel launches; by kind "
          + json.dumps({k: round(v, 3) for k, v in by_cat.items()}))
    for name, ms, count in top:
        print(f"  {ms:9.3f} ms  x{count:<5d} {name[:100]}")
    return {"device_ms": device_ms, "wall_ms": wall_ms, "busy_share": device_ms / wall_ms,
            "kernel_launches": n_launch, "by_kind_ms": by_cat, "by_kind_launches": n_by_cat,
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
    usage = ptxas_usage(_build.build_log)
    # flash_attn at head dims 16, 32, 64, 80, 128, 256 and (q/k, v) (192, 128) and (48, 32);
    # qkv_rope at 16, 32, 64, 128; attn_cached at
    # each of those x up to 4 and 16 pairs a cluster, and one pair a block (solo);
    # post_attn's wo, down, up and gated up,
    # each whole and staged; the head at
    # 1, 2, 4, 8 rows a block, row-major and tied; ws_step and
    # ws_step_rows at 2, 4, 8, 16, 32 lanes a row; ws_step_gumbel at each of those with
    # the noise given and keyed; ws_fused at each with lg in registers and re-read; the
    # device-key ws_step and keyed ws_step_gumbel (the refine graphs' steps) at each G
    for kernel, count in (("flash_attn_kernel", 8), ("post_attn_proj_kernel", 8),
                          ("qkv_rope_kernel", 4), ("attn_cached_kernel", 8),
                          ("attn_cached_solo_kernel", 4),
                          ("head_proj_kernel", 8),
                          ("ws_step_kernel", 5), ("ws_step_rows_kernel", 5),
                          ("ws_step_gumbel_kernel", 10), ("ws_fused_kernel", 10),
                          ("ws_step_dkey_kernel", 5), ("ws_step_gumbel_dkey_kernel", 5)):
        found = {k: v for k, v in usage.items() if kernel in k}
        print(f"{kernel}: spill bytes {[v.get('spill') for v in found.values()]}, registers "
              f"{[v.get('registers') for v in found.values()]}")
        if len(found) != count or any(v.get("spill") != 0 for v in found.values()):
            fail(f"{kernel} must build its {count} instantiations without spills: {found}")
    _build.library()
    failed_capture = check_failed_capture_recovers()

    ws_checks = [check_ws_step(8192, 27, 1.0, 0), check_ws_step(64, 50257, 1.0, 1),
                 check_ws_step(64, 50257, 0.7, 2), check_ws_step(64, 262144, 1.0, 3)]
    flash_errs = [check_flash(32, SEQ, 12, 12, 64, False, None, 0),
                  check_flash(2, 200, 8, 2, 64, True, None, 1),
                  check_flash(2, 300, 4, 4, 32, False, 37, 2),
                  check_flash(1, 130, 4, 4, 128, True, 50, 3),
                  check_flash(2, 100, 4, 4, 64, False, None, 4, t=300),   # S != T
                  check_flash(2, 77, 8, 2, 64, True, None, 5),     # tail not a multiple of 16
                  check_flash(2, SEQ, 4, 4, 128, False, None, 6),  # D = 128, bidirectional
                  check_flash(2, SEQ, 4, 4, 64, False, 5, 7),      # band narrower than a tile
                  check_flash(3, 1, 2, 1, 32, False, None, 8)]     # S = 1
    draft_errs = [check_draft_kernels(case, i) for i, case in enumerate(DRAFT_CASES)]
    attn_errs = check_attn_cases()
    attn_invariance = {f"H={h} KH={kh} hd={hd}": check_attn_batch_invariance(h, kh, hd, 200 + i)
                       for i, (h, kh, hd) in enumerate(ATTN_INVARIANCE)}
    rows_checks = [check_ws_step_rows(NUM, SEQ, VOCAB, 0), check_ws_step_rows(4, 16, 50257, 1)]
    fused_checks = [check_ws_fused(layout, k, v, 10 * k + i)
                    for layout in ("single", "rows") for k in FUSED_KS
                    for i, v in enumerate(FUSED_VS)]
    gumbel_checks = [check_ws_step_gumbel(NUM * SEQ, VOCAB, VOCAB, 0),
                     check_ws_step_gumbel(8, 128, VOCAB, 1),
                     check_ws_step_gumbel(64, 50257, 50257, 2),
                     check_ws_step_gumbel(8, 262144, 262144, 3)]
    keyed_checks = [check_ws_step_gumbel_keyed(NUM * SEQ, VOCAB, 0),
                    check_ws_step_gumbel_keyed(64, 50257, 1),
                    check_ws_step_gumbel_keyed(8, 262144, 2)]
    fused_lanes_checks = [check_ws_fused_lanes(layout, k, b, n, v, 40 + k)
                          for layout in ("single", "rows")
                          for k, b, n, v in ((4, NUM, SEQ, VOCAB), (3, 8, 64, 200),
                                             (2, 2, 8, 50257), (2, 3, 7, 5))]
    lanes_checks = [check_ws_lanes(NUM * SEQ, VOCAB, 0), check_ws_lanes(64, 50257, 1)]
    key_checks = [check_device_keys(NUM * SEQ, VOCAB, 0), check_device_keys(64, 50257, 1)]
    ws_num = measure_ws_step(NUM * SEQ, VOCAB)
    lanes_num = measure_ws_lanes(NUM * SEQ, VOCAB)
    print(f"ws_step at ({NUM * SEQ}, {VOCAB}): {ws_num['ms'] * 1e3:.2f} us device with the key "
          f"read on the card (the serve's refine graph), {ws_num['byvalue_ms'] * 1e3:.2f} us "
          f"with its words by value (bound {ws_num['bound_ms'] * 1e3:.3f} us, "
          f"{ws_num['bound_by']}; plain {ws_num['plain_ms'] * 1e3:.1f} us)")
    floor_ms = launch_floor_ms()
    print(f"launch floor (graph of one-element adds): {floor_ms * 1e3:.2f} us device a launch")
    gumbel_num = measure_ws_step_gumbel(NUM * SEQ, VOCAB)
    rows_num = measure_ws_step_rows(NUM, SEQ, VOCAB)
    fused_num = measure_ws_fused(NUM, SEQ, VOCAB, 4)
    fused_big = measure_ws_fused(2, 32, 50257, 4)
    fused_num["v50257"] = fused_big
    print(f"ws_step_rows at ({NUM}, {SEQ}, {VOCAB}): {rows_num['ms'] * 1e3:.2f} us device "
          f"(bound {rows_num['bound_ms'] * 1e3:.2f} us, {rows_num['bound_by']})")
    for (r_, v_), num in (((NUM * SEQ, VOCAB), fused_num), ((64, 50257), fused_big)):
        print(f"ws_fused K=4 per-row keys at ({r_}, {v_}): {num['ms'] * 1e3:.2f} us device; "
              f"a graph of 4 ws_step launches {num['ws_step_graph_ms'] * 1e3:.2f} us, of 4 "
              f"one-step ws_fused launches {num['composed_ms'] * 1e3:.2f} us (bound "
              f"{num['bound_ms'] * 1e3:.3f} us, {num['bound_by']})")
    flash_num = measure_flash(NUM, SEQ, 12, 64)
    draft_num = measure_draft_kernels()

    check_small_serve_against_cpu()
    check_engine_equals_oracle()
    check_lstm_draft()
    small_pipe = check_small_pipeline_against_cpu()
    engine = draft_engine()
    check_prefill_equals_scan(engine)
    check_draft_logits_against_cpu(engine)
    counts, per_serve, serve, model = main_path(engine)
    sched, sched_counts = scheduler_path(model, engine)
    pipe, pipe_counts = pipeline_path(model)
    pipe["small_vs_cpu"] = small_pipe
    del model
    torch.cuda.empty_cache()
    train, train_counts, trained = train_path()
    policy, probe, cal = policy_path(trained, engine)
    policy["failed_capture"] = failed_capture
    distilled = distilled_path(trained, engine, probe, cal)
    del trained, engine
    torch.cuda.empty_cache()

    t_zoo = time.perf_counter()
    zoo_errs = zoo_kernel_gates()
    zoo_num = zoo_measure()
    zoo, zoo_counts = zoo_path()
    zoo["gemma3_1b_logits"] = check_gemma_logits()
    zoo["smoke_vs_cpu"] = check_zoo_smoke_against_cpu()
    zoo["kernel_errors"] = zoo_errs
    zoo["phase_seconds"] = time.perf_counter() - t_zoo
    print(f"zoo phases (kernel gates, measurements, {ZOO_ARCH} serve, gemma3-1b logits, "
          f"smoke configs): {zoo['phase_seconds']:.1f} s")
    recurrent, rec_counts = recurrent_path()
    encdec, encdec_counts = encdec_path()
    moe, moe_counts = moe_path()
    mla, mla_counts = mla_path()
    vlm, vlm_counts = vlm_path()
    train_zoo, train_zoo_counts = train_zoo_path()
    examples = examples_path()

    breakdown = {
        "flash_attn_ms_per_nfe": per_serve["flash_attn"] / per_serve["ws_step"] * flash_num["ms"],
        "ws_step_ms_per_nfe": ws_num["ms"],
    }
    breakdown["rest_ms_per_nfe"] = (serve["per_nfe_ms"] - breakdown["flash_attn_ms_per_nfe"]
                                    - breakdown["ws_step_ms_per_nfe"])
    serve["breakdown_from_kernel_times"] = breakdown
    serve["draft_kernel_ms_per_serve"] = {
        name: per_serve[name] * draft_num[name]["ms"] for name in DRAFT_KERNELS}
    serve["draft_bound_ms_per_serve"] = sum(
        per_serve[name] * draft_num[name]["bound_ms"] for name in DRAFT_KERNELS)
    kernels = [
        {"name": "ws_step", "route": "cuda", "source": "src/repro_torch/csrc/ws_step.cu",
         "replaces": "src/repro/kernels/ws_step/kernel.py:213",
         "tpu_kernel": "ws_step_streamed_pallas",
         "launches": counts.get("ws_step", 0), "launches_per_serve": per_serve["ws_step"],
         "max_abs_err": max(c["max_abs_err"] for c in ws_checks),
         "mismatches": sum(c["mismatches"] for c in ws_checks),
         "near_ties": sum(c["near_ties"] for c in ws_checks),
         "shape": [NUM * SEQ, VOCAB], **ws_num,
         "bound_us": ws_num["bound_ms"] * 1e3, "lanes": lanes_checks[0]["lanes"],
         "ms_by_lanes": lanes_num["ws_step"],
         "byvalue_ms_by_lanes": lanes_num["ws_step_byvalue"], "lanes_checks": lanes_checks,
         "device_key_checks": key_checks},
        {"name": "flash_attn", "route": "cuda", "source": "src/repro_torch/csrc/flash_attn.cu",
         "replaces": "src/repro/kernels/flash_attn/kernel.py:94",
         "tpu_kernel": "flash_attention_pallas",
         "launches": counts.get("flash_attn", 0), "launches_per_serve": per_serve["flash_attn"],
         "launches_train": train_counts["flash_attn"],
         "launches_policy": policy["launches"]["flash_attn"],
         "launches_distilled": distilled["launches"].get("flash_attn", 0),
         "launches_per_train_step": train["launches_per_step"]["flash_attn"],
         "max_abs_err": max(flash_errs), "max_err": max(flash_errs),
         "shape": [NUM, SEQ, 12, 64], **flash_num,
         "bound_us": flash_num["bound_ms"] * 1e3},
    ]
    lines = {"qkv_rope": 210, "attn_cached": 249, "post_attn": 279, "head": 314}
    for name in DRAFT_KERNELS:
        kernels.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/csrc/draft_decode.cu",
            "replaces": f"src/repro/kernels/draft_decode/kernel.py:{lines[name]}",
            "tpu_kernel": f"{name}_pallas",
            "launches": counts.get(name, 0), "launches_per_serve": per_serve[name],
            "max_abs_err": max(e[name]["abs"] for e in draft_errs),
            "tolerance": ("1e-5 abs" if name == "attn_cached"
                          else "1e-4 x max(1, max|plain|)"),
            **draft_num[name], "bound_us": draft_num[name]["bound_ms"] * 1e3})
    attn = next(k for k in kernels if k["name"] == "attn_cached")
    attn["max_abs_err"] = max(attn["max_abs_err"], *attn_errs.values())
    attn["cases"] = attn_errs
    attn["batch_invariance_differing"] = attn_invariance
    kernels += [
        {"name": "ws_step_rows", "route": "cuda", "source": "src/repro_torch/csrc/ws_step.cu",
         "replaces": "src/repro/kernels/ws_step/kernel.py:213",
         "tpu_kernel": "ws_step_streamed_pallas (the scheduler's per-row mode; XLA in the "
                       "JAX package, core/sampler.py:73)",
         "launches": sched_counts["ws_step_rows"],
         "launches_per_run": sched["launches_per_run"].get("ws_step_rows", 0),
         "launches_distilled": distilled["launches"].get("ws_step_rows", 0),
         "max_abs_err": max(c["max_abs_err"] for c in rows_checks),
         "mismatches": sum(c["mismatches"] for c in rows_checks),
         "near_ties": sum(c["near_ties"] for c in rows_checks),
         "shape": [NUM, SEQ, VOCAB], **rows_num, "bound_us": rows_num["bound_ms"] * 1e3,
         "lanes": lanes_checks[0]["lanes"], "ms_by_lanes": lanes_num["ws_step_rows"]},
        {"name": "ws_fused", "route": "cuda", "source": "src/repro_torch/csrc/ws_fused.cu",
         "replaces": "src/repro/kernels/ws_fused/kernel.py:142",
         "tpu_kernel": "ws_fused_streamed_pallas",
         "launches": sched_counts["ws_fused"],
         "max_abs_err": max(c["max_abs_err"] for c in fused_checks),
         "vs_composed": sum(c["vs_composed"] for c in fused_checks),
         "mismatches": sum(c["mismatches"] for c in fused_checks),
         "near_ties": sum(c["near_ties"] for c in fused_checks),
         "shape": [NUM * SEQ, VOCAB], "k": 4, **fused_num,
         "bound_us": fused_num["bound_ms"] * 1e3, "lanes_checks": fused_lanes_checks},
        {"name": "ws_step_gumbel", "route": "cuda", "source": "src/repro_torch/csrc/ws_step.cu",
         "replaces": "src/repro/kernels/ws_step/kernel.py:289",
         "tpu_kernel": "ws_step_pallas",
         "launches": pipe_counts.get("ws_step_gumbel", 0),
         "launches_per_warm_generate": pipe["launches_per_warm_generate"]["ws_step_gumbel"],
         "max_abs_err": max(c["max_abs_err"] for c in gumbel_checks + keyed_checks),
         "mismatches": sum(c["mismatches"] for c in gumbel_checks + keyed_checks),
         "near_ties": sum(c["near_ties"] for c in gumbel_checks + keyed_checks),
         "keyed_checks": keyed_checks,
         "shape": [NUM * SEQ, VOCAB], **gumbel_num, "bound_us": gumbel_num["bound_ms"] * 1e3},
    ]
    zoo_launches = dict(zoo_counts)
    zoo_launches["flash_attn"] = (zoo_launches.get("flash_attn", 0)
                                  + zoo["gemma3_1b_logits"]["flash_attn_launches"])
    for k in kernels:
        name = k["name"]
        if name not in zoo_errs:
            continue
        k["max_abs_err"] = max(k["max_abs_err"], zoo_errs[name])
        if name in zoo_num:
            k["zoo"] = {"config": ZOO_ARCH, "launches": zoo_launches.get(name, 0),
                        "max_abs_err": zoo_errs[name], **zoo_num[name]}
            k["zoo"]["bound_us"] = k["zoo"]["bound_ms"] * 1e3
    next(k for k in kernels if k["name"] == "flash_attn")["zoo_hd256"] = {
        "config": "gemma3-1b", **zoo_num["flash_attn_hd256"],
        "launches": zoo["gemma3_1b_logits"]["flash_attn_launches"]}
    rec_num, rec_errs = recurrent["kernels"], recurrent["kernel_errors"]
    rec_flash = next(k for k in kernels if k["name"] == "flash_attn")
    rec_flash["max_abs_err"] = max(rec_flash["max_abs_err"], rec_errs["flash_attn"])
    rec_flash["recurrent"] = {"config": REC_ARCH, "launches": rec_counts.get("flash_attn", 0),
                              "max_abs_err": rec_errs["flash_attn"], **rec_num["flash_attn"]}
    rec_ws = next(k for k in kernels if k["name"] == "ws_step")
    rec_ws["max_abs_err"] = max(rec_ws["max_abs_err"], rec_errs["ws_step"])
    rec_ws["recurrent"] = {"configs": [REC_ARCH, XLSTM_ARCH],
                           "launches": rec_counts.get("ws_step", 0),
                           "max_abs_err": rec_errs["ws_step"],
                           "v32000": rec_num["ws_step_v32000"],
                           "v50304": rec_num["ws_step_v50304"]}
    enc_num, enc_errs = encdec["kernels"], encdec["kernel_errors"]
    rec_flash["max_abs_err"] = max(rec_flash["max_abs_err"], enc_errs["flash_attn"])
    rec_flash["encdec"] = {
        "config": ENCDEC_ARCH, "launches": encdec_counts.get("flash_attn", 0),
        "max_abs_err": enc_errs["flash_attn"], "encoder": enc_num["flash_attn_encoder"],
        "cross": enc_num["flash_attn_cross"], "decode": enc_num["flash_attn_decode"]}
    rec_flash["train_zoo"] = {
        "launches": train_zoo_counts["flash_attn"],
        "launches_per_train_step": {a: train_zoo[a]["launches_per_step"].get("flash_attn", 0)
                                    for a in TRAIN_ZOO_ARCHS},
        "launches_per_step_no_remat": {
            a: train_zoo[a]["grad_gate"]["launches"].get("flash_attn", 0)
            for a in TRAIN_ZOO_ARCHS}}
    rec_ws["max_abs_err"] = max(rec_ws["max_abs_err"], enc_errs["ws_step"])
    rec_ws["encdec"] = {"config": ENCDEC_ARCH, "launches": encdec_counts.get("ws_step", 0),
                        "max_abs_err": enc_errs["ws_step"], "v51865": enc_num["ws_step_v51865"]}
    moe_errs = moe["kernel_errors"]
    rec_flash["max_abs_err"] = max(rec_flash["max_abs_err"], moe_errs["flash_attn"])
    rec_flash["moe"] = {"config": MOE_ARCH, "launches": moe_counts.get("flash_attn", 0),
                        "max_abs_err": moe_errs["flash_attn"], **moe["kernels"]["flash_attn"]}
    rec_ws["max_abs_err"] = max(rec_ws["max_abs_err"], moe_errs["ws_step"])
    rec_ws["moe"] = {"config": MOE_ARCH, "launches": moe_counts.get("ws_step", 0),
                     "max_abs_err": moe_errs["ws_step"], "shape": [MOE_ROWS * SEQ, 32000],
                     "device_key_differ": moe_errs["device_keys"]["differ"]}
    mla_errs, mla_num = mla["kernel_errors"], mla["kernels"]
    rec_flash["max_abs_err"] = max(rec_flash["max_abs_err"], mla_errs["flash_attn"])
    rec_flash["mla"] = {"config": MLA_ARCH, "instance": f"<{MLA_QK_DIM}, {MLA_V_DIM}>",
                        "launches": mla_counts.get("flash_attn", 0),
                        "launches_per_serve": mla[MLA_ARCH]["launches_per_serve"]["flash_attn"],
                        "max_abs_err": mla_errs["flash_attn"],
                        "smoke_instance": f"<{MLA_SMOKE_DIMS[0]}, {MLA_SMOKE_DIMS[1]}>",
                        "smoke": mla_num["flash_attn_smoke"], **mla_num["flash_attn"]}
    rec_ws["max_abs_err"] = max(rec_ws["max_abs_err"], mla_errs["ws_step"])
    rec_ws["mla"] = {"config": MLA_ARCH, "launches": mla_counts.get("ws_step", 0),
                     "launches_per_serve": mla[MLA_ARCH]["launches_per_serve"]["ws_step"],
                     "max_abs_err": mla_errs["ws_step"], "shape": [MLA_ROWS * SEQ, 129280],
                     "device_key_differ": mla_errs["device_keys"]["differ"],
                     **mla_num["ws_step"]}
    vlm_errs, vlm_num = vlm["kernel_errors"], vlm["kernels"]
    rec_flash["max_abs_err"] = max(rec_flash["max_abs_err"], vlm_errs["flash_attn"])
    rec_flash["vlm"] = {"config": VLM_ARCH, "launches": vlm_counts.get("flash_attn", 0),
                        "launches_per_serve": vlm[VLM_ARCH]["launches_per_serve"]["flash_attn"],
                        "max_abs_err": vlm_errs["flash_attn"], **vlm_num["flash_attn"]}
    rec_ws["max_abs_err"] = max(rec_ws["max_abs_err"], vlm_errs["ws_step"])
    rec_ws["vlm"] = {"config": VLM_ARCH, "launches": vlm_counts.get("ws_step", 0),
                     "launches_per_serve": vlm[VLM_ARCH]["launches_per_serve"]["ws_step"],
                     "max_abs_err": vlm_errs["ws_step"], "shape": [VLM_ROWS * SEQ, 152064],
                     "device_key_differ": vlm_errs["device_keys"]["differ"],
                     **vlm_num["ws_step"]}
    in_serve = serve["profile"].get("by_kind_ms") or {}
    for k in kernels:
        # device ms a launch took inside the profiled (steady) serve
        k["in_serve_ms"] = (in_serve[k["name"]] / k["launches_per_serve"]
                            if k["name"] in in_serve and "launches_per_serve" in k else None)
    for k in kernels:
        if k["launches"] <= 0:
            fail(f"{k['name']} was not launched on the main path")
        k["launch_floor_ms"] = floor_ms
    print(json.dumps({"serve": serve}))
    print(json.dumps({"scheduler": sched}))
    print(json.dumps({"pipeline": pipe}))
    print(json.dumps({"train": train}))
    print(json.dumps({"policy": policy}))
    print(json.dumps({"distilled": distilled}))
    print(json.dumps({"zoo": zoo}))
    print(json.dumps({"recurrent": recurrent}))
    print(json.dumps({"encdec": encdec}))
    print(json.dumps({"moe": moe}))
    print(json.dumps({"mla": mla}))
    print(json.dumps({"vlm": vlm}))
    print(json.dumps({"train_zoo": train_zoo}))
    print(json.dumps({"examples": examples}))
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
