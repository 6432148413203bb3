"""Image refinement on the port (paper §4.3 pipeline), the torch twin of
``examples/image_refinement.py``:

A cheap per-pixel histogram sampler (DC-GAN stand-in) produces blurry
8x8 drafts; WS-DFM refines them to data-like images. Visualises the
progressive refinement of Fig. 7 as ASCII frames and reports FID-proxy +
NFE for cold vs warm starts. On the card ``EulerSampler``'s loop is one
CUDA graph replay a call, each step one ``ws_step_gumbel`` launch. The
backbone holds its weights and trains in place, so the cold model is
copied before the fine-tune.

Run:  PYTHONPATH=src python examples/image_refinement_torch.py [--device cpu] [--steps 300]
"""

import argparse
import copy

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import (
    EulerSampler, HistogramDraft, KNNRefinementCoupling, WarmStartPath, pair_iterator,
)
from repro_torch.core.sampler import categorical_from_probs, euler_step_probs
from repro_torch.data import frechet_distance, images_dataset
from repro_torch.models import build_model
from repro_torch.training import Trainer

SEQ, VOCAB, RES = 64, 256, 8
COLD_NFE = 48
EVAL = 512      # images generated and scored a start
PAIRS = 1024    # histogram drafts coupled to the data for the fine-tune
SHADES = " .:-=+*#%@"


def ascii_img(tokens: np.ndarray) -> str:
    img = tokens.reshape(RES, RES)
    return "\n".join(
        "".join(SHADES[min(int(v) * len(SHADES) // 256, len(SHADES) - 1)] for v in row)
        for row in img
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=300,
                    help="cold training steps; the WS-DFM fine-tune takes half")
    args = ap.parse_args(argv)
    device = args.device

    cfg = ModelConfig(
        name="img", family="dense", num_layers=4, d_model=192, num_heads=6,
        num_kv_heads=6, d_ff=768, vocab_size=VOCAB, pattern=("attn",),
        norm="layernorm", mlp_gated=False, act="gelu", tie_embeddings=False,
        dtype="float32", max_seq_len=SEQ)
    data = images_dataset(8192, seed=0)
    eval_ref = images_dataset(512, seed=99)
    rng = np.random.default_rng(0)

    print("training cold DFM on 8x8 tokenised images ...")
    model = build_model(cfg, device=device, seed=0)
    run = RunConfig(total_steps=args.steps, batch_size=64, learning_rate=1e-3,
                    warmup_steps=20, log_every=100)
    trainer = Trainer(model, cfg, run, path=WarmStartPath(t0=0.0))
    src = rng.integers(0, VOCAB, size=data.shape, dtype=np.int32)
    state = trainer.init_state()
    state = trainer.fit(state, pair_iterator(src, data, 64, rng),
                        log_fn=lambda i, m: print(f"  step {i}: ce={m['ce']:.3f}"))
    cold = copy.deepcopy(model)      # the fine-tune below updates ``model`` in place

    print("building k=k'=5 kNN refinement pairs (paper §4.3) ...")
    draft = HistogramDraft.fit(data, VOCAB, device=device)
    drafts = draft.generate(prng.key(1), PAIRS).cpu().numpy()
    src_w, tgt_w = KNNRefinementCoupling(k=5, k_inject=5).build(data, drafts, rng)

    print("fine-tuning WS-DFM (t0=0.5) ...")
    run_w = RunConfig(total_steps=args.steps // 2, batch_size=64, learning_rate=3e-4,
                      warmup_steps=10, log_every=50)
    trainer_w = Trainer(model, cfg, run_w, path=WarmStartPath(t0=0.5))
    trainer_w.fit(state, pair_iterator(src_w, tgt_w, 64, rng),
                  log_fn=lambda i, m: print(f"  step {i}: ce={m['ce']:.3f}"))

    # progressive refinement (Fig. 7): snapshot after each Euler step
    x = draft.generate(prng.key(5), 1)
    path = WarmStartPath(t0=0.5)
    smp = EulerSampler(path=path, num_steps=COLD_NFE)
    h = smp.h
    snaps = [x[0].cpu().numpy()]
    key = prng.key(6)
    t = 0.5
    with torch.no_grad():
        for i in range(smp.nfe):
            key, sub = prng.split(key, 2)
            tt = torch.full((1,), t, device=device)
            logits = model.dfm_apply(x, tt)
            probs = euler_step_probs(logits, x, tt, min(h, 1 - t), path)
            x = categorical_from_probs(sub, probs)
            t += h
            if i % max(smp.nfe // 4, 1) == 0 or i == smp.nfe - 1:
                snaps.append(x[0].cpu().numpy())

    print("\nprogressive refinement (draft -> final), Fig. 7 analog:")
    lines = [ascii_img(s).split("\n") for s in snaps]
    for row in range(RES):
        print("   ".join(l[row] for l in lines))

    # quantitative comparison
    n = EVAL
    drafts_eval = draft.generate(prng.key(7), n).cpu().numpy()
    fid_draft = frechet_distance(drafts_eval, eval_ref)

    smp_cold = EulerSampler(path=WarmStartPath(t0=0.0), num_steps=COLD_NFE)
    noise = rng.integers(0, VOCAB, size=(n, SEQ)).astype(np.int32)
    x_cold, st_c = smp_cold.sample(prng.key(8), cold.dfm_apply,
                                   torch.from_numpy(noise).to(device))
    fid_cold = frechet_distance(x_cold.cpu().numpy(), eval_ref)

    smp_warm = EulerSampler(path=path, num_steps=COLD_NFE)
    x_warm, st_w = smp_warm.sample(prng.key(9), model.dfm_apply,
                                   draft.generate(prng.key(10), n))
    fid_warm = frechet_distance(x_warm.cpu().numpy(), eval_ref)

    print(f"\ndraft FID-proxy: {fid_draft:.3f} (negligible time)")
    print(f"cold  FID-proxy: {fid_cold:.3f}  NFE={int(st_c.nfe)}")
    print(f"warm  FID-proxy: {fid_warm:.3f}  NFE={int(st_w.nfe)} (x2 guaranteed)")


if __name__ == "__main__":
    main()
