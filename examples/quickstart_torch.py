"""Quickstart on the port: warm-start discrete flow matching on two moons
(paper §4.1), the torch twin of ``examples/quickstart.py``.

Trains a cold-start DFM baseline and a WS-DFM (t0=0.8) on the 128x128
two-moons grid, then generates from both through ``WarmStartPipeline`` and
compares SKL + NFE, in the structure of the paper's Table 1. On the card
each refine step is one ``ws_step_gumbel`` launch and every attention one
``flash_attn`` launch.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu] [--steps 300]
"""

import argparse

import numpy as np

from repro_torch import prng
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import (
    CorruptionDraft, KNNRefinementCoupling, WarmStartPath, WarmStartPipeline,
    pair_iterator,
)
from repro_torch.data import moons_dataset, symmetric_kl
from repro_torch.models import build_model
from repro_torch.training import Trainer

GRID = 128
STEPS = 300
COLD_NFE = 20   # paper: step size 0.05
EVAL = 4000     # samples generated and scored a model


def make_cfg() -> ModelConfig:
    return ModelConfig(
        name="moons", family="dense", num_layers=4, d_model=128,
        num_heads=4, num_kv_heads=4, d_ff=512, vocab_size=GRID,
        pattern=("attn",), norm="layernorm", mlp_gated=False, act="gelu",
        tie_embeddings=False, dtype="float32", max_seq_len=2,
    )


def train(cfg, src, tgt, t0, steps, device, seed=0):
    run = RunConfig(total_steps=steps, batch_size=256, learning_rate=1e-3,
                    warmup_steps=20, log_every=100, seed=seed)
    trainer = Trainer(build_model(cfg, device=device, seed=seed), cfg, run,
                      path=WarmStartPath(t0=t0))
    state = trainer.init_state()
    rng = np.random.default_rng(seed)
    state = trainer.fit(state, pair_iterator(src, tgt, 256, rng),
                        log_fn=lambda i, m: print(f"  step {i}: ce={m['ce']:.3f}"))
    return state.params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)

    data = moons_dataset(8192, seed=0)
    eval_ref = moons_dataset(4000, seed=42)
    rng = np.random.default_rng(0)

    print(f"=== cold-start DFM baseline (t0=0, NFE={COLD_NFE}) ===")
    src = rng.integers(0, GRID, size=data.shape).astype(np.int32)
    model = train(make_cfg(), src, data, 0.0, args.steps, args.device)
    pipe = WarmStartPipeline(
        model_fn=model.dfm_apply, draft=None, path=WarmStartPath(t0=0.0),
        cold_nfe=COLD_NFE, vocab_size=GRID, seq_len=2, device=args.device)
    x_cold, rep = pipe.generate(prng.key(1), EVAL)
    skl_cold = symmetric_kl(x_cold.cpu().numpy(), eval_ref)
    print(f"cold DFM: SKL={skl_cold:.3f}  {rep.as_row()}")

    print("\n=== WS-DFM with a pretty-good draft model (t0=0.8, NFE=4) ===")
    draft = CorruptionDraft(data=data, vocab_size=GRID, corruption=0.05, jitter=2,
                            device=args.device)
    drafts = draft.generate(prng.key(2), 4096).cpu().numpy()
    src_w, tgt_w = KNNRefinementCoupling(k=3, k_inject=2).build(data, drafts, rng)
    model_w = train(make_cfg(), src_w, tgt_w, 0.8, args.steps, args.device, seed=1)
    pipe_w = WarmStartPipeline(
        model_fn=model_w.dfm_apply, draft=draft, path=WarmStartPath(t0=0.8),
        cold_nfe=COLD_NFE, vocab_size=GRID, seq_len=2, device=args.device)
    x_warm, rep_w = pipe_w.generate(prng.key(3), EVAL)
    skl_warm = symmetric_kl(x_warm.cpu().numpy(), eval_ref)
    print(f"WS-DFM:  SKL={skl_warm:.3f}  {rep_w.as_row()}")

    print(f"\nguaranteed speed-up: x{rep_w.guaranteed_factor:.1f} "
          f"({rep.cold_nfe} -> {rep_w.warm_nfe} NFE); "
          f"quality {'preserved' if skl_warm <= skl_cold * 1.1 else 'degraded'} "
          f"(SKL {skl_cold:.3f} -> {skl_warm:.3f})")


if __name__ == "__main__":
    main()
