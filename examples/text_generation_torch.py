"""End-to-end text generation on the port (paper §4.2 pipeline), the torch
twin of ``examples/text_generation.py``:

  1. train an LSTM draft model on the synthetic char corpus;
  2. train the cold-start DFM baseline (~tiny DiT);
  3. build the refinement coupling (offline word-oracle rewriter + data
     injection) from LSTM drafts;
  4. fine-tune into WS-DFM at t0 = 0.8;
  5. generate from all three and score NLL with the proxy LM.

On the card the LSTM draft is one CUDA graph replay a call, each refine
step one ``ws_step_gumbel`` launch and every attention one ``flash_attn``
launch. The backbone holds its weights and trains in place, so the cold
model is copied before the fine-tune.

Run:  PYTHONPATH=src python examples/text_generation_torch.py [--device cpu] [--steps 300]
"""

import argparse
import copy

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.base import RunConfig
from repro_torch.configs.dfm_dit import tiny_config
from repro_torch.core import (
    ARDraft, OracleRefinementCoupling, WarmStartPath, WarmStartPipeline, pair_iterator,
)
from repro_torch.data import TEXT_VOCAB, NGramProxyLM, SyntheticCorpus, WordOracle, decode
from repro_torch.models import LSTMConfig, LSTMModel, build_model
from repro_torch.optim import AdamW
from repro_torch.training import Trainer

SEQ = 64
COLD_NFE = 64
EVAL = 32       # samples generated a model
PAIRS = 1024    # LSTM drafts the word oracle refines into training pairs
FINETUNE_MIN = 100   # the WS-DFM fine-tune takes max(steps // 2, FINETUNE_MIN) steps


def tensors(tree):
    """The tensors of a parameter tree (nested dicts and lists), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [t for x in items for t in tensors(x)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--t0", type=float, default=0.8)
    args = ap.parse_args(argv)
    device = args.device

    corpus = SyntheticCorpus(seed=0)
    data = corpus.sequences(4096, SEQ, seed=1)
    proxy = NGramProxyLM(order=3).fit(corpus.sequences(1024, SEQ, seed=2))
    rng = np.random.default_rng(0)

    # -- 1. draft LSTM ----------------------------------------------------
    print("[1/5] training LSTM draft model (paper: 2-layer LSTM)")
    lstm = LSTMModel(LSTMConfig(vocab_size=TEXT_VOCAB, hidden=128, num_layers=2, embed_dim=64))
    lparams = lstm.init(7, device=device)
    leaves = {str(i): [p.requires_grad_()] for i, p in enumerate(tensors(lparams))}
    opt = AdamW(learning_rate=5e-3)
    ostate = opt.init(leaves)
    for i in range(args.steps):
        idx = rng.integers(0, data.shape[0], size=32)
        loss = lstm.loss(lparams, torch.from_numpy(data[idx]).to(device))
        grads = torch.autograd.grad(loss, [ps[0] for ps in leaves.values()])
        _, ostate = opt.update({k: [g] for k, g in zip(leaves, grads)}, ostate, leaves)
        if (i + 1) % 100 == 0:
            print(f"   lstm step {i+1}: nll={float(loss):.3f}")
    for ps in leaves.values():
        ps[0].requires_grad_(False)

    # -- 2. cold-start DFM -------------------------------------------------
    print("[2/5] training cold-start DFM baseline")
    cfg = tiny_config(vocab_size=TEXT_VOCAB, seq_len=SEQ)
    model = build_model(cfg, device=device, seed=0)
    run = RunConfig(total_steps=args.steps, batch_size=32, learning_rate=1e-3,
                    warmup_steps=20, log_every=100)
    trainer = Trainer(model, cfg, run, path=WarmStartPath(t0=0.0))
    src = rng.integers(0, TEXT_VOCAB, size=data.shape, dtype=np.int32)
    state = trainer.init_state()
    state = trainer.fit(state, pair_iterator(src, data, 32, rng),
                        log_fn=lambda i, m: print(f"   dfm step {i}: ce={m['ce']:.3f}"))
    cold = copy.deepcopy(model)      # the fine-tune below updates ``model`` in place

    # -- 3. refinement coupling --------------------------------------------
    print("[3/5] building refinement pairs (LSTM drafts -> word oracle)")
    drafts = lstm.generate(lparams, prng.key(3), PAIRS, SEQ).cpu().numpy()
    coupling = OracleRefinementCoupling(oracle=WordOracle(corpus), inject_prob=0.15)
    src_w, tgt_w = coupling.build(data, drafts, rng)

    # -- 4. WS-DFM fine-tune -----------------------------------------------
    print(f"[4/5] fine-tuning WS-DFM at t0={args.t0}")
    run_w = RunConfig(total_steps=max(args.steps // 2, FINETUNE_MIN), batch_size=32,
                      learning_rate=3e-4, warmup_steps=10, log_every=50)
    trainer_w = Trainer(model, cfg, run_w, path=WarmStartPath(t0=args.t0))
    trainer_w.fit(state, pair_iterator(src_w, tgt_w, 32, rng),
                  log_fn=lambda i, m: print(f"   ws step {i}: ce={m['ce']:.3f}"))

    # -- 5. generate + evaluate ---------------------------------------------
    print("[5/5] generation")
    n = EVAL
    lstm_out = lstm.generate(lparams, prng.key(9), n, SEQ).cpu().numpy()
    pipe_cold = WarmStartPipeline(
        model_fn=cold.dfm_apply, draft=None, path=WarmStartPath(t0=0.0), cold_nfe=COLD_NFE,
        vocab_size=TEXT_VOCAB, seq_len=SEQ, device=device)
    cold_out, rep_c = pipe_cold.generate(prng.key(10), n)
    draft_obj = ARDraft(decode_fn=lambda p, k, num, s: lstm.generate(p, k, num, s),
                        params=lparams, seq_len=SEQ)
    pipe_warm = WarmStartPipeline(
        model_fn=model.dfm_apply, draft=draft_obj, path=WarmStartPath(t0=args.t0),
        cold_nfe=COLD_NFE, vocab_size=TEXT_VOCAB, seq_len=SEQ, device=device)
    warm_out, rep_w = pipe_warm.generate(prng.key(11), n)
    cold_out, warm_out = cold_out.cpu().numpy(), warm_out.cpu().numpy()

    print(f"\nLSTM draft  NLL={proxy.nll(lstm_out):.3f}")
    print(f"cold DFM    NLL={proxy.nll(cold_out):.3f}  NFE={rep_c.cold_nfe}")
    print(f"WS-DFM      NLL={proxy.nll(warm_out):.3f}  "
          f"NFE={rep_w.warm_nfe}  (guaranteed x{rep_w.guaranteed_factor:.1f})")
    print("\nsamples:")
    print("  lstm :", decode(lstm_out[0]))
    print("  cold :", decode(cold_out[0]))
    print("  warm :", decode(warm_out[0]))


if __name__ == "__main__":
    main()
