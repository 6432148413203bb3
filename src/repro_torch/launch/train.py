"""Training launcher: ``python -m repro_torch.launch.train --arch dfm-dit --t0 0.8``

Torch port of the JAX package's ``launch/train.py``, with the same flags
plus ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).
It builds the synthetic-corpus data, the ``CorruptionDraft`` drafts and
the ``KNNRefinementCoupling`` pairs (or noise sources when ``--t0 0``),
trains through ``Trainer.fit`` and saves a checkpoint that the JAX
package's ``restore_checkpoint`` reads as well.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

import numpy as np

from repro_torch import prng
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core.coupling import KNNRefinementCoupling, pair_iterator
from repro_torch.core.draft import CorruptionDraft
from repro_torch.core.paths import WarmStartPath
from repro_torch.data import SyntheticCorpus
from repro_torch.models import build_model
from repro_torch.training import Trainer


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dfm-dit")
    ap.add_argument("--smoke", action="store_true", help="use reduced config")
    ap.add_argument("--t0", type=float, default=0.8)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def training_pairs(cfg, args):
    """(src, tgt, rng): the coupled pairs the launcher trains on, and the
    numpy generator that built them (the batches continue its stream)."""
    corpus = SyntheticCorpus(seed=args.seed)
    data = corpus.sequences(4096, args.seq_len, seed=args.seed + 1)
    data = (data % cfg.vocab_size).astype(np.int32)
    rng = np.random.default_rng(args.seed)
    if args.t0 > 0:
        draft = CorruptionDraft(data=data, vocab_size=cfg.vocab_size, corruption=0.3,
                                device=args.device)
        drafts = draft.generate(prng.key(args.seed), data.shape[0]).cpu().numpy()
        coupling = KNNRefinementCoupling(k=1, k_inject=1, max_candidates=2048)
        src, tgt = coupling.build(data, drafts, rng)
    else:
        src = rng.integers(0, cfg.vocab_size, size=data.shape, dtype=np.int32)
        tgt = data
    return src, tgt, rng


def main(argv: Optional[Sequence[str]] = None):
    """Train and checkpoint; returns (trainer, final state, checkpoint path)."""
    args = parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(max_seq_len=max(cfg.max_seq_len, args.seq_len))
    model = build_model(cfg, device=args.device, seed=args.seed)
    run = RunConfig(
        arch=args.arch, t0=args.t0, learning_rate=args.lr,
        total_steps=args.steps, batch_size=args.batch_size, seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
    )
    src, tgt, rng = training_pairs(cfg, args)
    it = pair_iterator(src, tgt, run.batch_size, rng)
    trainer = Trainer(model, cfg, run, path=WarmStartPath(t0=args.t0))
    state = trainer.init_state()
    state = trainer.fit(
        state, it, steps=args.steps,
        log_fn=lambda i, m: print(f"step {i}: loss={m['loss']:.4f} "
                                  f"ce={m['ce']:.4f} {m['steps_per_s']:.2f} it/s"),
    )
    path = save_checkpoint(run.checkpoint_dir, state, step=int(state.step))
    print(f"checkpoint saved to {path}")
    return trainer, state, path


if __name__ == "__main__":
    main()
