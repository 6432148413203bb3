"""Cache-free full-recompute oracle for the KV-cached AR draft engine
(port of the JAX package's ``drafting/ref.py``).

For every generated token the oracle starts from a FRESH cache and
replays the whole prefix (prompt + tokens sampled so far) one token at a
time — O(L^2) model evaluations, no state carried across tokens. Every
evaluation is the single-token decode step the engine uses, and the
sampling noise is the engine's (:func:`row_gumbel`), so the oracle equals
the engine bitwise: any divergence means the engine mismanaged its cache
(stale KV leaking past the validity mask, a wrong cursor after a prefix
rewind, a wrong RoPE offset after reuse, ...).

Deliberately slow: a correctness reference for tests, never a serving path.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import prng
from repro_torch.drafting.ar_engine import row_gumbel, sample_tokens


@torch.no_grad()
def oracle_generate_rows(adapter, keys: torch.Tensor, seq_len: int, *,
                         prompt: Optional[torch.Tensor] = None, temperature: float = 1.0,
                         bos: int = 0, max_len: Optional[int] = None) -> torch.Tensor:
    """Reference for :meth:`ARDraftEngine.generate_rows` (same arguments,
    same row-keyed sampling rule ``fold_in(keys[b], i)``)."""
    keys = prng.key_data(keys)
    b = keys.shape[0]
    device = adapter.device
    if prompt is None:
        prompt = torch.full((b, 1), bos, dtype=torch.int32)
    toks = torch.as_tensor(prompt).to(device=device, dtype=torch.int32)
    cap = max_len if max_len is not None else toks.shape[1] + seq_len
    noise = row_gumbel(keys, seq_len, adapter.model.cfg.vocab_size, device)

    def replay(toks: torch.Tensor) -> torch.Tensor:
        """Fresh cache; feed toks one token at a time; the next-token
        logits after the last of them."""
        cache = adapter.init_cache(b, cap)
        logits = None
        for j in range(toks.shape[1]):
            logits, cache = adapter.decode_step(toks[:, j], cache, j)
        return logits

    out = []
    for i in range(seq_len):
        nxt = sample_tokens(noise[:, i], replay(toks), temperature)
        out.append(nxt)
        toks = torch.cat([toks, nxt[:, None]], dim=1)
    return torch.stack(out, dim=1)
