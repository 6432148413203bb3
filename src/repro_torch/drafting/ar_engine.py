"""KV-cached autoregressive draft engine (port of the JAX package's
``drafting/ar_engine.py``: ``TransformerDraftAdapter``, ``LSTMDraftAdapter``,
``ARDraftEngine``, ``DraftEngineStats``).

The paper's draft stage: a causal transformer drafts ``seq_len`` tokens per
row after a shared prompt, from a preallocated ``max_len`` KV cache; or the
paper's LSTM (§4.2), whose "cache" is its recurrent state.

* **prefill + decode** — the prompt is consumed by one batched call
  ("batched") or token by token ("scan"); then ``seq_len`` tokens are
  sampled, each followed by one single-token decode step (the last needs
  none). The JAX engine samples every token in one jitted ``lax.scan``
  dispatch; here, on the card, the whole decode (the noise of every
  token, every draw and every decode step) is one CUDA graph replay
  (:mod:`repro_torch.graphs`), captured once per ``(rows, prefix_len,
  seq_len)``. That key is finer than JAX's ``(rows, seq_len)``: JAX
  traces the start position, the graph bakes each step's position in as
  the host integer the kernels take. The prefill runs eagerly, as does
  everything on the CPU; the graph's tokens equal the eager loop's bit
  for bit.
* **prefix reuse** — the post-prefill cache is pooled per row count;
  a call with the same rows and prompt skips the prefill and just rewinds
  the cache cursors to the prompt length (KV rows past it are masked by
  cache validity, so the previous call's tokens never leak). A recurrent
  adapter (``positional = False``) keeps the post-prefill state itself: its
  steps make new tensors and never write the snapshot. A model with
  recurrent layers (Mamba2, mLSTM, sLSTM, Zamba2's hybrid) behind a
  positional adapter keeps both kinds in one cache: the KV leaves are
  rewound, and the recurrent leaves hold the post-prefill state, which the
  decode steps never write (each returns new tensors), so a reused prefix
  starts from exactly the state a fresh prefill leaves. (The JAX engine
  rewinds only the cursors and decodes a hybrid or recurrent model from
  the state its previous call left: reference fault R7.)
* **in place** — the cache buffers are written in place where the JAX
  engine donates them. A positional adapter's cache is allocated once per
  row count and kept for the engine's lifetime (the decode graphs read and
  write those very buffers): a new prompt is prefilled from it emptied in
  place (``clear``), the prefill's recurrent leaves are copied into it
  (``store``) and its cursors are rewound in place.
* **row-keyed sampling** — token ``i`` of row ``b`` is
  ``categorical(fold_in(keys[b], i), logits / temperature)``: a row depends
  only on its own key and the prompt (pack-invariant, prefix-stable). The
  Gumbel noise of all ``seq_len`` tokens is drawn up front in one batch
  (:func:`row_gumbel`); the draws are the same.

Bit-exactness contract (tested against ``ref.oracle_generate_rows``): the
engine equals the cache-free full-recompute oracle bitwise. With
``decode_impl="kernel"`` (or "auto" on a supported config) every forward
runs through the batch-invariant ``draft_decode`` kernels, so the batched
prefill equals the scan bitwise and is the default.

Adapter contract: ``device``, ``init_cache(batch, max_len)``,
``decode_step(tok (B,), cache, pos) -> (logits (B, V), cache)``,
``prefill_batched(toks (B, S), cache)``, ``positional`` (cursors in the
cache, rewound in place by ``set_pos``; such an adapter also has
``clear(cache, batch)`` and ``store(cache, new)``) and
``exact_batched_prefill``. The
adapter holds its model's parameters; on the card its steps must not
synchronise with the host, or the decode's capture raises.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.graphs import GraphCache
from repro_torch.kernels.draft_decode import DraftDecoder, draft_decode_supported
from repro_torch.models.model import IN_PLACE_LEAVES


# the draft noise hashed at once, at most, in elements: the threefry hash's int64
# intermediates take ~50 bytes an element, so deepseek-v3-671b's 8 rows x 255 steps
# x 129 280 vocabulary at once would hold 12.8 GB for a moment (inside the decode's
# graph pool for good); larger noise is hashed in blocks of steps, ~0.8 GB each
ROW_GUMBEL_CHUNK = 1 << 24


def row_gumbel(keys: torch.Tensor, n: int, vocab: int, device) -> torch.Tensor:
    """The sampling noise of ``n`` tokens: ``(B, n, V)`` float32 with
    ``[b, i] = jax.random.gumbel(fold_in(keys[b], i), (V,))``, hashed in
    blocks of steps of at most ``ROW_GUMBEL_CHUNK`` elements (the same bits:
    each element's hash is its own)."""
    steps = torch.arange(n, dtype=torch.int64, device=keys.device)
    step_keys = prng.fold_in(keys[:, None, :], steps)                  # (B, n, 2)
    chunk = max(1, ROW_GUMBEL_CHUNK // (keys.shape[0] * vocab))
    if chunk >= n:
        return prng.gumbel(step_keys, (vocab,), device=device)
    out = torch.empty((keys.shape[0], n, vocab), dtype=torch.float32, device=device)
    for lo in range(0, n, chunk):
        out[:, lo:lo + chunk] = prng.gumbel(step_keys[:, lo:lo + chunk], (vocab,),
                                            device=device)
    return out


def sample_tokens(noise: torch.Tensor, logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """``categorical`` with its noise given: first argmax of ``noise +
    logits / temperature`` over the last axis, int32."""
    return torch.argmax(noise + logits / temperature, dim=-1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class TransformerDraftAdapter:
    """A decoder-only causal ``repro_torch.models.Model`` as draft substrate.

    The cache is ``Model.init_cache``'s tree (stacked ``(layers, B, T,
    kv_heads, head_dim)`` k/v leaves and per-layer cursors ``pos``, and a
    recurrent layer's state leaves); cache validity masks every position at
    or past a cursor, which is what makes reusing a buffer across calls
    safe, and the recurrent leaves are replaced, never written, by a step.

    ``decode_impl``: "kernel" runs the ``draft_decode`` kernels (and raises
    on a config outside their subset); "xla" the model's own plain-torch
    ``decode_step``/``prefill`` (named after the JAX package's XLA path);
    "auto" the kernels where the config and a float32 cache allow.
    """

    model: Any
    cache_dtype: torch.dtype = torch.float32
    decode_impl: str = "auto"

    positional = True

    @functools.cached_property
    def _decoder(self) -> Optional[DraftDecoder]:
        if self.decode_impl == "xla":
            return None
        if self.decode_impl == "kernel":
            return DraftDecoder(model=self.model)   # raises if unsupported
        if self.decode_impl != "auto":
            raise ValueError(f"decode_impl must be auto|kernel|xla, got {self.decode_impl}")
        supported = (draft_decode_supported(self.model.cfg)
                     and self.cache_dtype == torch.float32)
        return DraftDecoder(model=self.model) if supported else None

    @property
    def exact_batched_prefill(self) -> bool:
        """True when ``prefill_batched`` is bit-identical to scanning."""
        return self._decoder is not None

    @property
    def device(self) -> torch.device:
        return self.model.device

    def init_cache(self, batch: int, max_len: int) -> dict:
        return self.model.init_cache(batch, max_len, self.cache_dtype)

    @torch.no_grad()
    def decode_step(self, tok: torch.Tensor, cache: dict, pos) -> Tuple[torch.Tensor, dict]:
        """tok (B,) at position ``pos`` -> (logits (B, V) float32, cache)."""
        if self._decoder is not None:
            logits, cache = self._decoder.forward_chunk(tok[:, None], cache, pos)
        else:
            logits, cache = self.model.decode_step(tok[:, None], cache, pos)
        return logits[:, 0].float(), cache

    @torch.no_grad()
    def prefill_batched(self, toks: torch.Tensor, cache: dict) -> Tuple[torch.Tensor, dict]:
        """toks (B, P) from an empty (or rewound-to-0) cache -> (next-token
        logits (B, V), cache)."""
        if self._decoder is not None:
            logits, cache = self._decoder.forward_chunk(toks, cache, 0)
        else:
            logits, cache = self.model.prefill({"tokens": toks}, cache)
        return logits[:, -1].float(), cache

    @staticmethod
    def set_pos(cache: dict, pos: int) -> dict:
        """Every cursor set to ``pos`` in place: the zero-copy prefix rewind
        (a decode graph reads these very cursor tensors). Returns ``cache``."""
        for group in ("blocks", "rem", "pre"):
            for leaves in cache.get(group, {}).values():
                leaves["pos"].fill_(pos)
        return cache

    def clear(self, cache: dict, batch: int) -> dict:
        """``cache`` emptied in place: every leaf but the KV buffers (cursors,
        recurrent states) set to ``init_cache``'s value; KV rows stay,
        masked past the cursor. Returns ``cache``."""
        return self.store(cache, self.model.init_cache(batch, 1, self.cache_dtype))

    @staticmethod
    def store(cache: dict, new: dict) -> dict:
        """Every leaf of ``new`` but the KV buffers copied into ``cache``'s
        (same tree), in place: a step's replaced leaves into the buffers a
        decode graph reads. Returns ``cache``."""
        for group, slots in new.items():
            for name, leaves in slots.items():
                for k, v in leaves.items():
                    if k not in IN_PLACE_LEAVES:
                        cache[group][name][k].copy_(v)
        return cache


@dataclasses.dataclass(frozen=True)
class LSTMDraftAdapter:
    """``LSTMModel`` (the paper's §4.2 text draft) with its ``params`` as
    draft substrate.

    The "cache" is the recurrent state stacked ``(layers, B, hidden)`` for h
    and c. Stepping is single-token by nature, so prefill and decode share
    one code path and the oracle equivalence is exact by construction.
    """

    model: Any                       # repro_torch.models.LSTMModel
    params: Any                      # its parameter tree

    positional = False
    # recurrent stepping IS the batched prefill: bit-exact by construction
    exact_batched_prefill = True

    @property
    def device(self) -> torch.device:
        return self.params["embed"]["table"].device

    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg = self.model.cfg
        z = torch.zeros((cfg.num_layers, batch, cfg.hidden), dtype=torch.float32,
                        device=self.device)
        return {"h": z, "c": z}

    @torch.no_grad()
    def decode_step(self, tok: torch.Tensor, cache: dict, pos) -> Tuple[torch.Tensor, dict]:
        state = [(cache["h"][i], cache["c"][i]) for i in range(self.model.cfg.num_layers)]
        logits, state = self.model.step(self.params, tok, state)
        return logits.float(), {"h": torch.stack([h for h, _ in state]),
                                "c": torch.stack([c for _, c in state])}

    def prefill_batched(self, toks: torch.Tensor, cache: dict) -> Tuple[torch.Tensor, dict]:
        logits = None
        for j in range(toks.shape[1]):
            logits, cache = self.decode_step(toks[:, j], cache, j)
        return logits, cache


@dataclasses.dataclass
class DraftEngineStats:
    """Lifetime counters (prefill skips are the cache-reuse win)."""

    prefill_computes: int = 0
    prefill_reuses: int = 0
    decode_dispatches: int = 0
    tokens_generated: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _PoolEntry:
    prefix_key: Tuple[bytes, int]    # (prompt fingerprint, prefix_len)
    snapshot: dict                   # post-prefill cache (positional: the row count's own)
    logits0: torch.Tensor            # (B, V) next-token logits after the prefix


class ARDraftEngine:
    """Row-keyed KV-cached AR draft generator.

    ``generate_rows(keys (B, 2), seq_len) -> (B, seq_len)`` is the
    scheduler's draft contract: row ``b`` depends only on ``keys[b]``.

    Args:
      adapter: :class:`TransformerDraftAdapter` or :class:`LSTMDraftAdapter`.
      max_len: cache capacity; must cover ``prefix_len + seq_len - 1`` of
        the largest request served.
      temperature: sampling temperature.
      bos: the prompt when ``generate_rows`` is called without one.
      prefill_mode: "scan" (token by token, bit-exact on any adapter),
        "batched" (one call; bit-exact iff ``adapter.exact_batched_prefill``)
        or None to take "batched" where it is exact, else "scan".

    ``graphs`` holds the decode's CUDA graphs and their capture and replay
    counts; :meth:`reset` drops them with the caches.
    """

    def __init__(self, adapter, *, max_len: int, temperature: float = 1.0, bos: int = 0,
                 prefill_mode: Optional[str] = None):
        if prefill_mode is None:
            prefill_mode = ("batched" if getattr(adapter, "exact_batched_prefill", False)
                            else "scan")
        if prefill_mode not in ("scan", "batched"):
            raise ValueError(f"prefill_mode must be scan|batched, got {prefill_mode}")
        self.adapter = adapter
        self.max_len = max_len
        self.temperature = temperature
        self.bos = bos
        self.prefill_mode = prefill_mode
        self.stats = DraftEngineStats()
        self._pool: Dict[int, _PoolEntry] = {}
        # positional adapters: one KV cache per row count, for the engine's
        # lifetime (until reset), since the decode graphs write its buffers
        self._caches: Dict[int, dict] = {}
        self.graphs = GraphCache("ARDraftEngine's decode")

    @property
    def device(self) -> torch.device:
        return self.adapter.device

    # ---- phases ----------------------------------------------------------

    def _prefill(self, cache: dict, toks: torch.Tensor) -> Tuple[torch.Tensor, dict]:
        if self.prefill_mode == "batched":
            return self.adapter.prefill_batched(toks, cache)
        logits = None
        for j in range(toks.shape[1]):
            logits, cache = self.adapter.decode_step(toks[:, j], cache, j)
        return logits, cache

    def _decode_eager(self, cache: dict, logits0: torch.Tensor, keys: torch.Tensor,
                      start: int, n_steps: int) -> torch.Tensor:
        """Sample ``n_steps`` tokens: token i from the current logits with
        the row's key folded with i, then one decode step (none after the
        last token). The cursors the steps advance are new tensors: the
        pooled ones stay at ``start``."""
        noise = row_gumbel(keys, n_steps, logits0.shape[-1], logits0.device)
        logits, toks = logits0, []
        for i in range(n_steps):
            tok = sample_tokens(noise[:, i], logits, self.temperature)
            toks.append(tok)
            if i < n_steps - 1:
                logits, cache = self.adapter.decode_step(tok, cache, start + i)
        return torch.stack(toks, dim=1)

    def _decode(self, cache: dict, logits0: torch.Tensor, keys: torch.Tensor, start: int,
                n_steps: int, graphed: bool) -> torch.Tensor:
        """The decode: ``graphed``, through the graph of ``(rows, start,
        n_steps)`` (one replay on the card), else :meth:`_decode_eager`. A
        positional cache is the row count's own, read and written by the
        graph in place; a recurrent state is an input, copied in like the
        keys."""
        if not graphed:
            return self._decode_eager(cache, logits0, keys, start, n_steps)
        key = (keys.shape[0], start, n_steps)
        names = [] if self.adapter.positional else sorted(cache)

        def run(lg, k, *state):
            return self._decode_eager(dict(zip(names, state)) if names else cache, lg, k,
                                      start, n_steps)

        return self.graphs(key, run, logits0, keys, *(cache[n] for n in names))

    # ---- prefix bookkeeping ------------------------------------------------

    @staticmethod
    def _fingerprint(prompt: torch.Tensor) -> Tuple[bytes, int]:
        a = np.ascontiguousarray(prompt.cpu().numpy().astype(np.int32))
        return hashlib.sha1(a.tobytes()).digest(), a.shape[1]

    def _prefix_cache(self, b: int, prompt: torch.Tensor, key) -> Tuple[dict, torch.Tensor]:
        """Post-prefill (cache, logits0): reused when the pool holds this
        (rows, prefix), else recomputed.

        The entry is popped; ``generate_rows`` pools it again after the
        decode, so a failure in between leaves no half-used cache in the
        pool. Positional adapters: the row count's own cache, its cursors
        rewound in place (to 0 and prefilled, or straight to the prefix
        length on reuse). Recurrent adapters: a new state on recompute; the
        decode never writes the snapshot."""
        p = prompt.shape[1]
        entry = self._pool.pop(b, None)
        if entry is not None and entry.prefix_key == key:
            self.stats.prefill_reuses += 1
            if self.adapter.positional:
                self.adapter.set_pos(entry.snapshot, p)
            return entry.snapshot, entry.logits0
        if self.adapter.positional:
            cache = self._caches.get(b)
            if cache is None:
                cache = self._caches[b] = self.adapter.init_cache(b, self.max_len)
            logits0, out = self._prefill(self.adapter.clear(cache, b), prompt)
            self.adapter.set_pos(self.adapter.store(cache, out), p)
        else:
            logits0, cache = self._prefill(self.adapter.init_cache(b, self.max_len), prompt)
        self.stats.prefill_computes += 1
        return cache, logits0

    # ---- generation ----------------------------------------------------------

    def generate_rows(self, keys: torch.Tensor, seq_len: int,
                      prompt: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Row-keyed draft generation.

        Args:
          keys: (B, 2) PRNG keys (``repro_torch.prng``), one per row.
          seq_len: tokens to generate.
          prompt: optional (B, P) shared prefix; defaults to one BOS column.
            Consecutive calls with the same (rows, prompt) skip the prefill.
        Returns:
          (B, seq_len) int32 draft tokens on the model's device (prompt not
          included).
        """
        return self._generate(keys, seq_len, prompt, graphed=True)

    def _generate_rows_eager(self, keys: torch.Tensor, seq_len: int,
                             prompt: Optional[torch.Tensor] = None) -> torch.Tensor:
        """:meth:`generate_rows` with the decode as eager launches on the
        card too: the graph's yardstick."""
        return self._generate(keys, seq_len, prompt, graphed=False)

    @torch.no_grad()
    def _generate(self, keys: torch.Tensor, seq_len: int, prompt: Optional[torch.Tensor],
                  graphed: bool) -> torch.Tensor:
        if seq_len < 1:
            raise ValueError(f"seq_len must be >= 1, got {seq_len}")
        keys = prng.key_data(keys)
        b = keys.shape[0]
        if prompt is None:
            prompt = torch.full((b, 1), self.bos, dtype=torch.int32)
        prompt = torch.as_tensor(prompt).to(device=self.device, dtype=torch.int32)
        if prompt.shape[0] != b:
            raise ValueError(f"prompt rows {prompt.shape[0]} != key rows {b}")
        p = prompt.shape[1]
        if p + seq_len - 1 > self.max_len:
            raise ValueError(f"prefix {p} + seq_len {seq_len} - 1 exceeds cache capacity "
                             f"max_len={self.max_len}")
        fp = self._fingerprint(prompt)
        cache, logits0 = self._prefix_cache(b, prompt, fp)
        toks = self._decode(cache, logits0, keys, p, int(seq_len), graphed)
        # the prefix KV rows < p are never overwritten and the pooled cursors
        # stay at p, so the post-prefill cache is intact with no copy
        self._pool[b] = _PoolEntry(fp, cache, logits0)
        self.stats.decode_dispatches += 1
        self.stats.tokens_generated += b * seq_len
        return toks

    def as_draft_fn(self) -> Callable[[torch.Tensor, int], torch.Tensor]:
        """The scheduler's ``draft_fn(keys, seq_len)`` entry point."""
        return self.generate_rows

    def reset(self) -> None:
        """Drop pooled prefixes, the caches and the decode graphs (frees
        device buffers)."""
        self._pool.clear()
        self._caches.clear()
        self.graphs.clear()
