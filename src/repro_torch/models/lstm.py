"""LSTM language model, the paper's lightweight draft for text (§4.2:
2-layer, 512 hidden for Text-8; 1-layer, 1024 hidden for Wikitext). Port of
the JAX package's ``models/lstm.py``.

Functional like the JAX model: ``LSTMModel(cfg).init(seed)`` returns the
parameter tree ``{"embed": {"table"}, "layers": [{"wx": {"w"}, "wh":
{"w"}}, ...], "head": {"w"}}`` (JAX layout, ``w`` is ``(in, out)``; a JAX
checkpoint converts with ``repro_torch.convert.jax_lstm_params_to_torch``)
and every method takes it. The products are ``torch.matmul`` (the JAX model
leaves them to XLA: no TPU kernel runs here). ``generate`` draws
``categorical(split(rng, seq_len)[i], logits / T)`` as JAX does, with the
noise of all steps drawn in one call before the loop; on the card the
whole of it is one CUDA graph replay a call.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Tuple

import torch

from repro_torch import prng
from repro_torch.device import resolve_device
from repro_torch.graphs import GraphCache
from repro_torch.models.common import normal_init

State = List[Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class LSTMConfig:
    vocab_size: int
    hidden: int = 512
    num_layers: int = 2
    embed_dim: int = 256


@dataclasses.dataclass(frozen=True)
class LSTMModel:
    cfg: LSTMConfig

    def __post_init__(self):
        # the jit cache of generate; frozen dataclass, so set as EulerSampler does
        object.__setattr__(self, "graphs", GraphCache("LSTMModel.generate"))

    def init(self, seed: int = 0, *, device="cuda") -> dict:
        """Seeded parameters on ``device``, at the JAX initialisers' scales
        (embedding 0.02, projections 1/sqrt(in)); the values differ from
        JAX's."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)

        def dense(i, o):
            return {"w": normal_init(gen, (i, o), 1.0 / math.sqrt(i), dev)}

        layers = []
        for i in range(cfg.num_layers):
            in_dim = cfg.embed_dim if i == 0 else cfg.hidden
            layers.append({"wx": dense(in_dim, 4 * cfg.hidden),
                           "wh": dense(cfg.hidden, 4 * cfg.hidden)})
        return {"embed": {"table": normal_init(gen, (cfg.vocab_size, cfg.embed_dim), 0.02, dev)},
                "layers": layers,
                "head": dense(cfg.hidden, cfg.vocab_size)}

    @staticmethod
    def _cell(lp: dict, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        g = torch.matmul(x, lp["wx"]["w"]) + torch.matmul(h, lp["wh"]["w"])
        i, f, z, o = torch.chunk(g, 4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(z)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, c

    def init_state(self, batch: int, *, device="cuda") -> State:
        z = torch.zeros((batch, self.cfg.hidden), dtype=torch.float32, device=device)
        return [(z, z) for _ in range(self.cfg.num_layers)]

    def step(self, params: dict, tokens: torch.Tensor, state: State):
        """tokens (B,) -> (logits (B, V), new state)."""
        x = params["embed"]["table"][tokens.long()]
        new_state = []
        for lp, (h, c) in zip(params["layers"], state):
            h, c = self._cell(lp, x, h, c)
            new_state.append((h, c))
            x = h
        return torch.matmul(x, params["head"]["w"]), new_state

    def forward(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits: tokens (B, S) -> (B, S, V) predicting t + 1."""
        state = self.init_state(tokens.shape[0], device=tokens.device)
        out = []
        for s in range(tokens.shape[1]):
            logits, state = self.step(params, tokens[:, s], state)
            out.append(logits)
        return torch.stack(out, dim=1)

    def loss(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """Next-token NLL on (B, S) sequences."""
        logits = self.forward(params, tokens[:, :-1])
        tgt = tokens[:, 1:].long()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, tgt[..., None])[..., 0]
        return torch.mean(lse - ll)

    def _leaves(self, params: dict) -> Tuple[torch.Tensor, ...]:
        return ((params["embed"]["table"],)
                + tuple(lp[k]["w"] for lp in params["layers"] for k in ("wx", "wh"))
                + (params["head"]["w"],))

    def _tree(self, leaves) -> dict:
        n = self.cfg.num_layers
        return {"embed": {"table": leaves[0]},
                "layers": [{"wx": {"w": leaves[1 + 2 * i]}, "wh": {"w": leaves[2 + 2 * i]}}
                           for i in range(n)],
                "head": {"w": leaves[1 + 2 * n]}}

    def _generate_loop(self, num: int, temperature: float, bos: int, *inputs) -> torch.Tensor:
        """The token loop on ``inputs = (*parameter leaves, step keys (S, 2))``,
        the noise drawn from the keys on the parameters' device first: it reads
        nothing on the host."""
        params, keys = self._tree(inputs[:-1]), inputs[-1]
        dev = params["embed"]["table"].device
        noise = prng.gumbel(keys, (num, self.cfg.vocab_size), device=dev)
        state = self.init_state(num, device=dev)
        tok = torch.full((num,), bos, dtype=torch.int32, device=dev)
        out = []
        for i in range(keys.shape[0]):
            logits, state = self.step(params, tok, state)
            tok = torch.argmax(noise[i] + logits / temperature, dim=-1).to(torch.int32)
            out.append(tok)
        return torch.stack(out, dim=1)

    @torch.no_grad()
    def generate(self, params: dict, rng: torch.Tensor, num: int, seq_len: int,
                 temperature: float = 1.0, bos: int = 0) -> torch.Tensor:
        """(num, seq_len) int32 on the parameters' device: from a BOS column,
        token i is ``categorical(split(rng, seq_len)[i], logits / T)``.

        On the card the whole loop is one CUDA graph replay a call, captured
        once per ``(num, seq_len, temperature, bos)`` (JAX's one ``lax.scan``
        dispatch); the parameters and the step keys are the graph's inputs,
        copied in at each call (JAX passes the parameters as an argument), so
        other weights of the same shapes replay the same graph."""
        leaves = self._leaves(params)
        loop = functools.partial(self._generate_loop, num, float(temperature), int(bos))
        key = (num, seq_len, float(temperature), int(bos), leaves[0].device)
        return self.graphs(key, loop, *leaves, prng.split(rng, seq_len))

    @torch.no_grad()
    def _generate_eager(self, params: dict, rng: torch.Tensor, num: int, seq_len: int,
                        temperature: float = 1.0, bos: int = 0) -> torch.Tensor:
        """:meth:`generate` as eager launches (the graph's yardstick)."""
        return self._generate_loop(num, float(temperature), int(bos), *self._leaves(params),
                                   prng.split(rng, seq_len))
