"""The one-shot warm-start generation engine (port of ``WarmStartServer``,
``PerNFECostModel``, ``DispatchFailure``, ``DispatchRetryPolicy``,
``make_serve_step``, ``make_prefill_fn``, ``make_refine_step_fn`` and
``ar_generate`` of the JAX package's ``serving/engine.py``).

``WarmStartServer.serve`` runs the paper's Fig. 1 generation: a draft at
``t0``, then exactly ``warm_nfe(cold_nfe, t0)`` Euler refine steps of the
DFM backbone, then the NFE guarantee gate. With
``step_fn=make_ws_step_fn(path)`` every step is one ``ws_step`` kernel
launch (with no ``step_fn``, one ``ws_step_gumbel`` launch), and every
backbone evaluation runs its attention through the ``flash_attn`` kernel; with ``fused_block = K > 1`` each backbone
evaluation feeds K draws in one ``ws_fused`` launch. On the card the whole
refine loop is one CUDA graph replay a serve (:mod:`repro_torch.graphs`),
captured once per ``(num, seq_len, n_steps, fused_block)`` as the JAX
engine jits its loop once per shape, and so is a whole ``ar_generate``
(the AR baseline, whisper's draft), once per :func:`ar_compile_key`, as
JAX runs it as one ``lax.scan``; on the CPU both run eagerly.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import prng
from repro_torch.configs.base import ModelConfig
from repro_torch.core import guarantees
from repro_torch.core.paths import WarmStartPath
from repro_torch.core.sampler import make_euler_one_step, refine_loop_inputs, scan_refine_loop
from repro_torch.device import resolve_device
from repro_torch.graphs import GraphCache, compile_key
from repro_torch.kernels.ws_fused import make_ws_fused_fn
from repro_torch.models.model import check_batch_extras


class DispatchFailure(RuntimeError):
    """A refine dispatch kept failing after its whole retry budget.

    Raised by the scheduler's refine-dispatch wrapper once
    :class:`DispatchRetryPolicy` is exhausted. The streaming loop
    catches it, fails ONLY the affected micro-batch's requests with a
    ``FAILED`` terminal status, and keeps serving; the batch path lets
    it propagate so ``run()`` re-queues the unserved requests
    (retryable by the caller). ``__cause__`` carries the last
    underlying dispatch error.
    """

    def __init__(self, compile_key, attempts: int, last_error: Exception):
        super().__init__(
            f"refine dispatch for compile key {compile_key} failed "
            f"{attempts} time(s) (retry budget exhausted): {last_error!r}")
        self.compile_key = compile_key
        self.attempts = attempts


@dataclasses.dataclass(frozen=True)
class DispatchRetryPolicy:
    """Bounded exponential backoff for refine-dispatch faults.

    A failed dispatch is retried up to ``max_retries`` times, sleeping
    ``backoff_base_s * backoff_factor**attempt`` before attempt
    ``attempt + 1`` — total worst-case added latency is
    ``backoff_base_s * (factor**retries - 1) / (factor - 1)``, a bound
    the SLO admission loop can reason about. ``max_retries = 0``
    disables retrying (first failure is final).
    """

    max_retries: int = 3
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_base_s < 0.0:
            raise ValueError(
                f"backoff_base_s must be >= 0, got {self.backoff_base_s}")
        if self.backoff_factor < 1.0:
            raise ValueError(
                f"backoff_factor must be >= 1, got {self.backoff_factor}")

    @property
    def attempts(self) -> int:
        """Total dispatch attempts (1 initial + max_retries)."""
        return self.max_retries + 1

    def backoff_s(self, attempt: int) -> float:
        """Sleep before retrying after failed attempt ``attempt`` (0-based)."""
        return self.backoff_base_s * self.backoff_factor ** attempt

    @property
    def worst_case_backoff_s(self) -> float:
        return sum(self.backoff_s(a) for a in range(self.max_retries))


class PerNFECostModel:
    """Measured per-NFE refine cost, the streaming admission loop's latency
    oracle: an EWMA per compile key (the scheduler's ``(bucket_len,
    padded_rows, n_steps)``, the one-shot server's ``(seq_len, rows, nfe)``)
    plus a global per-NFE EWMA as the fallback for unseen keys, and an EWMA
    of first-dispatch overhead so a first dispatch is charged its set-up
    time. ``metrics`` (an ``obs.MetricsRegistry``, optional) gets the EWMAs
    as gauges and an observation counter."""

    def __init__(self, alpha: float = 0.3, metrics=None):
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self.metrics = metrics
        self._per_key: Dict[Any, float] = {}
        self._global: Optional[float] = None
        self._compile: Optional[float] = None

    def _ewma(self, old: Optional[float], new: float) -> float:
        return new if old is None else (1 - self.alpha) * old + self.alpha * new

    def observe(self, key, flow_time_s: float, nfe: int, *, compiled: bool = False) -> None:
        """Fold one measured refine dispatch into the model; ``compiled``
        marks a first dispatch of ``key``, which feeds the set-up EWMA."""
        per_nfe = flow_time_s / max(nfe, 1)
        if self.metrics is not None:
            self.metrics.counter("cost_model.observations").inc()
        if compiled:
            base = self.estimate_s(key, nfe)
            self._compile = self._ewma(self._compile, max(0.0, flow_time_s - (base or 0.0)))
            if self.metrics is not None:
                self.metrics.gauge("cost_model.compile_s").set(self._compile)
            return
        self._per_key[key] = self._ewma(self._per_key.get(key), per_nfe)
        self._global = self._ewma(self._global, per_nfe)
        if self.metrics is not None:
            self.metrics.gauge("cost_model.per_nfe_s").set(self._global)

    def per_nfe_s(self, key=None) -> Optional[float]:
        """Best per-NFE estimate for ``key`` (global fallback); ``None``
        until the first steady-state observation."""
        if key is not None and key in self._per_key:
            return self._per_key[key]
        return self._global

    def cost_for_nfe(self, nfe: int, key=None) -> Optional[float]:
        """Measured seconds for exactly ``nfe`` steps (0 steps cost 0.0)."""
        if nfe <= 0:
            return 0.0
        per = self.per_nfe_s(key)
        return None if per is None else per * nfe

    def estimate_s(self, key, nfe: int, *, include_compile: bool = False) -> Optional[float]:
        """Estimated refine latency of an ``nfe``-step dispatch at ``key``;
        ``None`` when nothing has been measured yet."""
        per = self.per_nfe_s(key)
        if per is None:
            return None
        est = per * max(nfe, 1)
        if include_compile and key not in self._per_key and self._compile:
            est += self._compile
        return est


def make_serve_step(model, cfg: ModelConfig, *, global_window: Optional[int] = None,
                    temperature: float = 1.0) -> Callable:
    """serve_step(rng, tokens (B, 1), cache, pos) -> (next tokens (B, 1),
    logits, new cache): one AR decode step of ``model`` and one draw of
    ``categorical(rng, logits / temperature)`` for the whole batch."""

    def serve_step(rng, tokens, cache, pos):
        logits, cache = model.decode_step(tokens, cache, pos, global_window=global_window)
        nxt = prng.categorical(rng, logits[:, -1].float() / temperature)
        return nxt.to(torch.int32)[:, None], logits, cache

    return serve_step


def make_prefill_fn(model, cfg: ModelConfig, *, global_window: Optional[int] = None) -> Callable:
    def prefill(batch, cache):
        return model.prefill(batch, cache, global_window=global_window)
    return prefill


def _ar_extras(cfg: ModelConfig, extras: Optional[dict]) -> dict:
    """The extras ``ar_generate`` reads, by name: an encoder-decoder's, none
    of a decoder-only config's (JAX drops them: reference fault R11)."""
    if not cfg.is_encoder_decoder:
        return {}
    return {n: extras[n] for n in sorted(extras or {})}


def ar_compile_key(cfg: ModelConfig, *, batch_size: int, seq_len: int, bos: int = 0,
                   temperature: float = 1.0, extras: Optional[dict] = None,
                   dtype=torch.float32) -> Tuple:
    """What JAX's ``lax.scan`` of ``ar_generate`` recompiles on: the rows,
    ``seq_len``, ``temperature``, ``bos``, the cache's dtype and, for an
    encoder-decoder config, each extra's name, shape and dtype. Not the
    key's or the extras' values, and nothing of a decoder-only config's
    extras."""
    return ((int(batch_size), int(seq_len), float(temperature), int(bos), str(dtype))
            + compile_key(_ar_extras(cfg, extras)))


_AR_GRAPHS: "weakref.WeakKeyDictionary[Any, GraphCache]" = weakref.WeakKeyDictionary()


def ar_graphs(model) -> GraphCache:
    """``ar_generate``'s CUDA graphs on ``model``, one per
    :func:`ar_compile_key`. The map holds the model weakly: its graphs and
    their memory pools go with it."""
    graphs = _AR_GRAPHS.get(model)
    if graphs is None:
        graphs = _AR_GRAPHS[model] = GraphCache(
            "ar_generate", hint="a decode step reads nothing back to the host")
    return graphs


def _ar_loop(model, cfg: ModelConfig, rng: torch.Tensor, extras: dict, *, batch_size: int,
             seq_len: int, bos: int, temperature: float, dtype) -> torch.Tensor:
    """The loop of ``ar_generate`` as launches: a new zeroed cache, the
    encoder-decoder's prefill, a key split and a draw a step. It reads
    nothing back to the host, so a CUDA graph can hold it whole."""
    cache = model.init_cache(batch_size, seq_len + 1, dtype)
    serve_step = make_serve_step(model, cfg, temperature=temperature)
    tok = torch.full((batch_size, 1), bos, dtype=torch.int32, device=model.device)
    start = 0
    if cfg.is_encoder_decoder:
        _, cache = model.prefill({"tokens": tok, **extras}, cache)
        start = 1
    out = []
    for i in range(start, seq_len):
        rng, sub = prng.split(rng, 2)
        tok, _, cache = serve_step(sub, tok, cache, i)
        out.append(tok[:, 0])
    return torch.stack(out, dim=1)


@torch.no_grad()
def ar_generate(model, cfg: ModelConfig, rng: torch.Tensor, *, batch_size: int, seq_len: int,
                bos: int = 0, temperature: float = 1.0, extras: Optional[dict] = None,
                dtype=torch.float32) -> torch.Tensor:
    """Full AR generation (the AR baseline): from a BOS column, ``seq_len``
    tokens by ``make_serve_step``, the key split once per step. (B, seq_len).

    An encoder-decoder config (``extras={"frames": ...}``) first prefills
    the BOS column with the frames, which encodes them once and fills the
    cross cache, and discards its logits; then it decodes BOS again at
    position 1 and steps over positions 1..seq_len-1, so it returns
    ``seq_len - 1`` tokens, as JAX's does (reference fault R8): ask for
    ``N + 1`` to get N. A decoder-only config's extras (a VLM's ``patches``
    and ``positions``) are dropped, as JAX's ``ar_generate`` drops them:
    the draft is text only (reference fault R11).

    On the card a call is one CUDA graph replay (:func:`ar_graphs`),
    captured once per :func:`ar_compile_key` as JAX's one ``lax.scan``
    dispatch: the cache, the prefill and every step's split and draw are
    inside it, the key (moved to the card) and the extras' values are its
    inputs, copied in at each call. On the CPU the loop runs eagerly."""
    ex = _ar_extras(cfg, extras)
    kw = dict(batch_size=batch_size, seq_len=seq_len, bos=bos, temperature=temperature,
              dtype=dtype)
    key = ar_compile_key(cfg, extras=ex, **kw)
    if model.device.type == "cuda" and rng.device.type == "cpu":
        rng = rng.pin_memory().to(model.device, non_blocking=True)   # no wait for the stream

    def run(k, *values):
        return _ar_loop(model, cfg, k, dict(zip(ex, values)), **kw)

    return ar_graphs(model)(key, run, rng, *ex.values())


@torch.no_grad()
def _ar_generate_eager(model, cfg: ModelConfig, rng: torch.Tensor, *, batch_size: int,
                       seq_len: int, bos: int = 0, temperature: float = 1.0,
                       extras: Optional[dict] = None, dtype=torch.float32) -> torch.Tensor:
    """:func:`ar_generate` as eager launches on the card too, the key split
    on the host: the graph's yardstick."""
    return _ar_loop(model, cfg, rng, _ar_extras(cfg, extras), batch_size=batch_size,
                    seq_len=seq_len, bos=bos, temperature=temperature, dtype=dtype)


def make_refine_step_fn(model, cfg: ModelConfig, path: WarmStartPath, *,
                        temperature: float = 1.0, step_fn: Optional[Callable] = None,
                        extras: Optional[dict] = None) -> Callable:
    """One DFM Euler refine step over the full sequence, the flow stage's
    unit: ``refine_step(rng, x_t (B,N), t (B,), h) -> x_next``. ``model``
    holds its weights, so the step takes no ``params``; ``extras`` (an
    encoder-decoder's ``{"frames": ...}``, a VLM's ``{"patches": ...,
    "positions": ...}``) go to every ``dfm_apply``; a decoder-only config
    refuses any other key here, by name."""
    if not cfg.is_encoder_decoder:
        check_batch_extras(extras)
    one_step = make_euler_one_step(path, temperature=temperature, step_fn=step_fn)

    def refine_step(rng, x_t, t, h):
        logits = model.dfm_apply(x_t, t, extras=extras)
        return one_step(rng, logits, x_t, t, h)

    return refine_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class WarmStartServer:
    """Batched warm-start serving engine (paper Fig. 1 bottom):
      1. draft stage: ``draft_generate(key, num)`` makes x_{t0};
      2. flow stage: ceil(cold_nfe * (1 - t0)) DFM Euler steps.

    The NFE guarantee is enforced with
    :class:`~repro_torch.core.guarantees.GuaranteeViolation`. The backbone
    ``flow_model`` (a ``Model``, or an ``EncDecModel`` with its frames bound
    by ``models.Conditioned``) holds its own weights and must live on
    ``device``. ``graphs`` holds the refine loop's CUDA graphs (one per
    ``(num, seq_len, n_steps, fused_block)``) and their capture and replay
    counts.
    """

    flow_model: Any
    flow_cfg: ModelConfig
    draft_generate: Callable[[torch.Tensor, int], torch.Tensor]   # (key, num) -> tokens
    path: WarmStartPath
    cold_nfe: int
    temperature: float = 1.0
    step_fn: Optional[Callable] = None
    # K > 1: refine in fused K-step blocks, one backbone evaluation and one
    # ws_fused launch per block (opt-in; see core/sampler.py)
    fused_block: int = 1
    cost_model: Optional[PerNFECostModel] = None
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.flow_model.device.type != self.device.type:
            raise ValueError(f"flow_model lives on {self.flow_model.device}, "
                             f"server on {self.device}")
        if self.cost_model is None:
            self.cost_model = PerNFECostModel()
        self._served_shapes = set()
        self._one_step = make_euler_one_step(
            self.path, temperature=self.temperature, step_fn=self.step_fn)
        self._fused_fn = (make_ws_fused_fn(self.path, temperature=self.temperature)
                          if self.fused_block > 1 else None)
        self.graphs = GraphCache("WarmStartServer's refine loop")

    def _loop(self, x, keys, ts, hs):
        return scan_refine_loop(self.flow_model.dfm_apply, self._one_step, x, keys, ts, hs,
                                fused_block=self.fused_block, fused_fn=self._fused_fn)

    def _refine_loop(self, keys, x, ts, hs):
        """The refine from the host's ``keys``, ``ts``, ``hs``: on the card one
        replay of the graph of ``(num, seq_len, n_steps, fused_block)``."""
        key = (x.shape[0], x.shape[1], ts.shape[0], self.fused_block)
        return self.graphs(key, self._loop, x, keys, ts, hs)

    def _refine_loop_eager(self, keys, x, ts, hs):
        """The same loop as eager launches (the graph's yardstick)."""
        return self._loop(x, keys, ts.to(self.device), hs.to(self.device))

    def serve(self, rng: torch.Tensor, num: int) -> Tuple[torch.Tensor, dict]:
        k_draft, k_flow = prng.split(rng, 2)
        t_draft0 = time.perf_counter()
        x = self.draft_generate(k_draft, num)
        _sync(self.device)
        t_draft = time.perf_counter() - t_draft0

        t0 = self.path.t0
        n_steps = guarantees.warm_nfe(self.cold_nfe, t0)
        keys, ts, hs = refine_loop_inputs(k_flow, t0, 1.0 / self.cold_nfe, n_steps)

        captures = self.graphs.captures
        t_flow0 = time.perf_counter()
        with torch.inference_mode():
            x = self._refine_loop(keys, x, ts, hs)
        _sync(self.device)
        t_flow = time.perf_counter() - t_flow0
        # every guaranteed draw runs; fused blocks batch them into fewer
        # backbone evaluations
        nfe = n_steps
        backbone_evals = (n_steps if self.fused_block <= 1
                          else -(-n_steps // self.fused_block))

        guarantees.require_guarantee(self.cold_nfe, t0, nfe)
        per_nfe = t_flow / max(backbone_evals, 1)
        shape = (x.shape[-1], num, nfe)
        # a first dispatch: a capture on the card, a shape not served yet on the CPU
        compiled = (self.graphs.captures > captures if self.device.type == "cuda"
                    else shape not in self._served_shapes)
        self.cost_model.observe(shape, t_flow, backbone_evals, compiled=compiled)
        self._served_shapes.add(shape)
        report = {
            "nfe": nfe,
            "backbone_evals": backbone_evals,
            "fused_block": self.fused_block,
            "cold_nfe": self.cold_nfe,
            "draft_time_s": t_draft,
            "flow_time_s": t_flow,
            "per_nfe_s": per_nfe,
            "speedup_report": guarantees.speedup_report(
                self.cold_nfe, t0, draft_cost_ratio=t_draft / max(per_nfe, 1e-9)),
        }
        return x, report
