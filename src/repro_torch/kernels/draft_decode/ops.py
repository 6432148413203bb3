"""The draft-decode kernels' wrappers and ``DraftDecoder`` (port of the JAX
package's ``kernels/draft_decode/ops.py``).

``DraftDecoder(model).forward_chunk(toks (B, S), cache, pos)`` is the one
forward of the AR draft engine's decode steps (S = 1) and batched prefill
(S = P). It runs every reduction through four batch-invariant CUDA
kernels (``csrc/draft_decode.cu``): each output's sum has one fixed order
that depends only on the reduced length, so a multi-token chunk gives the
same bits as the same tokens fed one at a time, and as any other split.
Everything between the kernels is exact data movement (the embedding
gather; the kernels write k/v into the cache themselves).

Each wrapper launches its kernel for CUDA tensors (or raises) and takes the
plain version (``ref.py``, as batch-invariant) only for CPU tensors.
Parameters are the JAX package's dicts (``{"w"[, "b"]}`` and so on; see
``ref.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.draft_decode.ref import (
    attn_cached_ref, head_ref, post_attn_ref, qkv_rope_ref,
)

_NORM = {"layernorm": 0, "rmsnorm": 1}
_ACT = {"gelu": 0, "silu": 1, "relu": 2}
# head_proj_kernel's tiling (csrc/draft_decode.cu head_tiling), a function of
# (D, V) alone: 256 threads; NT columns a block (32, halved down to 4 while D x
# NT floats exceed HEAD_SLAB_BYTES), 256 / NT slices of K; RT token rows a block
# (doubled up to 8 while ceil(V / NT) x ceil(32 / (2 RT)) blocks still fill the
# card's 132 SMs, halved while the shared memory does not take them)
HEAD_THREADS, HEAD_MAX_ROWS, HEAD_SLAB_BYTES = 256, 8, 114688
CARD_SMS, REF_ROWS = 132, 32
MAX_SMEM = 232448
# qkv_rope_kernel and post_attn_proj_kernel: 32 token rows per cluster of 8
# blocks, each block one slice of K (qkv_rope: 8 * ceil(D / 64), post_attn:
# 4 * ceil(K / 32))
CLUSTER_ROWS = 32
# post_attn's slab widths (columns of weight a block holds) for wo, up (gated:
# 64 up + 64 gate) and down
POST_WIDTHS = {"wo": 32, "up": 128, "down": 64}
MAX_GRID_Y = 65535
MAX_GRID_X = 2 ** 31 - 1
# the head dims qkv_rope and attn_cached are built for
HEAD_DIMS = (16, 32, 64, 128)
# attn_cached_kernel (csrc/draft_decode.cu AttnTile): a cluster of at most ATTN_CLUSTER
# blocks (of 256 threads for more than 4 pairs, else 128) owns at most ATTN_PAIRS (query
# row, query head) pairs of one KV head; a block walks its slice of T in stages of
# ATTN_STAGE[hd] keys
ATTN_CLUSTER, ATTN_PAIRS = 8, 16
ATTN_STAGE = {16: 256, 32: 256, 64: 128, 128: 64}


def draft_decode_supported(cfg) -> bool:
    """True when ``cfg`` is in the kernel path's supported subset (the JAX
    package's rule: uniform attention layers in float32, layernorm or
    rmsnorm, gelu/silu/relu, standard or no RoPE, optional bias and gate,
    tied or untied head)."""
    try:
        attn_only = tuple(cfg.prefix) == () and set(cfg.pattern) == {"attn"}
    except (AttributeError, TypeError):
        return False
    return bool(
        attn_only
        and not cfg.is_encoder_decoder
        and cfg.family != "vlm"
        and cfg.dtype == "float32"
        and cfg.param_dtype == "float32"
        and cfg.norm in ("layernorm", "rmsnorm")
        and cfg.act in ("gelu", "silu", "relu")
        and cfg.rope_type in ("default", "none")
        and not cfg.qk_norm
        and not cfg.post_norms
        and cfg.attn_logit_softcap == 0.0
        and not cfg.embed_scale
    )


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(name: str, device: torch.device, *tensors) -> None:
    for t in tensors:
        if t is not None and (t.device != device or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: every tensor must be contiguous float32 on {device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_cursor(name: str, start: torch.Tensor, device: torch.device) -> None:
    if start.device != device or start.dtype != torch.int32 or start.numel() != 1:
        raise ValueError(f"{name}: the cache cursor must be one int32 on {device}")


def _up_to_mod32(v: int, r: int) -> int:
    """The smallest value >= v congruent to r modulo 32."""
    return v + (r - v) % 32


def _head_tiling(d: int, v: int) -> tuple:
    """(RT, NT) of a head block at (D, V), as the kernel picks them."""
    nt = 32
    while nt > 4 and d * nt * 4 > HEAD_SLAB_BYTES:
        nt //= 2
    tiles = -(-v // nt)
    rt = 1
    while rt < HEAD_MAX_ROWS and tiles * -(-REF_ROWS // (2 * rt)) >= CARD_SMS:
        rt *= 2
    while rt > 1 and _head_smem(d, v, rt, nt) > MAX_SMEM:
        rt //= 2
    return rt, nt


def _head_smem(d: int, v: int, rt: int, nt: int) -> int:
    """Bytes of dynamic shared memory of a head block: the weight slab (the
    larger of its row-major and tied layouts), the rows normalised, the
    norm's scale and bias, and the partial sums of the 256 / NT slices of K."""
    s = HEAD_THREADS // nt
    sl = 4 * -(-d // (4 * s))
    ldx = s * sl
    sst = _up_to_mod32(sl * (v if v <= nt else nt), nt % 32)
    slab = max(s * sst, nt * _up_to_mod32(ldx, 4))
    return (slab + (rt + 2) * ldx + s * rt * nt) * 4


def _qkv_smem(d: int, head_dim: int) -> int:
    """Bytes of shared memory of a qkv_rope block: the rows' slice (padded by
    4), ln1's scale and bias over the slice, the weight slab (the whole
    slice, or two stages of 128 k rows, 64 at head_dim 128; rows padded by
    8), the partial tile and the rows' ln1 statistics over the slice."""
    sl = 8 * -(-d // 64)
    stage = 128 if head_dim <= 64 else 64
    slab = sl if sl <= stage else 2 * stage
    return (CLUSTER_ROWS * (sl + 4) + 2 * sl + (slab + CLUSTER_ROWS) * (head_dim + 8)
            + 2 * CLUSTER_ROWS) * 4


def _post_stage(width: int) -> int:
    """k rows of a stage of post_attn's staged path (csrc ``post_stage``)."""
    return 64 if width >= 128 else 128


def _post_smem(k: int, width: int) -> int:
    """Bytes of shared memory of a post_attn block. The whole slice at once
    where it fits: the weight slab, the rows' slice (padded by 4), the
    partial tile and the rows' ln2 statistics. Else staged (a function of
    the width alone): two buffers of a stage's slab and rows, the partial
    tile and the statistics."""
    sl = 4 * -(-k // 32)
    tail = CLUSTER_ROWS * width + 2 * CLUSTER_ROWS
    whole = (sl * width + CLUSTER_ROWS * (sl + 4) + tail) * 4
    if whole <= MAX_SMEM:
        return whole
    ch = _post_stage(width)
    return (2 * (ch * width + CLUSTER_ROWS * (ch + 4)) + tail) * 4


def attn_slices(t: int, head_dim: int) -> tuple:
    """(C, W): attn_cached splits a batch row's T keys over a cluster of C
    blocks, rank s taking keys ``[s W, min(T, (s + 1) W))`` (none when
    ``s W >= T``). A function of T and the head dim alone, never of the
    rows, the chunk length, the cursor or the group, so a query token's sums
    run in one order whatever shares its launch."""
    if t < 1 or head_dim not in HEAD_DIMS:
        raise ValueError(f"attn_cached: no slices for T = {t} at head_dim {head_dim}")
    c = ATTN_CLUSTER if head_dim >= 128 else ATTN_CLUSTER // 2
    return c, -(-t // c)


def _attn_tiles(heads: int, kv_heads: int, seq: int) -> tuple:
    """(heads of the group, query rows) a cluster owns (csrc ``attn_tiles``):
    which cluster computes a pair, never how."""
    hg = min(heads // kv_heads, ATTN_PAIRS)
    return hg, max(1, min(seq, ATTN_PAIRS // hg))


def _attn_smem(t: int, head_dim: int, pairs: int) -> int:
    """Bytes of shared memory of an attn_cached block. One pair alone, where
    it fits (csrc ``solo_smem_floats``): q, the slices' partial p @ v and l,
    a max a warp, a stage of K (128 keys at hd 128, else 256; rows padded by
    4) and T scores. Else a cluster block (``AttnTile``): a stage's
    K (rows padded by 4), V and probabilities (a slot for each pair of the
    kernel's instance, 4 or 16, rounded up to 16 bytes), and for each pair q,
    the stage's scores (padded by 1), the partial p @ v, l and the two
    maxima."""
    chunk = 128 if head_dim >= 128 else 256
    solo = 4 * (head_dim * (1 + ATTN_CLUSTER) + ATTN_CLUSTER + 256 // 32
                + chunk * (head_dim + 4) + -(-t // 4) * 4)
    if pairs == 1 and solo <= MAX_SMEM:
        return solo
    ch = min(attn_slices(t, head_dim)[1], ATTN_STAGE[head_dim])
    bucket = 4 if pairs <= 4 else ATTN_PAIRS
    sets = (256 if bucket == ATTN_PAIRS else 128) // head_dim
    slots = sets * max(1, bucket // sets)
    return 4 * (ch * (2 * head_dim + 4) + -(-ch * slots // 4) * 4
                + pairs * (2 * head_dim + ch + 4))


def _check_limits(name: str, r: int, rows_per_block: int, k: int, smem: int,
                  max_blocks: int = MAX_GRID_Y) -> None:
    if r <= 0 or -(-r // rows_per_block) > max_blocks:
        raise ValueError(f"{name}: {r} rows is outside what one launch takes")
    if smem > MAX_SMEM:
        raise ValueError(f"{name}: a reduced length of {k} needs {smem} bytes of "
                         f"shared memory per block, more than {MAX_SMEM}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _device(x: torch.Tensor, name: str) -> Optional[torch.device]:
    """None for a CPU tensor (take the plain version); the CUDA device for a
    CUDA tensor; raises for anything else."""
    if x.device.type == "cpu":
        return None
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, got {x.device}")
    return x.device


# -- qkv_rope ----------------------------------------------------------------------

def qkv_rope(x: torch.Tensor, ln: dict, attn_p: dict, kbuf: torch.Tensor,
             vbuf: torch.Tensor, start: torch.Tensor, *, pos0: int, seq: int, norm: str,
             eps: float, use_rope: bool, theta: float, heads: int, kv_heads: int,
             head_dim: int) -> torch.Tensor:
    """ln1 -> q/k/v (+bias) -> RoPE for rows x (R = B * seq, D) at positions
    ``pos0 + r % seq``. Returns q (R, H*hd) and writes k, v into the layer's
    cache buffers ``kbuf``/``vbuf`` (B, T, KH*hd) at the cursor ``start``
    (a 0-d int32 tensor on the same device), in place."""
    kw = dict(pos0=pos0, seq=seq, norm=norm, eps=eps, use_rope=use_rope, theta=theta,
              heads=heads, kv_heads=kv_heads, head_dim=head_dim)
    dev = _device(x, "qkv_rope")
    if dev is None:
        return qkv_rope_ref(x, ln, attn_p, kbuf, vbuf, start, **kw)
    r, d = x.shape
    kd = kv_heads * head_dim
    if r % seq or kbuf.shape != (r // seq, kbuf.shape[1], kd) or vbuf.shape != kbuf.shape \
            or seq > kbuf.shape[1]:
        raise ValueError(f"qkv_rope: x {tuple(x.shape)} with seq {seq} does not fit the "
                         f"cache {tuple(kbuf.shape)} of {kv_heads} heads of {head_dim}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"qkv_rope: head_dim {head_dim} not in {HEAD_DIMS}")
    _check("qkv_rope", dev, x, ln["scale"], ln.get("bias"), kbuf, vbuf,
           *(attn_p[n].get(f) for n in ("wq", "wk", "wv") for f in ("w", "b")))
    _check_cursor("qkv_rope", start, dev)
    _check_limits("qkv_rope", r, CLUSTER_ROWS, d, _qkv_smem(d, head_dim))
    q = torch.empty((r, heads * head_dim), dtype=torch.float32, device=dev)
    _launch_qkv_rope(x, ln, attn_p, q, kbuf, vbuf, start, **kw)
    _build.count("qkv_rope")
    return q


def _launch_qkv_rope(x, ln, attn_p, q, kbuf, vbuf, start, *, pos0, seq, norm, eps,
                     use_rope, theta, heads, kv_heads, head_dim) -> None:
    """One launch on checked CUDA tensors (no count)."""
    r, d = x.shape
    with torch.cuda.device(x.device):
        rc = _build.library().draft_qkv_rope_launch(
            x.data_ptr(), ln["scale"].data_ptr(), _ptr(ln.get("bias")),
            *(attn_p[n]["w"].data_ptr() for n in ("wq", "wk", "wv")),
            *(_ptr(attn_p[n].get("b")) for n in ("wq", "wk", "wv")),
            q.data_ptr(), kbuf.data_ptr(), vbuf.data_ptr(), start.data_ptr(),
            r, seq, kbuf.shape[1], d, heads, kv_heads, head_dim, int(pos0), _NORM[norm],
            float(eps), int(use_rope), float(theta), _stream(x.device))
    _build.check(rc, "qkv_rope")


# -- attn_cached ---------------------------------------------------------------------

def attn_cached(q: torch.Tensor, kbuf: torch.Tensor, vbuf: torch.Tensor,
                start: torch.Tensor, *, pos0: int, seq: int, heads: int, kv_heads: int,
                head_dim: int) -> torch.Tensor:
    """Each query row ``r`` of q (R = B * seq, H*hd) against batch row
    ``r // seq``'s whole buffer kbuf/vbuf (B, T, KH*hd), keys ``col <=
    pos0 + r % seq`` and ``col < start + seq`` -> (R, H*hd). On the card one
    cluster launch: each KV head read once for its group's query heads, T
    split by ``attn_slices``, no key at or past ``start + seq`` read; one
    pair alone (one head a group, one token a row) takes one block, with the
    same bits."""
    kw = dict(pos0=pos0, seq=seq, heads=heads, kv_heads=kv_heads, head_dim=head_dim)
    dev = _device(q, "attn_cached")
    if dev is None:
        return attn_cached_ref(q, kbuf, vbuf, start, **kw)
    r = q.shape[0]
    if r % seq or q.shape[1] != heads * head_dim or heads % kv_heads \
            or kbuf.shape != (r // seq, kbuf.shape[1], kv_heads * head_dim) \
            or vbuf.shape != kbuf.shape or seq > kbuf.shape[1]:
        raise ValueError(f"attn_cached: q {tuple(q.shape)} with seq {seq} does not fit the "
                         f"cache {tuple(kbuf.shape)}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"attn_cached: head_dim {head_dim} not in {HEAD_DIMS}")
    t = kbuf.shape[1]
    c, _ = attn_slices(t, head_dim)
    hg, qr = _attn_tiles(heads, kv_heads, seq)
    blocks = c * (r // seq) * kv_heads * -(-(heads // kv_heads) // hg) * -(-seq // qr)
    _check_limits("attn_cached", r, 1, t, _attn_smem(t, head_dim, hg * qr))
    if blocks > MAX_GRID_X:
        raise ValueError(f"attn_cached: {r} rows is outside what one launch takes")
    _check("attn_cached", dev, q, kbuf, vbuf)
    _check_cursor("attn_cached", start, dev)
    out = torch.empty_like(q)
    _launch_attn_cached(q, kbuf, vbuf, start, out, **kw)
    _build.count("attn_cached")
    return out


def _launch_attn_cached(q, kbuf, vbuf, start, out, *, pos0, seq, heads, kv_heads,
                        head_dim) -> None:
    """One launch on checked CUDA tensors (no count)."""
    c, w = attn_slices(kbuf.shape[1], head_dim)
    with torch.cuda.device(q.device):
        rc = _build.library().draft_attn_cached_launch(
            q.data_ptr(), kbuf.data_ptr(), vbuf.data_ptr(), start.data_ptr(), out.data_ptr(),
            q.shape[0], seq, kbuf.shape[1], heads, kv_heads, head_dim, int(pos0), c, w,
            float(1.0 / head_dim ** 0.5), _stream(q.device))
    _build.check(rc, "attn_cached")


# -- post_attn -----------------------------------------------------------------------

def post_attn(a: torch.Tensor, x: torch.Tensor, attn_p: dict, ln: dict, mlp_p: dict, *,
              norm: str, eps: float, act: str) -> torch.Tensor:
    """wo (+b) -> residual -> ln2 -> up (gated when ``mlp_p`` has "gate") ->
    act -> down (+b) -> residual: a (R, H*hd), x (R, D) -> (R, D). On the
    card: three cluster launches (wo + residual; ln2 + up/gate + act; down
    + residual), one count; a projection whose slice of K does not fit in
    shared memory at once (d_model 3072) streams it in stages, with the
    same bits."""
    dev = _device(x, "post_attn")
    if dev is None:
        return post_attn_ref(a, x, attn_p, ln, mlp_p, norm=norm, eps=eps, act=act)
    r, d = x.shape
    f = mlp_p["up"]["w"].shape[1]
    if a.shape[0] != r or attn_p["wo"]["w"].shape != (a.shape[1], d) \
            or mlp_p["down"]["w"].shape != (f, d):
        raise ValueError(f"post_attn: a {tuple(a.shape)} and x {tuple(x.shape)} do not fit "
                         f"the weights")
    _check("post_attn", dev, a, x, ln["scale"], ln.get("bias"),
           *(p.get(k) for p in (attn_p["wo"], *mlp_p.values()) for k in ("w", "b")))
    for k, proj in ((a.shape[1], "wo"), (d, "up"), (f, "down")):
        _check_limits("post_attn", r, CLUSTER_ROWS, k, _post_smem(k, POST_WIDTHS[proj]))
    x1 = torch.empty_like(x)
    u = torch.empty((r, f), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    _launch_post_attn(a, x, attn_p, ln, mlp_p, x1, u, out, norm=norm, eps=eps, act=act)
    _build.count("post_attn")
    return out


def _launch_post_attn(a, x, attn_p, ln, mlp_p, x1, u, out, *, norm, eps, act,
                      staged: bool = False) -> None:
    """The three launches on checked CUDA tensors (no count); ``staged``
    streams every slice in stages even where it fits at once (the same bits)."""
    gate = mlp_p.get("gate", {})
    with torch.cuda.device(x.device):
        rc = _build.library().draft_post_attn_launch(
            a.data_ptr(), x.data_ptr(), attn_p["wo"]["w"].data_ptr(),
            _ptr(attn_p["wo"].get("b")), ln["scale"].data_ptr(), _ptr(ln.get("bias")),
            mlp_p["up"]["w"].data_ptr(), _ptr(mlp_p["up"].get("b")), _ptr(gate.get("w")),
            _ptr(gate.get("b")), mlp_p["down"]["w"].data_ptr(), _ptr(mlp_p["down"].get("b")),
            x1.data_ptr(), u.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], a.shape[1],
            u.shape[1], _NORM[norm], float(eps), _ACT[act], int(staged), _stream(x.device))
    _build.check(rc, "post_attn")


# -- head ----------------------------------------------------------------------------

def head(x: torch.Tensor, fn: dict, w: torch.Tensor, *, norm: str, eps: float) -> torch.Tensor:
    """Final norm -> vocab projection: x (R, D), w (D, V) -> logits (R, V).
    ``w`` may be the embedding table transposed (a tied head): the kernel
    reads it through its strides, with no copy."""
    dev = _device(x, "head")
    if dev is None:
        return head_ref(x, fn, w, norm=norm, eps=eps)
    r, d = x.shape
    if w.shape[0] != d or w.stride() not in ((w.shape[1], 1), (1, d)):
        raise ValueError(f"head: w {tuple(w.shape)} with strides {w.stride()} is neither "
                         f"(D, V) nor a transposed (V, D) table")
    _check("head", dev, x, fn["scale"], fn.get("bias"))
    if w.device != dev or w.dtype != torch.float32:
        raise ValueError(f"head: w must be float32 on {dev}")
    rt, nt = _head_tiling(d, w.shape[1])
    if -(-w.shape[1] // nt) > MAX_GRID_Y:
        raise ValueError(f"head: {w.shape[1]} columns is outside what one launch takes")
    _check_limits("head", r, rt, d, _head_smem(d, w.shape[1], rt, nt), max_blocks=MAX_GRID_X)
    out = torch.empty((r, w.shape[1]), dtype=torch.float32, device=dev)
    _launch_head(x, fn, w, out, norm=norm, eps=eps)
    _build.count("head")
    return out


def _launch_head(x, fn, w, out, *, norm, eps) -> None:
    with torch.cuda.device(x.device):
        rc = _build.library().draft_head_launch(
            x.data_ptr(), fn["scale"].data_ptr(), _ptr(fn.get("bias")), w.data_ptr(),
            w.stride(0), w.stride(1), out.data_ptr(), x.shape[0], x.shape[1], w.shape[1],
            _NORM[norm], float(eps), _stream(x.device))
    _build.check(rc, "head")


# -- the shared decode/prefill forward -------------------------------------------------

def _dense_p(m) -> dict:
    return {"w": m.w.detach()} if m.b is None else {"w": m.w.detach(), "b": m.b.detach()}


def _norm_p(m) -> dict:
    p = {"scale": m.scale.detach()}
    if getattr(m, "bias", None) is not None:
        p["bias"] = m.bias.detach()
    return p


@dataclasses.dataclass(frozen=True)
class DraftDecoder:
    """The kernel forward over a ``repro_torch.models.Model``'s weights and
    its KV cache (``Model.init_cache``'s JAX layout, float32), so the
    engine's pooling and rewind need nothing else."""

    model: Any

    def __post_init__(self):
        cfg = self.model.cfg
        if not draft_decode_supported(cfg):
            raise ValueError(f"config {cfg.name!r} is outside the draft_decode kernel "
                             "subset (see draft_decode_supported)")

    @functools.cached_property
    def _params(self):
        """Per-layer parameter dicts (views of the model's weights, so a
        later ``load_state_dict`` shows through), final norm, head matrix."""
        m = self.model
        layers = [{"ln1": _norm_p(blk.ln1), "ln2": _norm_p(blk.ln2),
                   "attn": {n: _dense_p(getattr(blk.attn, n)) for n in ("wq", "wk", "wv", "wo")},
                   "mlp": {n: _dense_p(getattr(blk.mlp, n)) for n in ("up", "down", "gate")
                           if getattr(blk.mlp, n) is not None}}
                  for blk in m.blocks]
        table = m.embed.table.detach()
        w = table.T if m.head is None else m.head.w.detach()
        return layers, _norm_p(m.final_norm), table, w

    @torch.no_grad()
    def forward_chunk(self, toks: torch.Tensor, cache: dict, pos):
        """toks (B, S) int -> (logits (B, S, V) float32, new cache).

        ``pos`` is the RoPE/mask position of the chunk's first token; k/v go
        at each layer's own cursor (kept equal to ``pos`` by the engine).
        The cache's k/v buffers are written in place (the JAX engine
        donates them); the returned cache holds them with cursors ``+ S``.
        """
        m, cfg = self.model, self.model.cfg
        layers, final_norm, table, w = self._params
        b, s = toks.shape
        kh, hd = cfg.num_kv_heads, cfg.head_dim
        x2 = F.embedding(toks.long(), table).reshape(b * s, cfg.d_model)
        pos0 = int(pos)
        for lp, slot in zip(layers, m.layer_slots()):
            lc = m.layer_cache(cache, slot)
            t = lc["k"].shape[1]
            kb, vb = lc["k"].view(b, t, kh * hd), lc["v"].view(b, t, kh * hd)
            q = qkv_rope(x2, lp["ln1"], lp["attn"], kb, vb, lc["pos"], pos0=pos0, seq=s,
                         norm=cfg.norm, eps=cfg.norm_eps, use_rope=cfg.rope_type == "default",
                         theta=cfg.rope_theta, heads=cfg.num_heads, kv_heads=kh, head_dim=hd)
            a = attn_cached(q, kb, vb, lc["pos"], pos0=pos0, seq=s, heads=cfg.num_heads,
                            kv_heads=kh, head_dim=hd)
            x2 = post_attn(a, x2, lp["attn"], lp["ln2"], lp["mlp"], norm=cfg.norm,
                           eps=cfg.norm_eps, act=cfg.act)
        new_cache = {group: {name: {"k": c["k"], "v": c["v"], "pos": c["pos"] + s}
                             for name, c in cache[group].items()}
                     for group in ("blocks", "rem")}
        new_cache["pre"] = {}
        logits = head(x2, final_norm, w, norm=cfg.norm, eps=cfg.norm_eps)
        return logits.reshape(b, s, cfg.vocab_size), new_cache
