"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: they skip without a CUDA device (a CUDA kernel has no CPU
or interpret mode). This file imports no jax, so it runs on a GPU machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.configs.dfm_dit import tiny_config
from repro_torch.core.paths import WarmStartPath
from repro_torch.drafting import ARDraftEngine, TransformerDraftAdapter, oracle_generate_rows
from repro_torch.kernels import launches
from repro_torch.kernels.draft_decode import (
    DraftDecoder, attn_cached, attn_cached_ref, head, head_ref, post_attn, post_attn_ref,
    qkv_rope, qkv_rope_ref,
)
from repro_torch.kernels.draft_decode import ops as draft_ops
from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref
from repro_torch.models import Model
from repro_torch.core.sampler import gumbel_step
from repro_torch.kernels.ws_fused import ws_fused_ref, ws_fused_steps
from repro_torch.kernels.ws_fused import ops as fused_ops
from repro_torch.kernels.ws_fused.ops import fused_inputs
from repro_torch.kernels.ws_step import (
    near_tie_rows, near_tie_rows_probs, seed_from_key, ws_step, ws_step_gumbel,
    ws_step_gumbel_keyed, ws_step_gumbel_ref, ws_step_ref_streamed, ws_step_rows,
    ws_step_rows_ref,
)
from repro_torch.kernels.ws_step import ops as ws_ops
from repro_torch.models import LSTMConfig, LSTMModel
from repro_torch.core.sampler import EulerSampler, refine_loop_inputs
from repro_torch.drafting import LSTMDraftAdapter
from repro_torch.graphs import GraphCaptureError
from repro_torch.kernels.ws_step import key_words, make_ws_step_fn
from repro_torch.serving import WarmStartServer, uniform_draft

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("r,v,temperature", [(8192, 27, 1.0), (64, 50257, 0.7), (5, 262144, 1.0),
                                           (2048, 51865, 1.0)])   # whisper-medium's refine
def test_ws_step_kernel_matches_plain(card, r, v, temperature):
    rng = np.random.default_rng(r + v)
    logits = torch.from_numpy((3 * rng.standard_normal((r, v))).astype(np.float32)).to(card)
    x = torch.from_numpy(rng.integers(0, v, r).astype(np.int32)).to(card)
    t = torch.full((r,), 0.85, device=card)
    h = torch.tensor(0.05, device=card)
    path = WarmStartPath(0.8)
    key = prng.key(r)
    before = launches["ws_step"]
    got = ws_step(key, logits, x, t, h, path, temperature=temperature)
    assert launches["ws_step"] == before + 1
    a = torch.clamp(h * path.velocity_scale(t), 0.0, 1.0)
    g = prng.threefry_gumbel(seed_from_key(key), r, v, device=card)
    want = ws_step_ref_streamed(logits, x, a, g, temperature=temperature)
    ties = near_tie_rows(logits, x, a, g, temperature=temperature, tol=1e-5)
    assert not bool(((got != want) & ~ties).any())


@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("v", [1, 2, 27, 31, 32, 33, 64, 100, 257, 1000, 50257])
@pytest.mark.parametrize("r", [1, 7, 8192])
def test_ws_step_group_sizes_agree_bitwise(card, r, v, temperature):
    """Both ws_step modes at every admissible lanes a row (and the kernels'
    own choice, lanes = 0) give the tokens of 32 lanes a row, draw_row's
    layout, bit for bit; rows 1 and 7 leave the last warp part empty. Row 0
    has a = 0 (kept), the last row's token is the last column."""
    g = torch.Generator(device=card).manual_seed(r + v)
    logits = 3.0 * torch.randn((r, v), generator=g, device=card)
    x = torch.randint(0, v, (r,), generator=g, device=card, dtype=torch.int32)
    x[-1] = v - 1
    a = torch.rand((r,), generator=g, device=card)
    a[0] = 0.0
    seed = seed_from_key(prng.key(v))
    b, n = (32, 256) if r == 8192 else (r, 1)
    keys = prng.key_data(prng.split(prng.key(r), b)).to(card, torch.int64)
    ab = a[::n].contiguous()
    outs = {}
    for lanes in (0, 2, 4, 8, 16, 32):
        step = torch.empty(r, dtype=torch.int32, device=card)
        rows = torch.empty((b, n), dtype=torch.int32, device=card)
        ws_ops._launch(logits, x, a, step, seed, temperature, lanes=lanes)
        ws_ops._launch_rows(logits.view(b, n, v), x.view(b, n), ab, keys, rows, temperature,
                            lanes=lanes)
        outs[lanes] = (step, rows.reshape(-1))
    for lanes, (step, rows) in outs.items():
        assert torch.equal(step, outs[32][0]), lanes
        assert torch.equal(rows, outs[32][1]), lanes
    assert int(outs[0][0][0]) == int(x[0]) and int(outs[0][1][0]) == int(x[0])
    assert ws_ops.lanes_for(v) in (2, 4, 8, 16, 32)
    noise = prng.threefry_gumbel(seed, r, v, device=card)
    want = ws_step_ref_streamed(logits, x, a, noise, temperature=temperature)
    ties = near_tie_rows(logits, x, a, noise, temperature=temperature, tol=1e-5)
    assert not bool(((outs[0][0] != want) & ~ties).any())


@pytest.mark.parametrize("b,s,t,h,kh,d,causal,window", [
    (4, 256, 256, 12, 12, 64, False, None), (2, 200, 200, 8, 2, 64, True, None),
    (2, 300, 300, 4, 4, 32, False, 37), (1, 130, 130, 4, 4, 128, True, 50),
    (3, 1, 1, 2, 1, 32, False, None),
    (2, 100, 300, 4, 4, 64, False, None),   # S != T
    (2, 77, 77, 8, 2, 64, True, None),      # a tail that is not a multiple of 8 or 16
    (2, 256, 256, 4, 4, 128, False, None),  # D = 128, bidirectional, whole tiles
    (2, 256, 256, 4, 4, 64, False, 5),      # a band narrower than a tile
    (2, 256, 256, 4, 2, 32, True, 5),       # a causal window narrower than a tile
    (2, 100, 100, 8, 2, 16, True, None),    # D = 16 (command-r-plus's smoke config)
    (2, 77, 77, 8, 2, 16, False, 20),       # D = 16, a bidirectional band
    (1, 600, 600, 4, 1, 256, False, 512),   # D = 256 (gemma3-1b's local layer), band cut
    (1, 300, 300, 4, 1, 256, True, 128),    # D = 256, a causal window
    (2, 130, 130, 4, 2, 256, True, None),   # D = 256, GQA, a tail
    (2, 256, 256, 32, 32, 80, False, None), # D = 80 (zamba2-2.7b's shared attention)
    (2, 256, 256, 32, 32, 80, True, None),  # D = 80, causal
    (2, 77, 77, 4, 2, 80, True, 20),        # D = 80, GQA, a causal window, a tail
    (2, 100, 300, 4, 4, 80, False, 37),     # D = 80, S != T, a bidirectional band
    (8, 256, 1500, 16, 16, 64, False, None),   # whisper-medium's cross attention
    (8, 1, 1500, 16, 16, 64, False, None),     # its decode: one query row, 1500 keys
    (8, 1500, 1500, 16, 16, 64, False, None),  # its encoder: a 28-key tail after 23 tiles
])
def test_flash_attention_kernel_matches_plain(card, b, s, t, h, kh, d, causal, window):
    g = torch.Generator(device=card).manual_seed(s)
    q = torch.randn((b, s, h, d), generator=g, device=card)
    k = torch.randn((b, t, kh, d), generator=g, device=card)
    v = torch.randn((b, t, kh, d), generator=g, device=card)
    before = launches["flash_attn"]
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert launches["flash_attn"] == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert float((got - want).abs().max()) <= 1e-4


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(card):
    q = torch.zeros(1, 8, 2, 48, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 64, device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32"):
        flash_attention(q, q, q)
    logits = torch.zeros(4, 27, device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32"):
        ws_step(prng.key(0), logits, torch.zeros(4, dtype=torch.int32, device=card), 0.5, 0.1,
                WarmStartPath())


# -- draft_decode ------------------------------------------------------------------------

def _layer(g, d, f, h, kh, hd, *, norm, bias, gated, device):
    def dense(i, o):
        p = {"w": torch.randn((i, o), generator=g, device=device) / i ** 0.5}
        if bias:
            p["b"] = 0.1 * torch.randn(o, generator=g, device=device)
        return p

    def ln():
        p = {"scale": 1.0 + 0.1 * torch.randn(d, generator=g, device=device)}
        if norm == "layernorm":
            p["bias"] = 0.1 * torch.randn(d, generator=g, device=device)
        return p

    attn = {"wq": dense(d, h * hd), "wk": dense(d, kh * hd), "wv": dense(d, kh * hd),
            "wo": dense(h * hd, d)}
    mlp = {"up": dense(d, f), "down": dense(f, d)}
    if gated:
        mlp["gate"] = dense(d, f)
    return ln(), attn, ln(), mlp


def _close(got, want, tol):
    return float((got - want).abs().max()) <= tol * max(1.0, float(want.abs().max()))


DRAFT_SHAPES = [
    # b, s, t, d, f, h, kh, hd, norm, bias, gated, act, rope
    (32, 1, 271, 768, 3072, 12, 12, 64, "layernorm", False, False, "gelu", True),
    (4, 16, 40, 768, 3072, 12, 12, 64, "layernorm", False, False, "gelu", True),
    (3, 5, 37, 96, 200, 8, 2, 32, "rmsnorm", True, True, "silu", False),
    (2, 3, 19, 64, 96, 2, 1, 128, "rmsnorm", True, True, "relu", True),
    (3, 11, 24, 128, 512, 4, 2, 32, "layernorm", True, False, "relu", True),  # R = 33
    # command-r-plus-104b's smoke layer: head_dim 16, GQA, SwiGLU, no bias
    (3, 5, 37, 128, 256, 8, 2, 16, "layernorm", False, True, "silu", True),
    # starcoder2-3b's layer at its published widths: the staged post_attn (K = 3072 up,
    # K = 12288 down), hd 128 GQA 24 / 2
    (8, 1, 64, 3072, 12288, 24, 2, 128, "layernorm", True, False, "gelu", True),
]


@pytest.mark.parametrize("b,s,t,d,f,h,kh,hd,norm,bias,gated,act,rope", DRAFT_SHAPES)
def test_draft_kernels_match_plain(card, b, s, t, d, f, h, kh, hd, norm, bias, gated, act,
                                   rope):
    g = torch.Generator(device=card).manual_seed(d + t)
    ln1, attn_p, ln2, mlp_p = _layer(g, d, f, h, kh, hd, norm=norm, bias=bias, gated=gated,
                                     device=card)
    r = b * s
    x = torch.randn((r, d), generator=g, device=card)
    kbuf = torch.randn((b, t, kh * hd), generator=g, device=card)
    vbuf = torch.randn((b, t, kh * hd), generator=g, device=card)
    start = torch.tensor(t // 2 - s, dtype=torch.int32, device=card)
    kw = dict(heads=h, kv_heads=kh, head_dim=hd)
    rope_kw = dict(pos0=int(start), seq=s, norm=norm, eps=1e-6, use_rope=rope, theta=1e4, **kw)
    before = dict(launches)
    kk, vk, kr, vr = kbuf.clone(), vbuf.clone(), kbuf.clone(), vbuf.clone()
    q = qkv_rope(x, ln1, attn_p, kk, vk, start, **rope_kw)
    q_ref = qkv_rope_ref(x, ln1, attn_p, kr, vr, start, **rope_kw)
    assert _close(q, q_ref, 1e-4) and _close(kk, kr, 1e-4) and _close(vk, vr, 1e-4)
    a = attn_cached(q_ref, kr, vr, start, pos0=int(start), seq=s, **kw)
    assert float((a - attn_cached_ref(q_ref, kr, vr, start, pos0=int(start), seq=s,
                                      **kw)).abs().max()) <= 1e-5
    out = post_attn(a, x, attn_p, ln2, mlp_p, norm=norm, eps=1e-6, act=act)
    assert _close(out, post_attn_ref(a, x, attn_p, ln2, mlp_p, norm=norm, eps=1e-6, act=act),
                  1e-4)
    w = torch.randn((27, d), generator=g, device=card).T      # a tied (transposed) head
    assert _close(head(out, ln1, w, norm=norm, eps=1e-6), head_ref(out, ln1, w, norm=norm,
                                                                     eps=1e-6), 1e-4)
    torch.cuda.synchronize()
    for name in ("qkv_rope", "attn_cached", "post_attn", "head"):
        assert launches[name] == before.get(name, 0) + 1


# d, f, h, kh, hd, norm, bias, gated, act: the full-width ungated layer; a gated one
# with bias whose up/gate (F = 200) and down (D = 96) leave partial column tiles; widths
# that are not multiples of 4 (the kernel's 4-byte copies)
POST_LAYERS = {
    "full-width-layernorm-gelu": (768, 3072, 12, 12, 64, "layernorm", False, False, "gelu"),
    "gated-rmsnorm-silu-bias": (96, 200, 8, 2, 32, "rmsnorm", True, True, "silu"),
    "odd-widths-layernorm-relu": (90, 198, 8, 2, 32, "layernorm", True, False, "relu"),
    # starcoder2-3b's widths: up and down take the staged path
    "staged-starcoder2-3b": (3072, 12288, 24, 2, 128, "layernorm", True, False, "gelu"),
}


@pytest.mark.parametrize("layer", sorted(POST_LAYERS))
@pytest.mark.parametrize("r", [1, 7, 32, 33, 512])
def test_post_attn_kernel_is_batch_invariant(card, r, layer):
    """R rows in one call give each row's bits alone: the K split and the
    order of its sums do not depend on R or on a row's place in its tile."""
    d, f, h, kh, hd, norm, bias, gated, act = POST_LAYERS[layer]
    g = torch.Generator(device=card).manual_seed(r + d)
    _, attn_p, ln2, mlp_p = _layer(g, d, f, h, kh, hd, norm=norm, bias=bias, gated=gated,
                                   device=card)
    a = torch.randn((r, h * hd), generator=g, device=card)
    x = torch.randn((r, d), generator=g, device=card)
    kw = dict(norm=norm, eps=1e-6, act=act)
    out = post_attn(a, x, attn_p, ln2, mlp_p, **kw)
    alone = torch.cat([post_attn(a[i:i + 1], x[i:i + 1], attn_p, ln2, mlp_p, **kw)
                       for i in range(r)])
    assert torch.equal(out, alone)
    assert _close(out, post_attn_ref(a, x, attn_p, ln2, mlp_p, **kw), 1e-4)


@pytest.mark.parametrize("layer", sorted(k for k in POST_LAYERS if not k.startswith("staged")))
def test_post_attn_staged_path_equals_whole_slice_bitwise(card, layer):
    """Where a slice fits at once, streaming it in stages gives the same bits:
    each FMA chain runs on across the stages in increasing k."""
    d, f, h, kh, hd, norm, bias, gated, act = POST_LAYERS[layer]
    g = torch.Generator(device=card).manual_seed(d + f)
    _, attn_p, ln2, mlp_p = _layer(g, d, f, h, kh, hd, norm=norm, bias=bias, gated=gated,
                                   device=card)
    r = 40
    a = torch.randn((r, h * hd), generator=g, device=card)
    x = torch.randn((r, d), generator=g, device=card)
    outs = []
    for staged in (False, True):
        bufs = (torch.empty_like(x), torch.empty((r, f), device=card), torch.empty_like(x))
        draft_ops._launch_post_attn(a, x, attn_p, ln2, mlp_p, *bufs, norm=norm, eps=1e-6,
                                    act=act, staged=staged)
        outs.append(bufs)
    for whole, staged in zip(*outs):
        assert torch.equal(whole, staged)


@pytest.mark.parametrize("f", [12288, 9216])
@pytest.mark.parametrize("r", [8, 32])
def test_post_attn_kernel_at_zoo_widths(card, r, f):
    """D = 3072 with F = 12288 (starcoder2-3b) and 9216 (minitron-4b): the
    slices of up and down do not fit at once and stream in stages."""
    d, h, kh, hd = 3072, 24, 2, 128
    # up (K = 3072) and down (K = 12288) both take the staged path, whose size
    # depends on the slab's width alone
    assert draft_ops._post_smem(d, 128) == draft_ops._post_smem(4 * d, 128)
    assert draft_ops._post_smem(f, 64) == draft_ops._post_smem(4 * f, 64)
    g = torch.Generator(device=card).manual_seed(r + f)
    _, attn_p, ln2, mlp_p = _layer(g, d, f, h, kh, hd, norm="layernorm", bias=True,
                                   gated=False, device=card)
    a = torch.randn((r, h * hd), generator=g, device=card)
    x = torch.randn((r, d), generator=g, device=card)
    kw = dict(norm="layernorm", eps=1e-5, act="gelu" if f == 12288 else "relu")
    before = launches["post_attn"]
    out = post_attn(a, x, attn_p, ln2, mlp_p, **kw)
    assert launches["post_attn"] == before + 1
    assert _close(out, post_attn_ref(a, x, attn_p, ln2, mlp_p, **kw), 1e-4)


# d, h, kh, hd, norm, bias, rope, unaligned: the full-width layer; head dims 32 and 128
# (D = 640: the slab of 80 k rows streams in two stages of 64); GQA; rmsnorm with bias
# at D = 90 (short and empty slices, 4-byte copies); no RoPE; D = 520, not a multiple
# of 64; D = 2056 (three stages of up to 128 k rows); x as a view 4 bytes off a 16-byte
# boundary (4-byte copies)
QKV_LAYERS = {
    "full-width-layernorm": (768, 12, 12, 64, "layernorm", False, True, False),
    "hd32": (256, 8, 8, 32, "layernorm", False, True, False),
    "hd128-staged": (640, 4, 2, 128, "layernorm", True, True, False),
    "hd16": (128, 8, 2, 16, "layernorm", False, True, False),
    "gqa": (512, 8, 2, 64, "layernorm", False, True, False),
    "rmsnorm-bias-d90": (90, 4, 2, 32, "rmsnorm", True, True, False),
    "no-rope": (256, 4, 2, 64, "layernorm", False, False, False),
    "d520": (520, 4, 4, 64, "layernorm", True, True, False),
    "d2056-staged": (2056, 2, 1, 64, "rmsnorm", False, True, False),
    "unaligned-view": (192, 4, 2, 32, "layernorm", False, True, True),
}


def _qkv_case(card, layer, b, r, t, seed):
    d, h, kh, hd, norm, bias, rope, unaligned = QKV_LAYERS[layer]
    g = torch.Generator(device=card).manual_seed(seed)
    ln1, attn_p, _, _ = _layer(g, d, 8, h, kh, hd, norm=norm, bias=bias, gated=False,
                               device=card)
    x = torch.randn((r, d), generator=g, device=card)
    if unaligned:
        x = torch.cat([torch.zeros(1, device=card), x.reshape(-1)])[1:].view(r, d)
        assert x.is_contiguous() and x.data_ptr() % 16 == 4
    kbuf = torch.randn((b, t, kh * hd), generator=g, device=card)
    kw = dict(norm=norm, eps=1e-6, use_rope=rope, theta=1e4, heads=h, kv_heads=kh, head_dim=hd)
    return ln1, attn_p, x, kbuf, kw


@pytest.mark.parametrize("layer", sorted(QKV_LAYERS))
@pytest.mark.parametrize("r", [1, 7, 32, 33, 512])
def test_qkv_rope_kernel_is_batch_invariant(card, r, layer):
    """A prefill of R tokens in one call gives each token's bits alone (one
    call per token at its own position and cursor), for q and the k/v cache
    rows: the K split, the statistics and the order of their sums do not
    depend on R or on a row's place in its tile."""
    ln1, attn_p, x, kbuf, kw = _qkv_case(card, layer, 1, r, r + 3, r + 7)
    vbuf = torch.randn_like(kbuf)
    kb, vb = kbuf.clone(), vbuf.clone()
    start = torch.zeros((), dtype=torch.int32, device=card)
    q = qkv_rope(x, ln1, attn_p, kb, vb, start, pos0=0, seq=r, **kw)
    ka, va = kbuf.clone(), vbuf.clone()
    alone = torch.cat([
        qkv_rope(x[i:i + 1], ln1, attn_p, ka, va, torch.tensor(i, dtype=torch.int32, device=card),
                 pos0=i, seq=1, **kw) for i in range(r)])
    assert torch.equal(q, alone) and torch.equal(kb, ka) and torch.equal(vb, va)
    kr, vr = kbuf.clone(), vbuf.clone()
    q_ref = qkv_rope_ref(x, ln1, attn_p, kr, vr, start, pos0=0, seq=r, **kw)
    assert _close(q, q_ref, 1e-4) and _close(kb, kr, 1e-4) and _close(vb, vr, 1e-4)


@pytest.mark.parametrize("cursor", [-3, 5, 40])
def test_qkv_rope_kernel_clamps_the_cursor(card, cursor):
    """k/v land at clamp(*cache_pos, 0, T - S) + i, as dynamic_update_slice
    clamps: a cursor below 0 writes from row 0, one past T - S from T - S."""
    b, s, t = 2, 3, 10
    ln1, attn_p, x, kbuf, kw = _qkv_case(card, "gqa", b, b * s, t, cursor + 50)
    vbuf = torch.randn_like(kbuf)
    start = torch.tensor(cursor, dtype=torch.int32, device=card)
    kk, vk, kr, vr = kbuf.clone(), vbuf.clone(), kbuf.clone(), vbuf.clone()
    q = qkv_rope(x, ln1, attn_p, kk, vk, start, pos0=7, seq=s, **kw)
    q_ref = qkv_rope_ref(x, ln1, attn_p, kr, vr, start, pos0=7, seq=s, **kw)
    assert _close(q, q_ref, 1e-4) and _close(kk, kr, 1e-4) and _close(vk, vr, 1e-4)
    w0 = min(max(cursor, 0), t - s)
    untouched = torch.ones(t, dtype=torch.bool, device=card)
    untouched[w0:w0 + s] = False
    assert torch.equal(kk[:, untouched], kbuf[:, untouched])
    assert torch.equal(vk[:, untouched], vbuf[:, untouched])
    assert not torch.equal(kk[:, w0:w0 + s], kbuf[:, w0:w0 + s])


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("v", [27, 1000, 50257])
@pytest.mark.parametrize("d", [64, 90, 768, 2056])
@pytest.mark.parametrize("r", [1, 7, 32, 33, 512])
def test_head_kernel_is_batch_invariant(card, r, d, v, tied, norm):
    """R rows in one call give each row's logits alone, bitwise, whatever
    R, the row's place in its tile of (RT, NT) = head_tiling(D, V) and the
    weights' layout (tied: the (V, D) table transposed, read through its
    strides); and within 1e-4 x max(1, max|plain|) of the plain version."""
    g = torch.Generator(device=card).manual_seed(r + d + v)
    x = torch.randn((r, d), generator=g, device=card)
    fn = {"scale": 0.1 * torch.randn(d, generator=g, device=card)}
    if norm == "layernorm":
        fn["scale"] += 1.0
        fn["bias"] = 0.1 * torch.randn(d, generator=g, device=card)
    w = (torch.randn((v, d), generator=g, device=card).T if tied
         else torch.randn((d, v), generator=g, device=card)) / d ** 0.5
    before = launches["head"]
    out = head(x, fn, w, norm=norm, eps=1e-6)
    assert launches["head"] == before + 1
    alone = torch.cat([head(x[i:i + 1], fn, w, norm=norm, eps=1e-6) for i in range(r)])
    assert torch.equal(out, alone)
    assert _close(out, head_ref(x, fn, w, norm=norm, eps=1e-6), 1e-4)
    rt, nt = draft_ops._head_tiling(d, v)
    assert rt in (1, 2, 4, 8) and nt in (4, 8, 16, 32)


def _draft_model(card, **kw):
    cfg = tiny_config(vocab_size=27).replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, **kw)
    return Model(cfg, device=card, seed=1)


@pytest.mark.parametrize("kw", [{}, dict(norm="rmsnorm", use_bias=True, mlp_gated=True,
                                         tie_embeddings=True, rope_type="none")])
def test_draft_kernels_batched_equals_scan_bitwise(card, kw):
    model = _draft_model(card, **kw)
    dec = DraftDecoder(model)
    toks = torch.randint(0, 27, (5, 8), device=card,
                         generator=torch.Generator(device=card).manual_seed(0))
    runs = []
    for split in ((8,), (1,) * 8, (3, 1, 4)):
        cache, parts, pos = model.init_cache(5, 12, torch.float32), [], 0
        for w in split:
            lg, cache = dec.forward_chunk(toks[:, pos:pos + w], cache, pos)
            parts.append(lg)
            pos += w
        runs.append((torch.cat(parts, 1), cache))
    (ref, ref_cache), *others = runs
    for lg, cache in others:
        assert torch.equal(lg, ref)
        for k in ("k", "v", "pos"):
            assert torch.equal(cache["blocks"]["p0"][k], ref_cache["blocks"]["p0"][k])


def test_draft_engine_equals_oracle_on_card(card):
    adapter = TransformerDraftAdapter(model=_draft_model(card), decode_impl="kernel")
    keys = prng.split(prng.key(3), 3)
    prompt = torch.tensor([[1, 2, 3]] * 3, dtype=torch.int32)
    eng = ARDraftEngine(adapter, max_len=14)
    out = eng.generate_rows(keys, 12, prompt=prompt)
    assert out.device.type == "cuda" and out.dtype == torch.int32
    ref = oracle_generate_rows(adapter, keys, 12, prompt=prompt, max_len=14)
    assert torch.equal(out, ref)
    assert torch.equal(eng.generate_rows(keys, 12, prompt=prompt), ref)   # prefix reused
    assert eng.stats.prefill_reuses == 1


def test_draft_wrappers_reject_what_the_kernels_do_not_take(card):
    x = torch.zeros(4, 64, device=card)
    ln = {"scale": torch.zeros(64, device=card)}
    with pytest.raises(ValueError, match="float32"):
        head(x.half(), ln, torch.zeros(64, 27, device=card), norm="rmsnorm", eps=1e-6)
    q = torch.zeros(4, 2 * 48, device=card)
    buf = torch.zeros(4, 8, 2 * 48, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        attn_cached(q, buf, buf, torch.zeros((), dtype=torch.int32, device=card), pos0=0,
                    seq=1, heads=2, kv_heads=2, head_dim=48)
    attn_p = {n: {"w": torch.zeros(64, 2 * 48, device=card)} for n in ("wq", "wk", "wv")}
    with pytest.raises(ValueError, match="head_dim"):
        qkv_rope(x, ln, attn_p, buf, buf, torch.zeros((), dtype=torch.int32, device=card),
                 pos0=0, seq=1, norm="rmsnorm", eps=1e-6, use_rope=True, theta=1e4, heads=2,
                 kv_heads=2, head_dim=48)


# -- the scheduler's per-row ws_step mode and ws_fused ---------------------------------------

TIE_TOL = 1e-5


def _step_inputs(card, b, n, v, seed):
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy((3 * rng.standard_normal((b, n, v))).astype(np.float32)).to(card)
    x = torch.from_numpy(rng.integers(0, v, (b, n)).astype(np.int32)).to(card)
    return logits, x


@pytest.mark.parametrize("b,n,v", [(32, 256, 27), (4, 16, 50257), (3, 7, 5)])
def test_ws_step_rows_kernel_matches_plain(card, b, n, v):
    """Tokens equal the plain version's off rows whose draw is a near tie
    (keep-vs-move scores or the best two candidates within 1e-5)."""
    logits, x = _step_inputs(card, b, n, v, b * n + v)
    keys = prng.split(prng.key(b + v), b).to(card)
    t = torch.linspace(0.5, 0.9, b, device=card)
    h = torch.full((b,), 1 / 16, device=card)
    h[0] = 0.0                                           # an inactive request row
    path = WarmStartPath(0.0)
    before = launches["ws_step_rows"]
    got = ws_step_rows(keys, logits, x, t, h, path)
    assert launches["ws_step_rows"] == before + 1
    a = torch.clamp(h * path.velocity_scale(t), 0.0, 1.0)
    want = ws_step_rows_ref(keys, logits, x, a)
    g = prng.gumbel(keys, (n, v), device=card).reshape(b * n, v)
    ties = near_tie_rows(logits.reshape(b * n, v), x.reshape(-1), a.repeat_interleave(n), g,
                         tol=TIE_TOL).reshape(b, n)
    assert not bool(((got != want) & ~ties).any())
    assert torch.equal(got[0], x[0])                     # a = 0 freezes the row


def _fused_case(card, layout, k, b, n, v, seed):
    logits, x = _step_inputs(card, b, n, v, seed)
    if layout == "single":
        keys = prng.split(prng.key(seed), k)
        ts = 0.5 + torch.arange(k, dtype=torch.float32) / 16
        hs = torch.full((k,), 1 / 16)
        hs[-1] = 0.0                                     # a padded tail step
    else:
        keys = prng.fold_in(prng.split(prng.key(seed), b)[None], torch.arange(k)[:, None])
        ts = 0.5 + torch.arange(k, dtype=torch.float32)[:, None].expand(k, b) / 16
        hs = torch.full((k, b), 1 / 16)
        hs[:, 0] = 0.0                                   # an inactive request row
        hs[: k // 2, 1] = 0.0                            # a row entering mid-block
    return keys.to(card), logits, x, ts.to(card), hs.to(card)


@pytest.mark.parametrize("layout", ["single", "rows"])
@pytest.mark.parametrize("k,v", [(2, 27), (4, 27), (8, 27), (4, 50257)])
def test_ws_fused_kernel_equals_composed_bitwise(card, layout, k, v):
    b, n = (8, 64) if v == 27 else (2, 8)
    keys, logits, x, ts, hs = _fused_case(card, layout, k, b, n, v, k + v)
    path = WarmStartPath(0.0)
    before = launches["ws_fused"]
    got = ws_fused_steps(keys, logits, x, ts, hs, path)
    assert launches["ws_fused"] == before + 1
    if layout == "single":
        want = x
        for j in range(k):
            want = ws_step(keys[j].cpu(), logits, want, ts[j], hs[j], path)
    else:
        want = ws_fused_steps(keys, logits, x, ts, hs, path, impl="composed")
        assert torch.equal(got[0], x[0])                 # a = 0 on every step: frozen
    assert torch.equal(got, want)


@pytest.mark.parametrize("layout", ["single", "rows"])
@pytest.mark.parametrize("k,v", [(4, 27), (2, 50257)])
def test_ws_fused_kernel_matches_plain(card, layout, k, v):
    b, n = (8, 64) if v == 27 else (2, 8)
    keys, logits, x, ts, hs = _fused_case(card, layout, k, b, n, v, 3 * k + v)
    path = WarmStartPath(0.0)
    got = ws_fused_steps(keys, logits, x, ts, hs, path).reshape(-1)
    seeds, lg, xr, a, key_group, a_group = fused_inputs(keys, logits, x, ts, hs, path)
    want, ties = ws_fused_ref(seeds, lg, xr, a, key_group=key_group, a_group=a_group,
                              tie_tol=TIE_TOL)
    assert not bool(((got != want) & ~ties).any())


def test_ws_fused_and_rows_wrappers_reject_what_the_kernels_do_not_take(card):
    logits, x = _step_inputs(card, 2, 4, 27, 0)
    keys = prng.split(prng.key(0), 2).to(card)
    path = WarmStartPath(0.0)
    with pytest.raises(ValueError, match="float32"):
        ws_step_rows(keys, logits.half(), x, 0.5, 0.1, path)
    with pytest.raises(ValueError, match="hw_prng"):
        ws_fused_steps(keys, logits, x, torch.zeros(2, device=card),
                       torch.zeros(2, device=card), path, hw_prng=True)
    with pytest.raises(ValueError, match="float32"):
        ws_fused_steps(keys, logits.half(), x, torch.zeros(2, device=card),
                       torch.zeros(2, device=card), path)


@pytest.mark.parametrize("r,vp,valid_v,temperature", [(8192, 27, 27, 1.0), (13, 640, 517, 0.7)])
def test_ws_step_gumbel_kernel_matches_plain(card, r, vp, valid_v, temperature):
    """The second case pads 517 columns to 640 with values that would win
    every row if the kernel read them; 13 rows, no row block."""
    rng = np.random.default_rng(r + vp)
    logits = np.full((r, vp), 60.0, np.float32)
    logits[:, :valid_v] = 3 * rng.standard_normal((r, valid_v))
    x = rng.integers(0, valid_v, (r, 1)).astype(np.int32)
    a = rng.uniform(size=(r, 1)).astype(np.float32)
    a[0] = 0.0
    g = rng.gumbel(size=(r, vp)).astype(np.float32)
    args = [torch.from_numpy(z).to(card) for z in (logits, x, a, g)]
    before = launches["ws_step_gumbel"]
    got = ws_step_gumbel(*args, valid_v=valid_v, row_block=1, temperature=temperature)
    assert launches["ws_step_gumbel"] == before + 1
    want = ws_step_gumbel_ref(*args, valid_v=valid_v, temperature=temperature)
    ties = near_tie_rows_probs(*args, valid_v=valid_v, temperature=temperature, tol=1e-5)
    assert got.shape == (r, 1) and got.dtype == torch.int32
    assert not bool(((got != want)[:, 0] & ~ties).any())
    assert int(got[0, 0]) == int(x[0, 0]) and int(got.max()) < valid_v
    with pytest.raises(ValueError):
        ws_step_gumbel(*args, valid_v=valid_v, row_block=2 if r % 2 else 3)


LANES = (0, 2, 4, 8, 16, 32)        # 0: the kernels' own choice


@pytest.mark.parametrize("r,vp,valid_v,temperature", [
    (8192, 27, 27, 1.0), (64, 50257, 50257, 0.7), (8, 262144, 262144, 1.0),
    (13, 640, 517, 1.0), (7, 27, 27, 0.7)])
def test_ws_step_gumbel_keyed_equals_given_bitwise(card, r, vp, valid_v, temperature):
    """The keyed launch at every lanes a row equals the given-noise launch on
    prng.gumbel(key, (R, Vp)) at the same G, bit for bit; through the wrapper
    (one counted launch) it equals the plain version off near ties. Row 0 has
    a = 0 (kept); the padding (60) would win every row if it were read."""
    g = torch.Generator(device=card).manual_seed(r + vp)
    logits = torch.full((r, vp), 60.0, device=card)
    logits[:, :valid_v] = 3.0 * torch.randn((r, valid_v), generator=g, device=card)
    x = torch.randint(0, valid_v, (r,), generator=g, device=card, dtype=torch.int32)
    a = torch.rand((r,), generator=g, device=card)
    a[0] = 0.0
    key = prng.key(r + vp)
    noise = prng.gumbel(key, (r, vp), device=card)
    outs = {}
    for lanes in LANES:
        keyed = torch.empty(r, dtype=torch.int32, device=card)
        given = torch.empty((r, 1), dtype=torch.int32, device=card)
        ws_ops._launch_gumbel_keyed(logits, x, a, seed_from_key(key), keyed, valid_v,
                                    temperature, lanes=lanes)
        ws_ops._launch_gumbel(logits, x[:, None], a[:, None], noise, given, valid_v,
                              temperature, lanes=lanes)
        assert torch.equal(keyed, given[:, 0]), lanes
        outs[lanes] = keyed
    assert torch.equal(outs[0], outs[ws_ops.lanes_for(valid_v)])
    before = launches["ws_step_gumbel"]
    got = ws_step_gumbel_keyed(key, logits, x, a, valid_v=valid_v, temperature=temperature)
    assert launches["ws_step_gumbel"] == before + 1
    assert torch.equal(got, outs[0])
    want = ws_step_gumbel_ref(logits, x[:, None], a[:, None], noise, valid_v=valid_v,
                              temperature=temperature)[:, 0]
    ties = near_tie_rows_probs(logits, x[:, None], a[:, None], noise, valid_v=valid_v,
                               temperature=temperature, tol=1e-5)
    assert not bool(((got != want) & ~ties).any())
    assert int(got[0]) == int(x[0]) and int(got.max()) < valid_v


def test_gumbel_step_is_one_keyed_launch_with_a_weight_a_batch_row(card):
    """The default Euler step on the card: one ws_step_gumbel launch (a (B,) of
    weights, a_group = N) whose tokens equal the given-noise kernel's on
    prng.gumbel(rng, (B, N, V)) with the weights expanded to every row."""
    b, n, v = 32, 256, 27
    g = torch.Generator(device=card).manual_seed(3)
    logits = 3.0 * torch.randn((b, n, v), generator=g, device=card)
    x = torch.randint(0, v, (b, n), generator=g, device=card, dtype=torch.int32)
    t = torch.linspace(0.8, 0.95, b, device=card)
    h = torch.tensor(1 / 64, device=card)
    path = WarmStartPath(0.8)
    key = prng.key(4)
    before = dict(launches)
    got = gumbel_step(key, logits, x, t, h, path)
    assert {k: c - before.get(k, 0) for k, c in launches.items()
            if c != before.get(k, 0)} == {"ws_step_gumbel": 1}
    a = torch.clamp(h * path.velocity_scale(t), 0.0, 1.0)
    want = ws_step_gumbel(logits.reshape(-1, v), x.reshape(-1, 1),
                          a.repeat_interleave(n).reshape(-1, 1),
                          prng.gumbel(key, (b, n, v), device=card).reshape(-1, v), valid_v=v,
                          row_block=1)
    assert got.shape == (b, n) and torch.equal(got.reshape(-1), want[:, 0])


def test_ws_step_gumbel_keyed_refuses_2_32_elements(card):
    """(2**16, 2**16) elements: the wrapper refuses, as jax.random does, and so
    does the C entry point, before anything is read."""
    big = torch.zeros(1, 1, device=card).expand(1 << 16, 1 << 16)
    x = torch.zeros(1, dtype=torch.int32, device=card).expand(1 << 16)
    a = torch.zeros(1, device=card)
    with pytest.raises(NotImplementedError, match="2\\*\\*32"):
        ws_step_gumbel_keyed(prng.key(0), big, x, a)
    out = torch.empty(1, dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="ws_step_gumbel launch failed"):
        ws_ops._launch_gumbel_keyed(big, x, a, (0, 0), out, 1 << 16, 1.0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("layout", ["single", "rows"])
@pytest.mark.parametrize("k,v,b,n,temperature", [
    (4, 27, 8, 64, 1.0), (3, 200, 8, 64, 0.7), (2, 50257, 2, 8, 1.0), (2, 5, 3, 7, 1.0)])
def test_ws_fused_group_sizes_agree_bitwise(card, layout, k, v, b, n, temperature):
    """ws_fused at every lanes a row (lg kept in registers where V <= 16 G, so
    at V = 200 both ways) equals 32 lanes a row and K composed launches (single
    key: K ws_step launches; per row: K one-step ws_fused launches), bit for
    bit; 21 rows leave the last warp part empty."""
    keys, logits, x, ts, hs = _fused_case(card, layout, k, b, n, v, 7 * k + v)
    path = WarmStartPath(0.0)
    seeds, lg, xr, a, key_group, a_group = fused_inputs(keys, logits, x, ts, hs, path)
    sd = seeds.to(card, torch.int64).contiguous()
    x32, a = xr.to(torch.int32).contiguous(), a.contiguous()
    outs = {}
    for lanes in LANES:
        outs[lanes] = torch.empty(b * n, dtype=torch.int32, device=card)
        fused_ops._launch(lg, x32, a, sd, outs[lanes], key_group, a_group, temperature,
                          lanes=lanes)
    if layout == "single":
        want = x
        for j in range(k):
            want = ws_step(keys[j].cpu(), logits, want, ts[j], hs[j], path,
                           temperature=temperature)
    else:
        want = ws_fused_steps(keys, logits, x, ts, hs, path, temperature=temperature,
                              impl="composed")
    for lanes, out in outs.items():
        assert torch.equal(out, outs[32]), lanes
        assert torch.equal(out, want.reshape(-1)), lanes


def test_lstm_generate_on_card_equals_cpu(card):
    model = LSTMModel(LSTMConfig(vocab_size=27, hidden=32, num_layers=2, embed_dim=16))
    params = model.init(5, device="cpu")
    on_card = {"embed": {"table": params["embed"]["table"].to(card)},
               "layers": [{k: {"w": lp[k]["w"].to(card)} for k in ("wx", "wh")}
                          for lp in params["layers"]],
               "head": {"w": params["head"]["w"].to(card)}}
    got = model.generate(on_card, prng.key(9), 4, 16)
    want = model.generate(params, prng.key(9), 4, 16)
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


# -- CUDA graphs of the loops ---------------------------------------------------------


def _grew(fn):
    """``fn()``'s result and the launches it added, by kernel."""
    before = dict(launches)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c - before.get(k, 0) for k, c in launches.items() if c != before.get(k, 0)}


@pytest.mark.parametrize("r,v", [(8192, 27), (64, 50257), (7, 27)])
def test_device_key_equals_host_key_bitwise(card, r, v):
    """ws_step and the keyed ws_step_gumbel with the key's words read from
    the card (the entry points a refine graph takes) equal the launches with
    the words passed as integers, bit for bit, at every lanes a row; the
    wrappers take that path for a key on the card, one counted launch each."""
    g = torch.Generator(device=card).manual_seed(r + v)
    logits = 3.0 * torch.randn((r, v), generator=g, device=card)
    x = torch.randint(0, v, (r,), generator=g, device=card, dtype=torch.int32)
    a = torch.rand((r,), generator=g, device=card)
    key = prng.key(r * v)
    dkey = key.to(card)
    for lanes in LANES:
        out = [torch.empty(r, dtype=torch.int32, device=card) for _ in range(4)]
        ws_ops._launch(logits, x, a, out[0], seed_from_key(key), 0.9, lanes=lanes)
        ws_ops._launch(logits, x, a, out[1], key_words(dkey), 0.9, lanes=lanes)
        ws_ops._launch_gumbel_keyed(logits, x, a, seed_from_key(key), out[2], v, 0.9,
                                    lanes=lanes)
        ws_ops._launch_gumbel_keyed(logits, x, a, key_words(dkey), out[3], v, 0.9,
                                    lanes=lanes)
        assert torch.equal(out[0], out[1]) and torch.equal(out[2], out[3]), lanes
    t = torch.full((r,), 0.85, device=card)
    h = torch.tensor(0.05, device=card)
    path = WarmStartPath(0.8)
    (got, got_g), grew = _grew(lambda: (ws_step(dkey, logits, x, t, h, path),
                                        ws_step_gumbel_keyed(dkey, logits, x, a)))
    assert grew == {"ws_step": 1, "ws_step_gumbel": 1}
    assert torch.equal(got, ws_step(key, logits, x, t, h, path))
    assert torch.equal(got_g, ws_step_gumbel_keyed(key, logits, x, a))


def _graph_adapter(card, kind):
    if kind == "lstm":
        lstm = LSTMModel(LSTMConfig(vocab_size=27, hidden=32, num_layers=2, embed_dim=16))
        return LSTMDraftAdapter(model=lstm, params=lstm.init(4, device=card))
    return TransformerDraftAdapter(model=_draft_model(card), decode_impl=kind)


@pytest.mark.parametrize("kind", ["kernel", "xla", "lstm"])
def test_decode_graph_equals_eager_bitwise(card, kind):
    """generate_rows on the card replays one decode graph per (rows, prefix,
    seq_len): over calls with different keys, a reused prefix, a recomputed
    one and a return to the first, its tokens and launch counts equal an
    eager engine's bit for bit (the capturing call counts its warm-up's
    eager decode too); one capture for the four calls, and one more for
    another seq_len."""
    adapter = _graph_adapter(card, kind)
    eng, eager = ARDraftEngine(adapter, max_len=16), ARDraftEngine(adapter, max_len=16)
    prompt = torch.tensor([[1, 2, 3]] * 3, dtype=torch.int32)
    other = torch.tensor([[4, 5, 6], [7, 8, 9], [1, 1, 1]], dtype=torch.int32)
    for seed, p in ((3, prompt), (4, prompt), (5, other), (6, prompt)):
        keys = prng.split(prng.key(seed), 3)
        got, n_got = _grew(lambda: eng.generate_rows(keys, 12, prompt=p))
        want, n_want = _grew(lambda: eager._generate_rows_eager(keys, 12, prompt=p))
        assert got.device.type == "cuda" and torch.equal(got, want), seed
        if seed == 3:
            # the capture's warm-up runs the decode once more, eagerly: one
            # decode's launches (a reused prefix, so no prefill) on top
            probe = ARDraftEngine(adapter, max_len=16)
            probe._generate_rows_eager(keys, 12, prompt=p)
            _, n_decode = _grew(lambda: probe._generate_rows_eager(keys, 12, prompt=p))
            n_want = {k: c + n_decode.get(k, 0) for k, c in n_want.items()}
        assert n_got == n_want, seed
    assert (eng.graphs.captures, eng.graphs.replays) == (1, 4)
    assert eng.stats.as_dict() == eager.stats.as_dict()
    keys = prng.split(prng.key(7), 3)
    assert torch.equal(eng.generate_rows(keys, 8, prompt=prompt),
                       eager._generate_rows_eager(keys, 8, prompt=prompt))
    assert eng.graphs.captures == 2
    eng.reset()
    assert len(eng.graphs) == 0


def _refine_model(card):
    return Model(tiny_config(vocab_size=27).replace(num_layers=2), device=card, seed=2)


@pytest.mark.parametrize("step", ["default", "ws_step", "fused"])
def test_serve_refine_graph_equals_eager_bitwise(card, step):
    """WarmStartServer's refine on the card is one graph replay a serve,
    captured once for its shape: over three calls with different keys its
    tokens and launch counts equal the eager loop's bit for bit (the default
    step, ws_step as step_fn, fused_block = 2)."""
    path = WarmStartPath(t0=0.75)
    kw = {"default": {}, "ws_step": dict(step_fn=make_ws_step_fn(path)),
          "fused": dict(fused_block=2)}[step]
    model = _refine_model(card)
    draft = uniform_draft(27, device=card)
    server = WarmStartServer(flow_model=model, flow_cfg=model.cfg, path=path, cold_nfe=16,
                             draft_generate=lambda rng, num: draft(prng.split(rng, num), 32),
                             device=card, **kw)
    x, report = server.serve(prng.key(1), 4)
    assert server.graphs.captures == 1 and x.shape == (4, 32)
    assert server.cost_model._compile is not None and not server.cost_model._per_key
    for seed in (2, 3):
        x0 = draft(prng.split(prng.key(seed), 4), 32)
        keys, ts, hs = refine_loop_inputs(prng.key(seed + 10), 0.75, 1 / 16, 4)
        with torch.inference_mode():
            got, n_got = _grew(lambda: server._refine_loop(keys, x0, ts, hs))
            want, n_want = _grew(lambda: server._refine_loop_eager(keys, x0, ts, hs))
        assert torch.equal(got, want) and n_got == n_want, seed
        evals = 2 if step == "fused" else 4
        assert n_got["flash_attn"] == 2 * evals
    assert (server.graphs.captures, server.graphs.replays) == (1, 3)
    server.serve(prng.key(4), 4)
    assert server.cost_model._per_key       # a replay's time is a steady-state observation


@pytest.mark.parametrize("fused_block", [1, 2])
def test_euler_sampler_graph_equals_jit_false_bitwise(card, fused_block):
    """EulerSampler(jit=True) on the card: one capture per model_fn and
    shape, then replays; tokens and launch counts equal jit=False's bit for
    bit over three keys (the capturing call counts its warm-up run too). A
    second shape captures once more."""
    model = _refine_model(card)
    smp = EulerSampler(path=WarmStartPath(0.5), num_steps=8, fused_block=fused_block)
    eager = EulerSampler(path=WarmStartPath(0.5), num_steps=8, fused_block=fused_block,
                         jit=False)
    x0 = torch.randint(0, 27, (4, 32), device=card, dtype=torch.int32,
                       generator=torch.Generator(device=card).manual_seed(0))
    for seed in (1, 2, 3):
        (got, st), n_got = _grew(lambda: smp.sample(prng.key(seed), model.dfm_apply, x0))
        (want, _), n_want = _grew(lambda: eager.sample(prng.key(seed), model.dfm_apply, x0))
        runs = 2 if seed == 1 else 1        # the capture's warm-up, then the replay
        assert torch.equal(got, want) and n_got == {k: runs * c for k, c in n_want.items()}, \
            seed
        assert st.nfe == smp.backbone_evals
    assert (smp.graphs.captures, smp.graphs.replays) == (1, 3)
    assert len(eager.graphs) == 0
    smp.sample(prng.key(4), model.dfm_apply, x0[:2])
    assert smp.graphs.captures == 2


def test_graph_capture_of_a_synchronising_step_raises(card):
    """A step_fn that reads a value on the host cannot be captured: the
    sampler raises, naming the statement and jit=False; nothing runs the
    loop eagerly in its place. jit=False then runs it."""
    path = WarmStartPath(0.5)

    def step_fn(rng, logits, x_t, t, h):
        if float(h) < 0:            # a host read of a card value: a synchronisation
            raise ValueError("negative step")
        return gumbel_step(rng, logits, x_t, t, h, path)

    model = _refine_model(card)
    x0 = torch.zeros((2, 16), dtype=torch.int32, device=card)
    with pytest.raises(GraphCaptureError, match="(?s)float\\(h\\).*jit=False"):
        EulerSampler(path=path, num_steps=4, step_fn=step_fn).sample(prng.key(0),
                                                                     model.dfm_apply, x0)
    out, _ = EulerSampler(path=path, num_steps=4, step_fn=step_fn, jit=False).sample(
        prng.key(0), model.dfm_apply, x0)
    assert out.shape == (2, 16)


def test_failed_capture_leaves_the_generator_and_the_next_capture_working(card):
    """After a capture that a synchronisation broke, the default CUDA
    generator draws outside a graph (no ``generator=``), and a fresh
    GraphCache captures a good function once and replays it, bitwise equal
    to its eager run."""
    from repro_torch.graphs import GraphCache

    x = torch.arange(8, device=card, dtype=torch.float32)
    with pytest.raises(GraphCaptureError, match="item"):
        GraphCache("a synchronising function")("k", lambda t: t * t.sum().item(), x)
    assert torch.randn(4, device=card).shape == (4,)
    torch.cuda.synchronize()

    def fn(t):
        return torch.sin(t) * 2.0 + torch.cumsum(t, 0)

    good = GraphCache("a good function")
    g = torch.Generator(device=card).manual_seed(0)
    for _ in range(3):
        inp = torch.randn(64, generator=g, device=card)
        assert torch.equal(good("k", fn, inp), fn(inp))
    assert (good.captures, good.replays) == (1, 3)
    assert torch.randn(4, device=card).shape == (4,)


def _rows_case(card, row_t0s, seed, b=8, n=16):
    from repro_torch.core.sampler import refine_schedule_rows
    from repro_torch.serving.scheduler import _derive_row_keys

    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randint(0, 27, (b, n), generator=g, device=card, dtype=torch.int32)
    _, flow_keys = _derive_row_keys(np.full(b, seed), np.arange(b))
    return (flow_keys, x) + tuple(refine_schedule_rows(row_t0s, 1.0 / 20, 20)[:4])


@pytest.mark.parametrize("fused_block", [1, 2])
def test_scheduler_refine_graph_equals_eager_for_mixed_row_t0s(card, fused_block):
    """The scheduler's masked per-row refine is one graph per compile key:
    calls with different row-t0 mixes of one key (10 steps, the active mask
    as data) capture once and replay, each bitwise equal to its eager
    launches, with the launch counts of a replay (a capturing call counts
    its warm-up too)."""
    from repro_torch.serving import WarmStartScheduler

    model = _refine_model(card)
    sched = WarmStartScheduler(flow_model=model, draft_fn=uniform_draft(27, device=card),
                               cold_nfe=20, default_t0=0.8, fused_block=fused_block,
                               device=card)
    mixes = [(0.5,) * 8, (0.5, 0.7, 0.8, 0.9, 0.55, 0.6, 0.9, 0.75),
             (0.9, 0.5, 0.9, 0.9, 0.9, 0.9, 0.9, 0.9)]
    for i, mix in enumerate(mixes):
        case = _rows_case(card, mix, i)
        got, n_got = _grew(lambda: sched._refine_loop((16, 8, 10), *case))
        want, n_want = _grew(lambda: sched._refine_loop_eager(*case))
        runs = 2 if i == 0 else 1
        assert torch.equal(got, want) and n_got == {k: runs * c for k, c in n_want.items()}, i
        assert torch.equal(case[1], _rows_case(card, mix, i)[1])      # drafts untouched
    assert (sched.graphs.captures, sched.graphs.replays) == (1, 3)


def _distilled_case(card, k, row_t0s, seed, n=16):
    """A distilled scheduler on the card (an untrained head, K = ``k``), one
    packed distilled micro-batch of ``row_t0s`` (one row a request) and its
    drafts."""
    from repro_torch.drafting import AdaptiveT0Policy, DistilledRefiner, T0Calibration
    from repro_torch.serving import ServeRequest, WarmStartScheduler, pack_requests

    head = DistilledRefiner(vocab_size=27)
    pol = AdaptiveT0Policy(scorer=lambda t: t.float().mean(-1),
                           calibration=T0Calibration(scores=(0.0, 1.0), t0s=(0.5, 0.9)))
    sched = WarmStartScheduler(flow_model=_refine_model(card),
                               draft_fn=uniform_draft(27, device=card), cold_nfe=20,
                               default_t0=0.8, t0_policy=pol, device=card, distilled_model=head,
                               distilled_params=head.init(1, device=card), distilled_nfe=k,
                               distilled_accept_score=0.0)
    reqs = [ServeRequest(request_id=i, seq_len=n, num_samples=1, seed=seed + i, t0=t0,
                         tier="distilled") for i, t0 in enumerate(row_t0s)]
    (mb,) = pack_requests(reqs, cold_nfe=20, default_t0=0.8, t0_bin_width=0.5,
                          distilled_nfe=k)
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randint(0, 27, (mb.padded_rows, n), generator=g, device=card, dtype=torch.int32)
    return sched, head, mb, x


@pytest.mark.parametrize("k", [1, 2])
def test_distilled_graph_equals_eager_one_capture_a_key(card, k):
    """The distilled tier's K head steps are one graph per distilled compile
    key: two micro-batches of one key (other row t0s, other seeds) capture
    once and replay, each bitwise equal to its eager launches, K ws_step_rows
    launches a replay (the head is plain products: no counted kernel)."""
    sched, _, mb, x = _distilled_case(card, k, (0.5, 0.6, 0.7, 0.9), 3)
    _, mb2, x2 = _distilled_case(card, k, (0.9, 0.8, 0.55, 0.5), 9)[1:]
    assert mb.compile_key == mb2.compile_key == (16, 4, k, "distilled")
    for i, (m, xs) in enumerate(((mb, x), (mb2, x2))):
        n, inputs = sched._distill_inputs(m)
        assert n == k
        got, n_got = _grew(lambda: sched._distill_loop(m.compile_key, xs, inputs))
        want, n_want = _grew(lambda: sched._distill_loop_eager(xs, inputs))
        runs = 2 if i == 0 else 1
        assert n_want == {"ws_step_rows": k}
        assert torch.equal(got, want) and n_got == {"ws_step_rows": runs * k}, i
    assert (sched.graphs.captures, sched.graphs.replays) == (1, 2)


def test_new_head_params_replay_the_same_graph(card):
    """The head's weights are graph inputs: a scheduler given new params
    (``train_distilled`` returns new tensors) replays the captured graph with
    them, bitwise equal to their eager launches and unlike the old output."""
    sched, head, mb, x = _distilled_case(card, 1, (0.5, 0.6, 0.7, 0.9), 3)
    n, inputs = sched._distill_inputs(mb)
    old = sched._distill_loop(mb.compile_key, x, inputs)
    params = head.init(7, device=card)
    params["copy_gate"] = torch.tensor(-3.0, device=card)        # a head that does not copy
    sched.distilled_params = params
    new = sched._distill_loop(mb.compile_key, x, inputs)
    assert torch.equal(new, sched._distill_loop_eager(x, inputs))
    assert not torch.equal(new, old)
    assert (sched.graphs.captures, sched.graphs.replays) == (1, 2)


def test_lstm_generate_graph_equals_eager(card):
    """LSTMModel.generate on the card is one graph replay a call, captured
    once per (num, seq_len, temperature, bos): tokens equal the eager loop's
    bit for bit, and other weights of the same shapes replay the same graph."""
    lstm = LSTMModel(LSTMConfig(vocab_size=27, hidden=64, num_layers=2, embed_dim=32))
    params = lstm.init(0, device=card)
    for seed in (1, 2, 3):
        assert torch.equal(lstm.generate(params, prng.key(seed), 8, 40),
                           lstm._generate_eager(params, prng.key(seed), 8, 40))
    other = lstm.init(5, device=card)
    assert torch.equal(lstm.generate(other, prng.key(4), 8, 40),
                       lstm._generate_eager(other, prng.key(4), 8, 40))
    assert (lstm.graphs.captures, lstm.graphs.replays) == (1, 4)
    assert torch.equal(lstm.generate(params, prng.key(1), 8, 40, 0.7, 3),
                       lstm._generate_eager(params, prng.key(1), 8, 40, 0.7, 3))
    assert lstm.graphs.captures == 2


def test_policy_scheduler_on_card_equals_cpu(card):
    """A tiny policy scheduler (the probe of a tiny DiT, per-row t0,
    speculative) on the card equals the same one on the CPU: tokens, t0s,
    per-row t0s, the accepted set, the t0 histogram, the speculative counts."""
    from repro_torch.drafting import AdaptiveT0Policy, T0Calibration, make_quality_scorer
    from repro_torch.serving import ServeRequest, WarmStartScheduler

    spec = [(16, 3, None), (12, 2, None), (16, 1, 0.5), (7, 4, None), (9, 2, None)]
    out = {}
    for dev in (card, "cpu"):
        model = Model(tiny_config(vocab_size=27).replace(num_layers=2), device="cpu",
                      seed=2).to(dev)
        scorer = make_quality_scorer(model.dfm_apply, device=dev)
        pol = AdaptiveT0Policy(scorer=scorer, calibration=T0Calibration(
            scores=(-3.6, -3.0), t0s=(0.5, 0.9), t0_floor=0.5, t0_ceil=0.9), bin_width=0.1)
        sched = WarmStartScheduler(flow_model=model, draft_fn=uniform_draft(27, device=dev),
                                   cold_nfe=20, default_t0=0.8, max_rows=8, t0_policy=pol,
                                   per_row_t0=True, speculative=True, accept_score=-3.3,
                                   device=dev)
        reqs = [ServeRequest(request_id=i, seq_len=L, num_samples=n, seed=30 + i, t0=t0)
                for i, (L, n, t0) in enumerate(spec)]
        res, rep = sched.serve_requests(reqs)
        out[dev] = ({rid: (r.tokens.tolist(), r.nfe, r.t0, r.row_t0s, r.micro_batch)
                     for rid, r in res.items()},
                    rep["policy"]["t0_histogram"], rep["speculative"]["accepted"],
                    rep["speculative"]["eligible"])
    assert out[card] == out["cpu"]


@pytest.mark.parametrize("b,s,h,kh,d,causal,window", [
    (32, 256, 12, 12, 64, False, None),     # the DiT's training shape
    (4, 200, 8, 2, 64, True, None),         # GQA, causal
    (2, 130, 4, 1, 32, False, 17),          # MQA, a band
])
def test_flash_attention_fn_grads_match_plain_autograd(card, b, s, h, kh, d, causal, window):
    """``FlashAttentionFn`` on the card (one kernel launch forward, the
    matmul gradient backward) against autograd through the plain version on
    the same inputs: each gradient within 1e-4 of its max |g| (the forward
    output agrees to 1e-4 abs; float32 products in another order)."""
    g = torch.Generator(device=card).manual_seed(s + h)
    q, k, v = (torch.randn(shape, generator=g, device=card)
               for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
    w = torch.randn((b, s, h, d), generator=g, device=card)
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    before = launches["flash_attn"]
    out = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    torch.sum(out * w).backward()
    assert launches["flash_attn"] == before + 1      # the backward launches no kernel
    rq, rk, rv = (x.clone().requires_grad_() for x in (q, k, v))
    torch.sum(flash_attention_ref(rq, rk, rv, causal=causal, window=window) * w).backward()
    for got, want in ((tq.grad, rq.grad), (tk.grad, rk.grad), (tv.grad, rv.grad)):
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_flash_attention_fn_grads_at_s_ne_t_match_plain_autograd(card):
    """The gradient through ``FlashAttentionFn`` at whisper-medium's cross
    attention shape, 256 queries against 1500 keys (16 heads of 64,
    bidirectional), against autograd through the plain version: each
    gradient within 1e-4 of its max |g|, as at S = T."""
    b, s, t, h, d = 2, 256, 1500, 16, 64
    g = torch.Generator(device=card).manual_seed(t)
    q, k, v = (torch.randn(shape, generator=g, device=card)
               for shape in ((b, s, h, d), (b, t, h, d), (b, t, h, d)))
    w = torch.randn((b, s, h, d), generator=g, device=card)
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    before = launches["flash_attn"]
    torch.sum(flash_attention(tq, tk, tv, causal=False) * w).backward()
    assert launches["flash_attn"] == before + 1
    rq, rk, rv = (x.clone().requires_grad_() for x in (q, k, v))
    torch.sum(flash_attention_ref(rq, rk, rv, causal=False) * w).backward()
    for got, want in ((tq.grad, rq.grad), (tk.grad, rk.grad), (tv.grad, rv.grad)):
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_flash_attn_launch_refuses_inputs_that_require_grad(card):
    """Only ``FlashAttentionFn`` launches the kernel for inputs that require
    grad: a launch that would cut the graph raises; under no_grad the
    serving path launches as before."""
    from repro_torch.kernels.flash_attn import ops as flash_ops

    g = torch.Generator(device=card).manual_seed(0)
    q = torch.randn((1, 16, 2, 32), generator=g, device=card).requires_grad_()
    with pytest.raises(RuntimeError, match="FlashAttentionFn"):
        flash_ops._launch(q, q, q, torch.empty_like(q), causal=False, window=None, scale=0.1)
    with torch.no_grad():
        out = flash_attention(q, q, q, causal=False)
    assert out.grad_fn is None


def test_backbone_trains_through_the_kernel_on_card(card):
    """One train step of a tiny DiT on the card: every parameter gets a
    gradient that is not all zero (wq, wk, wv of every block included), the
    forward launches flash_attn once a block and the backward none."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.convert import jax_leaves
    from repro_torch.training import Trainer
    from repro_torch.training.train_step import loss_and_grads, make_loss_fn

    model = Model(tiny_config(), device=card, seed=0)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, 27, (4, 64)).astype(np.int32)).to(card)
             for k in ("x_src", "x_tgt")}
    leaves = jax_leaves(model)
    before = launches["flash_attn"]
    _, _, grads = loss_and_grads(make_loss_fn(model, model.cfg, WarmStartPath(0.8)), model,
                                 leaves, batch, prng.key(0))
    assert launches["flash_attn"] - before == model.cfg.num_layers
    for name, gs in grads.items():
        assert all(bool(x.abs().sum() > 0) for x in gs), name
    trainer = Trainer(model, model.cfg, RunConfig(batch_size=4, log_every=1))
    state = trainer.fit(trainer.init_state(), iter([(batch["x_src"].cpu().numpy(),
                                                     batch["x_tgt"].cpu().numpy())] * 3),
                        steps=3)
    assert int(state.step) == 3 and len(trainer.step_ms()) == 3
    assert all(bool(torch.isfinite(x)) for x in trainer.step_losses + trainer.step_grad_norms)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-1.3b"])
def test_recurrent_decode_graph_equals_eager_and_a_fresh_engine(card, arch):
    """The recurrent smoke configs' draft on the card (the plain path,
    prompt prefilled by scan): the decode graph's tokens equal the eager
    loop's bitwise, over a computed prefix, the prefix reused, another
    prompt recomputed into the same buffers and the first recomputed back;
    each call equals a fresh engine's (the reused state is the post-prefill
    state: reference fault R7 not carried over); one capture."""
    from repro_torch.configs import get_smoke_config

    adapter = TransformerDraftAdapter(model=Model(get_smoke_config(arch), device=card, seed=1))
    eng = ARDraftEngine(adapter, max_len=16)
    assert eng.prefill_mode == "scan" and not adapter.exact_batched_prefill
    prompt = torch.tensor([[1, 2, 3]] * 2, dtype=torch.int32)
    other = torch.tensor([[4, 5, 6], [7, 8, 9]], dtype=torch.int32)
    for seed, p in ((3, prompt), (4, prompt), (5, other), (6, prompt), (7, prompt)):
        keys = prng.split(prng.key(seed), 2)
        got = eng.generate_rows(keys, 12, prompt=p)
        assert torch.equal(got, eng._generate_rows_eager(keys, 12, prompt=p)), seed
        fresh = ARDraftEngine(adapter, max_len=16)._generate_rows_eager(keys, 12, prompt=p)
        assert torch.equal(got, fresh), seed
    assert eng.graphs.captures == 1
    assert eng.stats.prefill_reuses >= 3



def test_encdec_serve_graph_reads_the_frames_in_place(card):
    """whisper-medium's smoke config served through ``Conditioned`` on the
    card: one capture of the refine, whose replay equals the eager loop
    bitwise (per NFE 3 x 2 flash_attn launches: encoder, self, cross); the
    frames changed in place are what the next replay reads (== the eager
    loop on the new frames, != the old tokens, the cross attention's output
    projection scaled up so the frames move them); and the card's tokens equal
    the CPU's, the ar_generate draft included (R8: seq_len 17 for 16)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Conditioned, EncDecModel
    from repro_torch.serving import ar_generate

    cfg = get_smoke_config("whisper-medium")
    g = torch.Generator().manual_seed(0)
    frames = torch.randn((4, cfg.num_audio_frames, cfg.d_model), generator=g)
    path = WarmStartPath(t0=0.75)
    out = {}
    for dev in ("cuda", "cpu"):
        model = EncDecModel(cfg, device="cpu", seed=3).to(dev)
        fr = frames.to(dev)
        server = WarmStartServer(
            flow_model=Conditioned(model, {"frames": fr}), flow_cfg=cfg, path=path,
            cold_nfe=16, step_fn=make_ws_step_fn(path, device=dev), device=dev,
            draft_generate=lambda rng, num, model=model, fr=fr: ar_generate(
                model, cfg, rng, batch_size=num, seq_len=17, extras={"frames": fr}))
        out[dev] = server.serve(prng.key(1), 4)[0].cpu()
    assert out["cuda"].shape == (4, 16) and torch.equal(out["cuda"], out["cpu"])
    model = EncDecModel(cfg, device="cpu", seed=3).to(card)
    with torch.no_grad():   # wo starts at 0.02 / sqrt(2 L): scaled, the frames move tokens
        for block in model.dec_blocks:
            block.cross.wo.w.mul_(100.0)
    fr = frames.to(card)
    server = WarmStartServer(flow_model=Conditioned(model, {"frames": fr}), flow_cfg=cfg,
                             path=path, cold_nfe=16, step_fn=make_ws_step_fn(path),
                             device=card, draft_generate=None)
    x0 = torch.randint(0, cfg.vocab_size, (4, 32), generator=g, dtype=torch.int32).to(card)
    keys, ts, hs = refine_loop_inputs(prng.key(5), 0.75, 1 / 16, 4)
    with torch.inference_mode():
        first = server._refine_loop(keys, x0, ts, hs)
        got, n_got = _grew(lambda: server._refine_loop(keys, x0, ts, hs))
        want, n_want = _grew(lambda: server._refine_loop_eager(keys, x0, ts, hs))
        assert torch.equal(got, want) and torch.equal(got, first) and n_got == n_want
        assert n_got == {"flash_attn": 4 * (cfg.num_encoder_layers + 2 * cfg.num_layers),
                         "ws_step": 4}
    fr.copy_(torch.flip(fr, dims=[0]))
    with torch.inference_mode():
        moved = server._refine_loop(keys, x0, ts, hs)
        assert torch.equal(moved, server._refine_loop_eager(keys, x0, ts, hs))
    assert not torch.equal(moved, first)
    assert server.graphs.captures == 1
