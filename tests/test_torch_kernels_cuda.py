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
from repro_torch.core.paths import WarmStartPath
from repro_torch.kernels import launches
from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref
from repro_torch.kernels.ws_step import (
    near_tie_rows, seed_from_key, ws_step, ws_step_ref_streamed,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("r,v,temperature", [(8192, 27, 1.0), (64, 50257, 0.7), (5, 262144, 1.0)])
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


@pytest.mark.parametrize("b,s,h,kh,d,causal,window", [
    (4, 256, 12, 12, 64, False, None), (2, 200, 8, 2, 64, True, None),
    (2, 300, 4, 4, 32, False, 37), (1, 130, 4, 4, 128, True, 50), (3, 1, 2, 1, 32, False, None),
])
def test_flash_attention_kernel_matches_plain(card, b, s, h, kh, d, causal, window):
    g = torch.Generator(device=card).manual_seed(s)
    q = torch.randn((b, s, h, d), generator=g, device=card)
    k = torch.randn((b, s, kh, d), generator=g, device=card)
    v = torch.randn((b, s, kh, d), generator=g, device=card)
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
