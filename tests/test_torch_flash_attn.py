"""The port's flash attention (plain path on the CPU) against the JAX
package's Pallas kernel in interpret mode and its einsum ``_sdpa``, at
atol = rtol = 1e-5 (float32, different summation order)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import flash_attention as jax_flash_attention
from repro.models.attention import _sdpa, attn_mask
from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref
from repro_torch.kernels.flash_attn.ref import attention_mask

TOL = dict(atol=1e-5, rtol=1e-5)

CASES = [
    # b, s, h, kh, d, causal, window
    (2, 48, 4, 4, 32, False, None),     # bidirectional (the DiT's)
    (2, 40, 4, 4, 32, True, None),      # causal
    (1, 64, 2, 2, 16, True, 9),         # causal sliding window
    (1, 50, 2, 2, 16, False, 7),        # bidirectional band
    (2, 32, 6, 2, 16, False, None),     # GQA 3:1
    (1, 24, 4, 1, 8, True, None),       # MQA, causal
]


def _qkv(seed, b, s, h, kh, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("b,s,h,kh,d,causal,window", CASES)
def test_flash_attention_matches_jax(b, s, h, kh, d, causal, window):
    q, k, v = _qkv(s + h, b, s, h, kh, d)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                          window=window).numpy()
    want_kernel = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=causal, window=window, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want_kernel), **TOL)
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
    mask = attn_mask(pos, pos, mode="causal" if causal else "bidir", window=window)
    want_sdpa = _sdpa(jnp.asarray(q).reshape(b, s, kh, h // kh, d), jnp.asarray(k),
                      jnp.asarray(v), mask, scale=1.0 / math.sqrt(d)).reshape(b, s, h, d)
    np.testing.assert_allclose(got, np.asarray(want_sdpa), **TOL)


@pytest.mark.parametrize("causal,window", [(False, None), (True, None), (True, 5), (False, 3)])
def test_attention_mask_matches_jax_attn_mask(causal, window):
    s = 20
    pos = jnp.arange(s, dtype=jnp.int32)[None]
    want = attn_mask(pos, pos, mode="causal" if causal else "bidir", window=window)[0]
    got = attention_mask(s, s, causal=causal, window=window)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_flash_attention_wrapper_checks():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 8, 4, 8), torch.zeros(1, 8, 4, 8))
    with pytest.raises(ValueError):
        flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
    # the default scale is 1/sqrt(D), as the JAX wrapper's
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 8, 4, 4, 16))
    torch.testing.assert_close(flash_attention(q, k, v, causal=False),
                               flash_attention_ref(q, k, v, causal=False, scale=0.25))
