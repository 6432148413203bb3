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


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread for these smoke-size models: the suite runs in
    several worker processes at once, where torch's default of a thread a
    core makes each small op wait on the others' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


# -- why the CUDA kernel splits each product into three TF32 products -------------------

def _tf32(x):
    """``cvt.rna.tf32.f32`` in numpy: add half of the 13 dropped bits, then drop them."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tensor_core_operand(x):
    """What the tensor core reads of a float32 register holding a TF32 operand: the
    top 19 bits (the kernel passes the low part of its split unrounded)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _tc_matmul(a, b, split):
    """a @ b as the kernel's mma.sync TF32 products with float32 accumulation: one
    product of the rounded operands, or 3xTF32 (a_lo b_hi + a_hi b_lo + a_hi b_hi)."""
    ah, bh = _tf32(a), _tf32(b)
    if not split:
        return ah @ bh
    al, bl = _tensor_core_operand(a - ah), _tensor_core_operand(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _kernel_attention(q, k, v, split, block=32):
    """Bidirectional attention in the kernel's order: 32-key tiles, online softmax in
    float32, unnormalised P fed to the P.V product, one division at the end."""
    scale = np.float32(1.0 / math.sqrt(q.shape[-1]))
    qh, kh, vh = (np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v))
    b, h, s, d = qh.shape
    m = np.full((b, h, s, 1), -2.3819763e38, np.float32)
    l = np.zeros((b, h, s, 1), np.float32)
    acc = np.zeros((b, h, s, d), np.float32)
    for k0 in range(0, kh.shape[2], block):
        kt, vt = kh[:, :, k0:k0 + block], vh[:, :, k0:k0 + block]
        sc = _tc_matmul(qh, kt.transpose(0, 1, 3, 2), split) * scale
        m_new = np.maximum(m, sc.max(-1, keepdims=True))
        alpha = np.exp(m - m_new)
        p = np.exp(sc - m_new)
        l = l * alpha + p.sum(-1, keepdims=True)
        acc = acc * alpha + _tc_matmul(p, vt, split)
        m = m_new
    return (acc / np.maximum(l, np.float32(1e-30))).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("split", [True, False], ids=["3xTF32", "1xTF32"])
def test_tf32_split_decides_the_kernels_accuracy(split):
    """At the DiT's attention shape, 3xTF32 products stay within 1e-5 of the plain
    float32 version (the kernel's contract is 1e-4); single TF32 products miss 1e-4."""
    rng = np.random.default_rng(16)
    q, k, v = (rng.standard_normal((2, 256, 12, 64)).astype(np.float32) for _ in range(3))
    got = _kernel_attention(q, k, v, split)
    want = flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=False).numpy()
    err = float(np.abs(got - want).max())
    if split:
        assert err <= 1e-5, err
    else:
        assert err > 1e-4, err
