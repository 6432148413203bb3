"""The port's ws_step_gumbel (plain path on the CPU) against the JAX
package's ``ws_step_pallas`` in interpret mode, its ``impl="reference"``
step, and the default Euler step of ``make_euler_one_step``.

Tokens must be equal except in rows whose best two probability-space scores
lie within 1e-5 (``near_tie_rows_probs``): the test counts those rows and
requires every mismatch to be one of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.paths import WarmStartPath as JaxPath
from repro.core.sampler import make_euler_one_step as jax_make_euler_one_step
from repro.kernels.ws_step import ops as jax_ops
from repro.kernels.ws_step.kernel import ws_step_pallas
from repro_torch import prng
from repro_torch.core.paths import WarmStartPath
from repro_torch.core.sampler import gumbel_step, make_euler_one_step
from repro_torch.kernels.ws_step import (
    keyed_gumbel, keyed_uniform, make_ws_step_fn, near_tie_rows_probs, seed_from_key, ws_step, ws_step_gumbel,
    ws_step_gumbel_keyed, ws_step_gumbel_ref,
)

TIE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread for these smoke-size models: the suite runs in
    several worker processes at once, where torch's default of a thread a
    core makes each small op wait on the others' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_equal_up_to_ties(want, got, tie_rows):
    want, got = np.asarray(want).reshape(-1), np.asarray(got).reshape(-1)
    mismatch = want != got
    assert not np.any(mismatch & ~tie_rows), (
        f"{int(mismatch.sum())} mismatches, {int((mismatch & ~tie_rows).sum())} "
        f"outside the {int(tie_rows.sum())} near-tie rows")
    return int(mismatch.sum())


def _padded_case(r, v, pad_value, seed):
    """JAX's test layout (tests/test_kernels.py): rows padded to 8, columns
    to 128 lanes; the padded columns hold ``pad_value``."""
    rng = np.random.default_rng(seed)
    vp = -(-v // 128) * 128
    rp = -(-r // 8) * 8
    logits = np.full((rp, vp), pad_value, np.float32)
    logits[:, :v] = 3 * rng.standard_normal((rp, v))
    x = rng.integers(0, v, (rp, 1)).astype(np.int32)
    a = rng.uniform(size=(rp, 1)).astype(np.float32)
    a[0] = 0.0                              # a = 0 keeps the token
    a[-1] = 1.0                             # a = 1: a draw from p1 alone
    gumbel = rng.gumbel(size=(rp, vp)).astype(np.float32)
    return logits, x, a, gumbel


@pytest.mark.parametrize("pad_value", [0.0, 50.0])
@pytest.mark.parametrize("r,v,temperature", [(8, 128, 1.0), (16, 300, 1.0), (8, 27, 0.7),
                                             (3, 517, 1.0)])
def test_ws_step_gumbel_matches_jax_kernel(r, v, temperature, pad_value):
    """Padding of 50 would win every row if the columns >= valid_v counted."""
    logits, x, a, gumbel = _padded_case(r, v, pad_value, r * 1000 + v)
    want = ws_step_pallas(jnp.asarray(logits), jnp.asarray(x), jnp.asarray(a),
                          jnp.asarray(gumbel), valid_v=v, row_block=8,
                          temperature=temperature, interpret=True)
    args = [torch.from_numpy(z) for z in (logits, x, a, gumbel)]
    got = ws_step_gumbel(*args, valid_v=v, row_block=8, temperature=temperature)
    assert got.shape == (logits.shape[0], 1) and got.dtype == torch.int32
    assert int(got.max()) < v
    ties = near_tie_rows_probs(*args, valid_v=v, temperature=temperature, tol=TIE_TOL).numpy()
    _assert_equal_up_to_ties(want, got.numpy(), ties)
    assert int(got[0, 0]) == int(x[0, 0])
    torch.testing.assert_close(ws_step_gumbel_ref(*args, valid_v=v, temperature=temperature),
                               got, rtol=0, atol=0)


def test_near_tie_helper_flags_a_constructed_tie():
    """Two columns with equal scores are flagged; a clear winner is not."""
    logits = torch.zeros((2, 4))
    x = torch.zeros((2, 1), dtype=torch.int32)
    a = torch.ones((2, 1))
    g = torch.tensor([[0.0, 1.0, 1.0, -2.0], [0.0, 3.0, 1.0, -2.0]])
    ties = near_tie_rows_probs(logits, x, a, g, valid_v=4)
    assert ties.tolist() == [True, False]
    assert ws_step_gumbel(logits, x, a, g, valid_v=4, row_block=1)[:, 0].tolist() == [1, 1]


def test_ws_step_gumbel_checks_its_inputs():
    logits, x, a, g = (torch.from_numpy(z) for z in _padded_case(8, 27, 0.0, 0))
    with pytest.raises(ValueError, match="multiple of row_block"):
        ws_step_gumbel(logits[:6], x[:6], a[:6], g[:6], valid_v=27, row_block=4)
    with pytest.raises(AssertionError):          # the TPU kernel's own check
        ws_step_pallas(jnp.asarray(logits[:6].numpy()), jnp.asarray(x[:6].numpy()),
                       jnp.asarray(a[:6].numpy()), jnp.asarray(g[:6].numpy()), valid_v=27,
                       row_block=4, interpret=True)
    with pytest.raises(ValueError, match=r"\(R, 1\)"):
        ws_step_gumbel(logits, x[:, 0], a, g, valid_v=27)
    with pytest.raises(ValueError, match="gumbel"):
        ws_step_gumbel(logits, x, a, g[:, :27], valid_v=27)
    with pytest.raises(ValueError, match="valid_v"):
        ws_step_gumbel(logits, x, a, g, valid_v=129)
    # the row count needs no block on the card: any R with row_block = 1
    assert ws_step_gumbel(logits[:5], x[:5], a[:5], g[:5], valid_v=27, row_block=1).shape == (5, 1)


def _step_inputs(seed, b, n, v):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal((b, n, v))).astype(np.float32)
    x = rng.integers(0, v, (b, n)).astype(np.int32)
    return logits, x


def _probs_ties(logits, x, t, h, path, g, temperature):
    """The near-tie rows of the default step's score on the given noise."""
    b, n, v = logits.shape
    a = torch.clamp(torch.as_tensor(h, dtype=torch.float32) * path.velocity_scale(t), 0.0, 1.0)
    a = a.reshape(-1, 1).expand(b, n).reshape(-1, 1)
    return near_tie_rows_probs(logits.reshape(-1, v), x.reshape(-1, 1), a, g.reshape(-1, v),
                               valid_v=v, temperature=temperature, tol=TIE_TOL).numpy()


@pytest.mark.parametrize("v,temperature,t0,h", [
    (27, 1.0, 0.8, 1 / 16), (27, 0.7, 0.5, 0.0), (300, 1.0, 0.9375, 0.0625),
    (2048, 0.7, 0.8, 1 / 16),
])
def test_ws_step_reference_impl_matches_jax(v, temperature, t0, h):
    """``impl="reference"``: jax.random.gumbel(rng, (R, V)) noise and the
    probability-space score, on (B, N, V) logits with one t per batch row."""
    b, n = 3, 8
    logits, x = _step_inputs(v + 7, b, n, v)
    t = np.linspace(t0, min(t0 + 0.1, 0.99), b).astype(np.float32)
    want = jax_ops.ws_step(jax.random.key(v), jnp.asarray(logits), jnp.asarray(x),
                           jnp.asarray(t), jnp.float32(h), JaxPath(t0=t0),
                           temperature=temperature, impl="reference")
    path = WarmStartPath(t0=t0)
    lg, xt, tt = torch.from_numpy(logits), torch.from_numpy(x), torch.from_numpy(t)
    step = make_ws_step_fn(path, temperature=temperature, device="cpu", impl="reference")
    got = step(prng.key(v), lg, xt, tt, torch.tensor(h))
    assert got.shape == (b, n) and got.dtype == torch.int32
    g = prng.gumbel(prng.key(v), (b * n, v))
    ties = _probs_ties(lg, xt, tt, h, path, g, temperature)
    _assert_equal_up_to_ties(want, got.numpy(), ties)
    if h == 0.0:
        np.testing.assert_array_equal(got.numpy(), x)
    with pytest.raises(ValueError, match="unknown ws_step impl"):
        ws_step(prng.key(0), lg, xt, tt, h, path, impl="pallas")


@pytest.mark.parametrize("v,temperature,t0,h", [
    (27, 1.0, 0.8, 1 / 16), (27, 0.7, 0.95, 0.05), (300, 1.0, 0.5, 1 / 64), (27, 1.0, 0.5, 0.0),
])
def test_default_euler_step_matches_jax(v, temperature, t0, h):
    """``make_euler_one_step(step_fn=None)``: the CPU path (euler_step_probs +
    categorical_from_probs) and the card path's host side (``gumbel_step``,
    whose ws_step_gumbel takes its plain version for CPU tensors) against
    JAX's default step on the same key."""
    b, n = 4, 16
    logits, x = _step_inputs(3 * v + int(100 * t0), b, n, v)
    t = np.full((b,), t0, np.float32)
    key_seed = 11 + v
    jax_step = jax_make_euler_one_step(JaxPath(t0=t0), temperature=temperature)
    want = np.asarray(jax_step(jax.random.key(key_seed), jnp.asarray(logits), jnp.asarray(x),
                               jnp.asarray(t), jnp.float32(h)))
    path = WarmStartPath(t0=t0)
    lg, xt, tt = torch.from_numpy(logits), torch.from_numpy(x), torch.from_numpy(t)
    key, hh = prng.key(key_seed), torch.tensor(h)
    cpu = make_euler_one_step(path, temperature=temperature)(key, lg, xt, tt, hh)
    card_path = gumbel_step(key, lg, xt, tt, hh, path, temperature=temperature)
    assert cpu.dtype == card_path.dtype == torch.int32
    assert cpu.shape == card_path.shape == (b, n)
    g = prng.gumbel(key, (b, n, v))
    ties = _probs_ties(lg, xt, tt, h, path, g, temperature)
    _assert_equal_up_to_ties(want, cpu.numpy(), ties)
    _assert_equal_up_to_ties(want, card_path.numpy(), ties)


# -- the keyed noise and the grouped three passes of ws_step_gumbel_kernel ----------------

@pytest.mark.parametrize("r,vp", [(8, 27), (16, 300), (8, 128), (3, 517)])
def test_keyed_noise_formula_equals_jax_gumbel(r, vp):
    """The keyed kernel's element formula (bits of threefry(key, (0, row * vp +
    v)), the 23-bit uniform, the FMA with tiny) gives jax.random.gumbel's
    uniform for (R, Vp) bit for bit, and its noise -log(-log u) equals
    prng.gumbel's bit for bit and JAX's within one ulp of max(|g|, 1): the
    two log implementations may round the last bit apart (as in
    test_torch_prng.py). (8, 128) and (3, 517) are padded widths, whose noise
    is drawn over all Vp columns as JAX draws it."""
    seed = 7 * r + vp
    tiny = np.finfo(np.float32).tiny
    want_u = np.asarray(jax.random.uniform(jax.random.key(seed), (r, vp), minval=tiny,
                                           maxval=1.0))
    words = seed_from_key(prng.key(seed))
    got_u = keyed_uniform(words, r, vp)
    np.testing.assert_array_equal(got_u.numpy().view(np.uint32), want_u.view(np.uint32))
    got = keyed_gumbel(words, r, vp)
    assert got.dtype == torch.float32 and got.shape == (r, vp)
    assert torch.equal(got, prng.gumbel(prng.key(seed), (r, vp)))
    want = np.asarray(jax.random.gumbel(jax.random.key(seed), (r, vp)))
    assert np.all(np.abs(got.numpy() - want) <= np.spacing(np.maximum(np.abs(want), 1.0)))


def _grouped_gumbel_draw(logits, x, a, g, valid_v, temperature, group):
    """float32 replica of gumbel_draw<G>: lane j of a row's group takes columns
    j, j + G, ... < valid_v; the max, the sum (in the lane's column order) and
    the score's first argmax each end in a xor butterfly inside the group."""
    rows = logits.shape[0]
    lanes = torch.arange(group)
    lg = logits[:, :valid_v] / temperature
    m = torch.full((rows, group), -1e30)
    for v in range(valid_v):
        m[:, v % group] = torch.maximum(m[:, v % group], lg[:, v])
    off = group // 2
    while off:
        m = torch.maximum(m, m[:, lanes ^ off])
        off //= 2
    s = torch.zeros(rows, group)
    for v in range(valid_v):
        s[:, v % group] = s[:, v % group] + torch.exp(lg[:, v] - m[:, v % group])
    off = group // 2
    while off:
        s = s + s[:, lanes ^ off]
        off //= 2
    assert torch.equal(m, m[:, :1].expand_as(m)) and torch.equal(s, s[:, :1].expand_as(s))
    aa = a.reshape(-1)
    keep = 1.0 - aa
    best = torch.full((rows, group), -float("inf"))
    bidx = torch.full((rows, group), valid_v, dtype=torch.int64)
    for v in range(valid_v):
        p1 = torch.exp(lg[:, v] - m[:, 0]) / s[:, 0]
        probs = keep * (x.reshape(-1) == v).float() + aa * p1
        score = torch.log(torch.clamp_min(probs, 1e-30)) + g[:, v]
        j = v % group
        take = score > best[:, j]
        best[:, j] = torch.where(take, score, best[:, j])
        bidx[:, j] = torch.where(take, v, bidx[:, j])
    off = group // 2
    while off:
        b_o, i_o = best[:, lanes ^ off], bidx[:, lanes ^ off]
        take = (b_o > best) | ((b_o == best) & (i_o < bidx))
        best, bidx = torch.where(take, b_o, best), torch.where(take, i_o, bidx)
        off //= 2
    assert torch.equal(bidx, bidx[:, :1].expand_as(bidx))
    return bidx[:, 0].to(torch.int32)


@pytest.mark.parametrize("group", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("r,v,valid_v,temperature", [(64, 27, 27, 1.0), (16, 128, 27, 0.7),
                                                     (8, 300, 300, 1.0), (32, 5, 3, 1.0)])
def test_grouped_three_passes_give_the_plain_tokens_off_near_ties(group, r, v, valid_v,
                                                                  temperature):
    """The G-lane reduction of ws_step_gumbel_kernel picks the plain version's
    token except on counted near-tie rows (its softmax sum adds in G's order);
    a = 0 keeps the token, and no padded column wins."""
    logits, x, a, _ = _padded_case(r, valid_v, 50.0, 31 * group + v)
    logits = np.concatenate([logits[:r, :valid_v],
                             np.full((r, v - valid_v), 50.0, np.float32)], axis=1)
    x, a = x[:r], a[:r]
    lt, xt, at = torch.from_numpy(logits), torch.from_numpy(x), torch.from_numpy(a)
    g = keyed_gumbel((3, group), r, v)
    got = _grouped_gumbel_draw(lt, xt, at, g, valid_v, temperature, group)
    want = ws_step_gumbel_ref(lt, xt, at, g, valid_v=valid_v, temperature=temperature)[:, 0]
    ties = near_tie_rows_probs(lt, xt, at, g, valid_v=valid_v, temperature=temperature,
                               tol=TIE_TOL).numpy()
    _assert_equal_up_to_ties(want.numpy(), got.numpy(), ties)
    assert int(got[0]) == int(x[0, 0]) and int(got.max()) < valid_v


@pytest.mark.parametrize("a_shape", ["scalar", "batch", "row"])
def test_keyed_wrapper_equals_the_given_noise_step(a_shape):
    """ws_step_gumbel_keyed on the CPU: the given-noise step on
    prng.gumbel(rng, (R, Vp)), with one weight, one per batch row of N
    positions, or one per row; the tokens bit for bit."""
    b, n, v, valid_v = 3, 8, 40, 27
    logits, x = _step_inputs(5, b, n, v)
    lt = torch.from_numpy(logits).reshape(b * n, v)
    xt = torch.from_numpy(x).reshape(-1)
    rng = np.random.default_rng(1)
    a = {"scalar": torch.tensor(0.3), "batch": torch.from_numpy(rng.uniform(size=b)).float(),
         "row": torch.from_numpy(rng.uniform(size=b * n)).float()}[a_shape]
    key = prng.key(21)
    got = ws_step_gumbel_keyed(key, lt, xt, a, valid_v=valid_v, temperature=0.7)
    aa = a.reshape(-1).repeat_interleave(b * n // a.numel()).reshape(-1, 1)
    want = ws_step_gumbel(lt, xt[:, None], aa, prng.gumbel(key, (b * n, v)), valid_v=valid_v,
                          row_block=1, temperature=0.7)[:, 0]
    assert got.shape == (b * n,) and got.dtype == torch.int32
    assert torch.equal(got, want)


def test_keyed_wrapper_checks_its_inputs_and_refuses_2_32_elements():
    lt, xt = torch.zeros(6, 27), torch.zeros(6, dtype=torch.int32)
    key = prng.key(0)
    with pytest.raises(ValueError, match=r"\(R,\)"):
        ws_step_gumbel_keyed(key, lt, xt[:, None], torch.zeros(6))
    with pytest.raises(ValueError, match="weight"):
        ws_step_gumbel_keyed(key, lt, xt, torch.zeros(4))
    with pytest.raises(ValueError, match="valid_v"):
        ws_step_gumbel_keyed(key, lt, xt, torch.zeros(6), valid_v=28)
    # 2**32 elements: refused before anything is read, as jax.random refuses it
    big = torch.zeros(1, 1).expand(1 << 16, 1 << 16)
    with pytest.raises(NotImplementedError, match="2\\*\\*32"):
        ws_step_gumbel_keyed(key, big, torch.zeros(1, dtype=torch.int32).expand(1 << 16),
                             torch.zeros(1))
    with pytest.raises(NotImplementedError, match="2\\*\\*32"):
        keyed_gumbel((0, 0), 1 << 16, 1 << 16)


def test_keyed_step_device_key_words_equal_seed_from_key():
    """The default step inside a refine graph indexes the card's (n, 2) step
    keys: each row's words, read in place, are ``seed_from_key``'s, so the
    keyed kernel hashes the same noise as from the host's integers."""
    from repro_torch.kernels.ws_step import key_words, seed_from_key

    keys = prng.split(prng.key(21), 13)
    for i in range(keys.shape[0]):
        words = key_words(keys[i])
        assert words.data_ptr() == keys[i].data_ptr()
        assert tuple(words.tolist()) == seed_from_key(keys[i])
