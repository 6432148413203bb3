"""The port's ws_step (plain path on the CPU) against the JAX package's:
the Pallas kernel in interpret mode with the threefry noise, and both
oracles on shared noise.

Tokens must be equal except in rows whose two competing scores lie within
1e-5 (``near_tie_rows``); the test counts those rows and requires every
mismatch to be one of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.paths import WarmStartPath as JaxPath
from repro.kernels.ws_step import ops as jax_ops
from repro.kernels.ws_step.kernel import threefry_gumbel as jax_threefry_gumbel
from repro.kernels.ws_step.ref import (
    ws_step_ref as jax_ws_step_ref,
    ws_step_ref_streamed as jax_ws_step_ref_streamed,
)
from repro_torch import prng
from repro_torch.core.paths import WarmStartPath
from repro_torch.kernels.ws_step import (
    make_ws_step_fn, near_tie_rows, seed_from_key, ws_step, ws_step_ref,
    ws_step_ref_streamed,
)

TIE_TOL = 1e-5


def _inputs(seed, b, n, v, scale=3.0):
    rng = np.random.default_rng(seed)
    logits = (scale * rng.standard_normal((b, n, v))).astype(np.float32)
    x = rng.integers(0, v, (b, n)).astype(np.int32)
    return logits, x


def _assert_equal_up_to_ties(want, got, tie_rows):
    want, got = np.asarray(want).reshape(-1), np.asarray(got).reshape(-1)
    mismatch = want != got
    assert not np.any(mismatch & ~tie_rows), (
        f"{int(mismatch.sum())} mismatches, {int((mismatch & ~tie_rows).sum())} "
        f"outside the {int(tie_rows.sum())} near-tie rows")
    return int(mismatch.sum())


@pytest.mark.parametrize("v,temperature,t,h", [
    (27, 1.0, 0.8, 1 / 16), (27, 0.7, 0.5, 0.0), (27, 1.0, 0.9375, 0.0625),
    (300, 0.7, 0.8, 1 / 16), (300, 1.0, 0.95, 0.05),
    (2048, 1.0, 0.8, 1 / 16), (2048, 0.7, 0.9375, 0.0625), (2048, 1.0, 0.5, 0.0),
])
def test_ws_step_matches_jax_kernel(v, temperature, t, h):
    """(0.5, 0.0): a = 0 keeps every token; (0.9375, 1/16): the final step,
    where h * velocity_scale(t) clips to a = 1."""
    b, n = 3, 8
    logits, x = _inputs(v + int(1000 * t), b, n, v)
    key_seed = 5 + v
    want = jax_ops.ws_step(jax.random.key(key_seed), jnp.asarray(logits), jnp.asarray(x),
                           jnp.full((b,), t, jnp.float32), jnp.float32(h), JaxPath(t0=0.8),
                           temperature=temperature, hw_prng=False, interpret=True)
    tb = torch.full((b,), t, dtype=torch.float32)
    got = ws_step(prng.key(key_seed), torch.from_numpy(logits), torch.from_numpy(x), tb,
                  torch.tensor(h, dtype=torch.float32), WarmStartPath(t0=0.8),
                  temperature=temperature)
    assert got.dtype == torch.int32 and got.shape == x.shape
    if h == 0.0:
        np.testing.assert_array_equal(got.numpy(), x)
    # the port's noise and mixing weight, to name the near-tie rows
    a = torch.clamp(torch.tensor(h, dtype=torch.float32)
                    * WarmStartPath(t0=0.8).velocity_scale(torch.tensor(t)), 0.0, 1.0)
    seed = seed_from_key(prng.key(key_seed))
    g = prng.threefry_gumbel(seed, b * n, v)
    ties = near_tie_rows(torch.from_numpy(logits.reshape(-1, v)), torch.from_numpy(x.reshape(-1)),
                         a.expand(b * n), g, temperature=temperature,
                         tol=TIE_TOL).numpy()
    _assert_equal_up_to_ties(want, got.numpy(), ties)


@pytest.mark.parametrize("v", [27, 300, 2048])
def test_plain_versions_match_jax_oracles_on_shared_noise(v):
    r = 64
    logits, x = _inputs(v, 1, r, v)
    logits, x = logits[0], x[0]
    rng = np.random.default_rng(v + 1)
    a = rng.uniform(0, 1, r).astype(np.float32)
    a[:8] = 0.0
    a[8:16] = 1.0
    g = np.array(jax_threefry_gumbel(jnp.asarray([3, 4], jnp.int32), r, v))
    lt, xt, at, gt = (torch.from_numpy(z) for z in (logits, x, a, g))
    ties = near_tie_rows(lt, xt, at, gt, tol=TIE_TOL).numpy()
    for jax_fn, port_fn in ((jax_ws_step_ref, ws_step_ref),
                            (jax_ws_step_ref_streamed, ws_step_ref_streamed)):
        for temperature in (1.0, 0.5):
            want = jax_fn(jnp.asarray(logits), jnp.asarray(x), jnp.asarray(a), jnp.asarray(g),
                          temperature=temperature)
            got = port_fn(lt, xt, at, gt, temperature=temperature)
            tt = near_tie_rows(lt, xt, at, gt, temperature=temperature, tol=TIE_TOL).numpy()
            _assert_equal_up_to_ties(want, got.numpy(), tt)
    # a = 0 rows keep their token in both oracles
    np.testing.assert_array_equal(ws_step_ref_streamed(lt, xt, at, gt).numpy()[:8], x[:8])
    np.testing.assert_array_equal(ws_step_ref(lt, xt, at, gt).numpy()[:8], x[:8])
    # the two plain versions agree off the near ties
    _assert_equal_up_to_ties(ws_step_ref(lt, xt, at, gt).numpy(),
                             ws_step_ref_streamed(lt, xt, at, gt).numpy(), ties)


def test_near_tie_rows_counted_and_rare():
    v, r = 300, 512
    logits, x = _inputs(11, 1, r, v)
    g = prng.threefry_gumbel((9, 10), r, v)
    a = torch.full((r,), 0.3)
    ties = near_tie_rows(torch.from_numpy(logits[0]), torch.from_numpy(x[0]), a, g, tol=TIE_TOL)
    assert ties.dtype == torch.bool and ties.shape == (r,)
    assert int(ties.sum()) <= 2
    # an exact tie between the two best candidates is flagged
    lg = torch.zeros(1, 4)
    gg = torch.tensor([[0.5, 0.5, 0.1, 0.2]])
    assert bool(near_tie_rows(lg, torch.tensor([3]), torch.tensor([0.5]), gg)[0])


@pytest.mark.parametrize("seed", [0, 77])
def test_seed_from_key_matches_jax(seed):
    keys_j = jax.random.split(jax.random.key(seed), 3)
    keys_t = prng.split(prng.key(seed), 3)
    for i in range(3):
        want = np.asarray(jax_ops.seed_from_key(keys_j[i])).view(np.uint32).tolist()
        assert list(seed_from_key(keys_t[i])) == want


def test_make_ws_step_fn_cpu_and_device_checks():
    fn = make_ws_step_fn(WarmStartPath(t0=0.5), device="cpu")
    logits, x = _inputs(0, 2, 4, 27)
    out = fn(prng.key(0), torch.from_numpy(logits), torch.from_numpy(x),
             torch.full((2,), 0.5), torch.tensor(0.1))
    assert out.shape == (2, 4) and out.dtype == torch.int32
    assert int(out.min()) >= 0 and int(out.max()) < 27
    with pytest.raises(ValueError):
        ws_step(prng.key(0), torch.zeros(2, 3, 4, 5), torch.zeros(2, 3, 4, dtype=torch.int32),
                0.5, 0.1, WarmStartPath())
    with pytest.raises(ValueError):
        ws_step(prng.key(0), torch.zeros(4, 5, device="meta"),
                torch.zeros(4, dtype=torch.int32, device="meta"), 0.5, 0.1, WarmStartPath())
