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
from repro_torch.kernels import launches
from repro_torch.kernels.ws_step import (
    key_words, make_ws_step_fn, near_tie_rows, seed_from_key, ws_step, ws_step_ref,
    ws_step_ref_streamed,
)
from repro_torch.kernels.ws_step import ops as ws_ops

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


# -- the grouped draw's identity (csrc/ws_common.cuh draw_row_grouped) -------------------
#
# draw_row gives lane l the leaf (m, s, best, bidx, lg_x, g_x) over columns l, l + 32, ...
# and merges leaf i with leaf i ^ off at off = 16, 8, 4, 2, 1 (an xor butterfly: every
# lane merges its partner's node into its own). draw_row_grouped<G> gives lane j of a
# group of G the leaves j, j + G, ..., merges the levels off >= G in registers and the
# levels off < G by shuffles inside the group. A float32 replica of both must agree bit
# for bit, since draw_row's merge is symmetric.

NEG_LEAF = -1e30


def _leaves(lg, g, x):
    """draw_row's 32 leaves of each row: float32 (rows, 32) fields and int bidx."""
    rows, v = lg.shape
    m = torch.full((rows, 32), NEG_LEAF)
    s = torch.zeros(rows, 32)
    best = torch.full((rows, 32), NEG_LEAF)
    bidx = torch.zeros(rows, 32, dtype=torch.int64)
    lg_x, g_x = torch.zeros(rows, 32), torch.zeros(rows, 32)
    for base in range(0, v, 32):
        cols = torch.arange(base, min(base + 32, v))
        k = cols - base
        lgc, gc = lg[:, cols], g[:, cols]
        m_new = torch.maximum(m[:, k], lgc)
        s[:, k] = s[:, k] * torch.exp(m[:, k] - m_new) + torch.exp(lgc - m_new)
        m[:, k] = m_new
        is_x = cols[None, :] == x[:, None]
        lg_x[:, k] = torch.where(is_x, lgc, lg_x[:, k])
        g_x[:, k] = torch.where(is_x, gc, g_x[:, k])
        cand = lgc + gc
        take = ~is_x & (cand > best[:, k])
        best[:, k] = torch.where(take, cand, best[:, k])
        bidx[:, k] = torch.where(take, cols[None, :].expand_as(take), bidx[:, k])
    return [m, s, best, bidx, lg_x, g_x]


def _merge(a, b):
    """draw_row's merge of node b into node a (each a list of same-shaped fields)."""
    m_a, s_a, b_a, i_a, lx_a, gx_a = a
    m_b, s_b, b_b, i_b, lx_b, gx_b = b
    m = torch.maximum(m_a, m_b)
    s = s_a * torch.exp(m_a - m) + s_b * torch.exp(m_b - m)
    take = (b_b > b_a) | ((b_b == b_a) & (i_b < i_a))
    return [m, s, torch.where(take, b_b, b_a), torch.where(take, i_b, i_a), lx_a + lx_b,
            gx_a + gx_b]


def _butterfly(leaves):
    """draw_row: every lane ends with the same node; lane 0's."""
    nodes = [f.clone() for f in leaves]
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        nodes = _merge(nodes, [f[:, lane ^ off] for f in nodes])
    return nodes


def _grouped(leaves, group):
    """draw_row_grouped<G>: the node every lane of a group ends with, (rows, G)."""
    per = 32 // group
    lanes = torch.arange(group)
    # leaf t of lane j is leaf j + G t
    held = [[f[:, lanes + group * t] for f in leaves] for t in range(per)]
    h = per // 2
    while h:
        for t in range(h):
            held[t] = _merge(held[t], held[t + h])
        h //= 2
    node = held[0]
    off = group // 2
    while off:
        node = _merge(node, [f[:, lanes ^ off] for f in node])
        off //= 2
    return node


def _assert_grouped_equals_butterfly(leaves):
    want = _butterfly(leaves)
    for group in (1, 2, 4, 8, 16, 32):
        got = _grouped(leaves, group)
        for fw, fg in zip(want, got):
            for j in range(group):        # every lane of the group holds the row's node
                assert torch.equal(fg[:, j], fw[:, 0]), group
            assert torch.equal(fw, fw[:, :1].expand_as(fw))


@pytest.mark.parametrize("v,temperature", [(1, 1.0), (27, 1.0), (27, 0.7), (32, 1.0), (33, 0.7),
                                           (100, 1.0), (1000, 1.0)])
def test_grouped_draw_equals_draw_rows_tree_on_rows(v, temperature):
    """Leaves made from rows of logits and the kernels' noise, x in every
    column position; the regrouped tree gives draw_row's node bit for bit."""
    rows = 64
    logits, _ = _inputs(v, 1, rows, v)
    lg = torch.from_numpy(logits[0]) / temperature
    g = prng.threefry_gumbel((3, v), rows, v)
    x = torch.arange(rows) % v
    _assert_grouped_equals_butterfly(_leaves(lg, g, x))


@pytest.mark.parametrize("empty", [0, 5, 31])
def test_grouped_draw_equals_draw_rows_tree_with_ties_and_empty_leaves(empty):
    """Synthetic leaves: best values drawn from three, so that ties between
    leaves are frequent (the lower column must win in any grouping); ``empty``
    leaves of each row left empty (m = -1e30, s = 0, best = -1e30, bidx = 0);
    the column x in each of the 32 leaves in turn."""
    rng = np.random.default_rng(empty)
    rows = 32 * 8
    m = torch.from_numpy(rng.normal(0, 2, (rows, 32)).astype(np.float32))
    s = torch.from_numpy(rng.uniform(0.5, 4, (rows, 32)).astype(np.float32))
    best = torch.from_numpy(rng.choice(np.float32([-1.5, 0.25, 2.0]), (rows, 32)))
    bidx = torch.arange(32)[None, :] + 32 * torch.from_numpy(rng.integers(0, 8, (rows, 32)))
    lg_x, g_x = torch.zeros(rows, 32), torch.zeros(rows, 32)
    pos = torch.arange(rows) % 32
    lg_x[torch.arange(rows), pos] = torch.from_numpy(rng.normal(0, 2, rows).astype(np.float32))
    g_x[torch.arange(rows), pos] = torch.from_numpy(rng.gumbel(size=rows).astype(np.float32))
    for i in range(rows):
        gone = rng.choice(32, empty, replace=False)
        m[i, gone], s[i, gone], best[i, gone], bidx[i, gone] = NEG_LEAF, 0.0, NEG_LEAF, 0
        keep_x = pos[i] in gone
        if keep_x:
            lg_x[i], g_x[i] = 0.0, 0.0
    _assert_grouped_equals_butterfly([m, s, best, bidx, lg_x, g_x])


@pytest.mark.parametrize("seed", [0, 7, -1, 2 ** 31 - 1])
def test_device_key_words_equal_seed_from_key(seed):
    """The words a kernel reads from a key on the card are the key's int64
    data, a view with no copy, and equal ``seed_from_key``'s integers: for a
    key, a row of split keys (as the refine loop indexes them) and a folded
    key. A host key still goes to the launch as the two integers."""
    key = prng.key(seed)
    steps = prng.split(key, 5)
    for k in (key, steps[3], prng.fold_in(key, 9)):
        words = key_words(k)
        assert words.dtype == torch.int64 and words.shape == (2,)
        assert words.data_ptr() == k.data_ptr()
        assert tuple(words.tolist()) == seed_from_key(k)
        assert all(0 <= w < 2 ** 32 for w in seed_from_key(k))
    assert ws_ops._kernel_seed(steps[3], torch.device("cpu")) == seed_from_key(steps[3])


def test_capture_tally_is_thread_local():
    """While a thread captures a graph its launches go to the graph's tally;
    another thread's launch in that time reaches ``launches``; a replay adds
    the whole tally."""
    import collections
    import threading

    from repro_torch import counts

    name = "tally_probe"
    before = launches[name]
    tally = collections.Counter()
    go, done = threading.Event(), threading.Event()

    def other():
        go.wait(10)
        counts.count(name)
        done.set()

    worker = threading.Thread(target=other)
    worker.start()
    with counts.counting_into(tally):
        counts.count(name)
        go.set()
        assert done.wait(10)
        counts.count(name)
    worker.join(10)
    assert not worker.is_alive()
    assert tally == {name: 2} and launches[name] == before + 1
    counts.count(name)
    counts.add(tally)
    assert launches[name] == before + 4
    del launches[name]


def test_graph_cache_imports_counting_not_the_kernel_library():
    """``graphs.py`` takes its launch tallies from ``counts.py`` (standard
    library only) and imports nothing of the kernel library; on a CPU
    tensor the cache just calls ``fn`` and counts nothing."""
    import os
    import pathlib
    import subprocess
    import sys

    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    code = ("import sys, repro_torch.graphs as g, torch; "
            "out = g.GraphCache('probe')(('k',), lambda x: x + 1, torch.zeros(2)); "
            "print(sorted(m for m in sys.modules if m.startswith('repro_torch')), "
            "out.tolist(), len(g.counts.launches))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env={**os.environ, "PYTHONPATH": str(src)})
    assert res.stdout.split() == ["['repro_torch',", "'repro_torch.counts',",
                                  "'repro_torch.graphs']", "[1.0,", "1.0]", "0"]
