"""The port's ``ws_fused`` (K draws on one frozen logits buffer) against the
JAX package's ``ws_fused_steps`` in interpret mode, in both key layouts.

Tolerance: tokens equal except on rows that met a near tie on the port's
path (``ws_fused_ref(..., tie_tol=1e-5)``: the keep-vs-move scores or the
two best candidates within 1e-5), where the TPU kernel's tiled softmax sum
and the plain version's full-row sum may round differently. The tests also
pin the a = 0 freeze and the one reference fault they meet (R4 in
ROADMAP.md: the JAX noise is +inf on one element in 2**24)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.paths import WarmStartPath as JaxPath
from repro.kernels.ws_fused import ws_fused_steps as jax_ws_fused_steps
from repro.kernels.ws_step.kernel import gumbel_from_bits as jax_gumbel_from_bits
from repro.kernels.ws_step.kernel import threefry2x32 as jax_threefry2x32
from repro_torch import prng
from repro_torch.core.paths import WarmStartPath
from repro_torch.kernels import make_ws_fused_fn, ws_fused_steps
from repro_torch.kernels.ws_fused import fused_noise, ws_fused_ref
from repro_torch.kernels.ws_fused.ops import fused_inputs
from repro_torch.kernels.ws_step import ws_step

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


def _case(layout, k, b, n, v, seed):
    """numpy inputs and both packages' keys: single key per step, or per
    (step, request row) keys with an inactive row and one entering
    mid-block (h = 0 steps)."""
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((b, n, v))).astype(np.float32)
    x = rng.integers(0, v, (b, n)).astype(np.int32)
    if layout == "single":
        jk, tk = jax.random.split(jax.random.key(seed), k), prng.split(prng.key(seed), k)
        ts = (0.5 + np.arange(k) / 16).astype(np.float32)
        hs = np.full((k,), 1 / 16, np.float32)
        hs[-1] = 0.0
    else:
        jbase = jax.random.split(jax.random.key(seed), b)
        jk = jax.vmap(lambda i: jax.vmap(jax.random.fold_in)(jbase, jnp.full((b,), i)))(
            jnp.arange(k))
        tk = prng.fold_in(prng.split(prng.key(seed), b)[None], torch.arange(k)[:, None])
        ts = np.tile((0.5 + np.arange(k) / 16).astype(np.float32)[:, None], (1, b))
        hs = np.full((k, b), 1 / 16, np.float32)
        hs[:, 0] = 0.0
        hs[: k // 2, 1] = 0.0
    return logits, x, ts, hs, jk, tk


@pytest.mark.parametrize("layout", ["single", "rows"])
@pytest.mark.parametrize("k,v", [(1, 27), (2, 27), (3, 27), (4, 200)])
def test_ws_fused_matches_jax_interpret(layout, k, v):
    b, n = 3, 24
    logits, x, ts, hs, jk, tk = _case(layout, k, b, n, v, 10 * k + v)
    want = np.asarray(jax_ws_fused_steps(jk, jnp.asarray(logits), jnp.asarray(x),
                                         jnp.asarray(ts), jnp.asarray(hs), JaxPath(0.0),
                                         interpret=True))
    lt, xt = torch.from_numpy(logits), torch.from_numpy(x)
    got = ws_fused_steps(tk, lt, xt, torch.from_numpy(ts), torch.from_numpy(hs),
                         WarmStartPath(0.0))
    seeds, lg, xr, a, kg, ag = fused_inputs(tk, lt, xt, ts, hs, WarmStartPath(0.0))
    _, ties = ws_fused_ref(seeds, lg, xr, a, key_group=kg, a_group=ag, tie_tol=TIE_TOL)
    mismatch = (got.numpy() != want).reshape(-1)
    assert not (mismatch & ~ties.numpy()).any()
    if layout == "rows":
        np.testing.assert_array_equal(got[0].numpy(), x[0])      # h = 0 on every step


@pytest.mark.parametrize("layout", ["single", "rows"])
def test_fused_equals_composed_and_single_key_equals_ws_step(layout):
    k, b, n, v = 4, 2, 16, 27
    logits, x, ts, hs, _, tk = _case(layout, k, b, n, v, 5)
    lt, xt, path = torch.from_numpy(logits), torch.from_numpy(x), WarmStartPath(0.0)
    fused = ws_fused_steps(tk, lt, xt, ts, hs, path)
    composed = ws_fused_steps(tk, lt, xt, ts, hs, path, impl="composed")
    assert torch.equal(fused, composed)
    if layout == "single":
        cur = xt
        for j in range(k):
            cur = ws_step(tk[j], lt, cur, torch.tensor(ts[j]), torch.tensor(hs[j]), path)
        assert torch.equal(fused, cur)
    fn = make_ws_fused_fn(path)
    assert torch.equal(fn(tk, lt, xt, ts, hs), fused)


def test_ws_fused_validation_matches_jax():
    lt, xt = torch.zeros(2, 4, 5), torch.zeros(2, 4, dtype=torch.int32)
    path = WarmStartPath(0.0)
    keys2 = prng.split(prng.key(0), 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        ws_fused_steps(keys2, lt, xt, torch.zeros(3), torch.zeros(2), path)
    with pytest.raises(ValueError, match="require"):
        ws_fused_steps(torch.zeros(3, 2, 2, dtype=torch.int64), lt.reshape(8, 5),
                       xt.reshape(8), torch.zeros(3), torch.zeros(3), path)
    with pytest.raises(ValueError, match="per-row keys shape"):
        ws_fused_steps(torch.zeros(3, 4, 2, dtype=torch.int64), lt, xt, torch.zeros(3),
                       torch.zeros(3), path)
    with pytest.raises(ValueError, match="bad ts shape"):
        ws_fused_steps(keys2, lt, xt, torch.zeros(3, 4), torch.zeros(3, 4), path)
    with pytest.raises(ValueError, match="hw_prng"):
        ws_fused_steps(keys2, lt, xt, torch.zeros(3), torch.zeros(3), path, hw_prng=True)
    with pytest.raises(ValueError, match="impl"):
        ws_fused_steps(keys2, lt, xt, torch.zeros(3), torch.zeros(3), path, impl="tiled")
    assert ws_fused_steps(keys2[:0], lt, xt, torch.zeros(0), torch.zeros(0), path) is xt


# key words and counter (row 13, column 40081) whose threefry word 0 has
# bits >> 8 == 0xFFFFFF: (bits >> 8) + 0.5 rounds to 2**24 in float32
R4_KEY, R4_ROW, R4_COL = (1234199231, 716562018), 13, 40081


def test_reference_fault_r4_infinite_noise_is_clamped_in_the_port():
    k0, k1 = (jnp.uint32(w) for w in R4_KEY)
    bits, _ = jax_threefry2x32(k0, k1, jnp.uint32(R4_ROW), jnp.uint32(R4_COL))
    assert int(bits) >> 8 == 0xFFFFFF
    assert np.isposinf(np.asarray(jax_gumbel_from_bits(bits)))       # the reference fault
    seeds = torch.tensor([list(R4_KEY)], dtype=torch.int64)
    g = fused_noise(seeds, 16, R4_COL + 1, 16)
    assert torch.isfinite(g).all()
    assert float(g[R4_ROW, R4_COL]) == pytest.approx(16.6355, abs=1e-3)
    # elsewhere the port's noise is the JAX noise: the same bits, and the
    # two packages' logs within one ulp of max(|g|, 1)
    r = jnp.arange(16, dtype=jnp.uint32)[:, None]
    c = jnp.arange(R4_COL + 1, dtype=jnp.uint32)[None, :]
    jg = np.asarray(jax_gumbel_from_bits(jax_threefry2x32(k0, k1, r, c)[0]))
    finite = np.isfinite(jg)
    assert finite.sum() == jg.size - 1
    tg, jg = g.numpy()[finite], jg[finite]
    assert (np.abs(tg - jg) <= np.spacing(np.maximum(np.abs(jg), 1.0))).all()


def test_a_zero_freezes_rows_even_on_the_r4_element():
    """Row 13 of a request whose step key is R4_KEY meets the +inf element;
    at a = 0 the port keeps the row (the JAX reference moves it to column
    40081)."""
    v, n = R4_COL + 1, 16
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal((1, n, v))
                              .astype(np.float32))
    x = torch.zeros(1, n, dtype=torch.int32)
    keys = torch.tensor([[list(R4_KEY)]], dtype=torch.int64)          # (K=1, B=1, 2)
    got = ws_fused_steps(keys, logits, x, torch.full((1, 1), 0.5), torch.zeros(1, 1),
                         WarmStartPath(0.0))
    assert torch.equal(got, x)


# -- the kernel's draw, replicated in float32 ----------------------------------------------
# ws_fused_kernel<G> takes a row's (m, s) once, through draw_row_grouped<G>'s leaves and
# merge tree, then for each step merges only (best, bidx) over v != x through the same tree
# and reads lg[x] and g[x] directly. A replica of that against a replica of draw_row (32
# leaves, column l + 32 i in leaf l, a xor butterfly over all six fields) must give the
# same scores and tokens at every step, bit for bit, for every G.

NEG_LEAF = -1e30


def _leaves(lg, g, x):
    """draw_row's 32 leaves of each row: (m, s, best, bidx, lg_x, g_x), (rows, 32)."""
    rows, v = lg.shape
    m, s = torch.full((rows, 32), NEG_LEAF), torch.zeros(rows, 32)
    best, bidx = torch.full((rows, 32), NEG_LEAF), torch.zeros(rows, 32, dtype=torch.int64)
    lg_x, g_x = torch.zeros(rows, 32), torch.zeros(rows, 32)
    for col in range(v):
        k, lgc, gc = col % 32, lg[:, col], g[:, col]
        m_new = torch.maximum(m[:, k], lgc)
        s[:, k] = s[:, k] * torch.exp(m[:, k] - m_new) + torch.exp(lgc - m_new)
        m[:, k] = m_new
        is_x = x == col
        lg_x[:, k] = torch.where(is_x, lgc, lg_x[:, k])
        g_x[:, k] = torch.where(is_x, gc, g_x[:, k])
        take = ~is_x & (lgc + gc > best[:, k])
        best[:, k] = torch.where(take, lgc + gc, best[:, k])
        bidx[:, k] = torch.where(take, col, bidx[:, k])
    return [m, s, best, bidx, lg_x, g_x]


def _merge_stats(a, b):
    m = torch.maximum(a[0], b[0])
    return [m, a[1] * torch.exp(a[0] - m) + b[1] * torch.exp(b[0] - m)]


def _merge_best(a, b):
    take = (b[0] > a[0]) | ((b[0] == a[0]) & (b[1] < a[1]))
    return [torch.where(take, b[0], a[0]), torch.where(take, b[1], a[1])]


def _merge_all(a, b):
    return _merge_stats(a[:2], b[:2]) + _merge_best(a[2:4], b[2:4]) + [a[4] + b[4],
                                                                        a[5] + b[5]]


def _butterfly(fields, merge):
    """draw_row's xor butterfly over 32 lanes; lane 0's node."""
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        fields = merge(fields, [f[:, lane ^ off] for f in fields])
    return [f[:, 0] for f in fields]


def _grouped_tree(fields, merge, group):
    """draw_row_grouped<G>'s tree: leaf j + G t in lane j, the levels off >= G in
    registers, off < G by xor inside the group; every lane's node must agree."""
    lanes = torch.arange(group)
    held = [[f[:, lanes + group * t] for f in fields] for t in range(32 // group)]
    h = len(held) // 2
    while h:
        for t in range(h):
            held[t] = merge(held[t], held[t + h])
        h //= 2
    node, off = held[0], group // 2
    while off:
        node = merge(node, [f[:, lanes ^ off] for f in node])
        off //= 2
    for f in node:
        assert torch.equal(f, f[:, :1].expand_as(f))
    return [f[:, 0] for f in node]


def _scores(m, s, best, bidx, lg_x, g_x, x, a):
    score_other = ((torch.log(torch.clamp_min(a, 1e-30)) + best) - m) - torch.log(s)
    px = (1.0 - a) + a * (torch.exp(lg_x - m) / s)
    score_x = torch.log(torch.clamp_min(px, 1e-30)) + g_x
    return score_x, score_other, torch.where(score_x >= score_other, x, bidx)


def _assert_fused_draw_equals_draw_rows(lg, gs, x, a_steps):
    """K draws: draw_row's (all fields, every step) against the kernel's (stats
    once, candidates a step, lg[x] and g[x] read directly), for every G."""
    rows = lg.shape[0]
    ar = torch.arange(rows)
    for group in (2, 4, 8, 16, 32):
        want_x = got_x = x.clone()
        leaves = _leaves(lg, gs[0], x)
        m, s = _grouped_tree(leaves[:2], _merge_stats, group)
        for g, a in zip(gs, a_steps):
            node = _butterfly(_leaves(lg, g, want_x), _merge_all)
            want = _scores(*node, want_x, a)
            assert torch.equal(m, node[0]) and torch.equal(s, node[1])
            best, bidx = _grouped_tree(_leaves(lg, g, got_x)[2:4], _merge_best, group)
            lg_x, g_x = lg[ar, got_x], g[ar, got_x]
            assert torch.equal(lg_x, node[4]) and torch.equal(g_x, node[5])  # -0 == +0
            got = _scores(m, s, best, bidx, lg_x, g_x, got_x, a)
            for w, o in zip(want, got):
                assert torch.equal(w.view(torch.int32), o.view(torch.int32)), group
            want_x, got_x = want[2], got[2]


@pytest.mark.parametrize("v", [5, 27, 40, 100])
def test_fused_draw_with_stats_once_equals_draw_rows_tree(v):
    """Logits and noise from a few values (ties among the candidates in and
    across leaves are frequent; -0.0 among them, and -0.0 at x in a third of
    the rows), leaves empty at V < 32, x on the leaf boundaries 0, 31, 32 and
    V - 1, weights 0, 1/16, 0.3 and 1; 4 steps, the token carried."""
    rng = np.random.default_rng(v)
    rows, k = 192, 4
    vals = np.float32([-1.5, -0.0, 0.0, 0.25, 2.0])
    lg = torch.from_numpy(rng.choice(vals, (rows, v)))
    x = torch.tensor([0, 31, 32, v - 1, 63, 64] * (rows // 6)) % v
    lg[torch.arange(0, rows, 3), x[::3]] = -0.0
    gs = [torch.from_numpy(rng.choice(np.float32([-0.0, 0.0, 0.5, 1.0, -1.0]), (rows, v)))
          for _ in range(k)]
    a_steps = [torch.from_numpy(rng.choice(np.float32([0.0, 1 / 16, 0.3, 1.0]), rows))
               for _ in range(k)]
    _assert_fused_draw_equals_draw_rows(lg, gs, x, a_steps)


@pytest.mark.parametrize("v,temperature", [(27, 1.0), (27, 0.7), (200, 1.0)])
def test_fused_draw_with_stats_once_equals_draw_rows_tree_on_kernel_noise(v, temperature):
    """The same on logits / T and the kernel's counter noise, one key a step."""
    rows, k = 64, 3
    logits = torch.from_numpy((3 * np.random.default_rng(v).standard_normal((rows, v)))
                              .astype(np.float32))
    seeds = prng.split(prng.key(v), k)[:, None, :]
    gs = [fused_noise(seeds[j], rows, v, rows) for j in range(k)]
    x = torch.arange(rows) % v
    a_steps = [torch.full((rows,), 0.3), torch.full((rows,), 1 / 16), torch.ones(rows)]
    _assert_fused_draw_equals_draw_rows(logits / temperature, gs, x, a_steps)
