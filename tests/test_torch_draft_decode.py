"""The port's draft-decode kernels (plain versions on the CPU) and
``DraftDecoder`` against the JAX package's: each plain function against its
``*_pallas`` kernel in interpret mode (<= 1e-5), ``forward_chunk`` logits and
cache against JAX's, and, inside the port, a batched chunk equal to the
token-by-token scan and to any other chunking, bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _flatten
from repro.configs.dfm_dit import tiny_config as jax_tiny_config
from repro.kernels.draft_decode import kernel as jk
from repro.kernels.draft_decode.ops import (
    DraftDecoder as JaxDraftDecoder, draft_decode_supported as jax_supported,
)
from repro.models import build_model as jax_build_model
from repro_torch.configs.dfm_dit import tiny_config
from repro_torch.convert import jax_params_to_torch
from repro_torch.drafting import TransformerDraftAdapter
from repro_torch.kernels.draft_decode import (
    DraftDecoder, attn_cached, draft_decode_supported, head, ops, post_attn, qkv_rope,
)
from repro_torch.models import Model

VOCAB = 13
TOL = 1e-5
SMALL = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=2, d_ff=64)


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread for these smoke-size models: the suite runs in
    several worker processes at once, where torch's default of a thread a
    core makes each small op wait on the others' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(tree):
    """A JAX parameter dict as the same dict of torch tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _params(rng, d, f, qd, kd, *, norm, bias, gated):
    """A JAX-layout layer's parameters with nonzero biases and norm scales."""
    def dense(i, o):
        p = {"w": rng.standard_normal((i, o)).astype(np.float32) / np.sqrt(i)}
        if bias:
            p["b"] = 0.1 * rng.standard_normal(o).astype(np.float32)
        return p

    def ln():
        p = {"scale": 1.0 + 0.1 * rng.standard_normal(d).astype(np.float32)}
        if norm == "layernorm":
            p["bias"] = 0.1 * rng.standard_normal(d).astype(np.float32)
        return p

    attn = {"wq": dense(d, qd), "wk": dense(d, kd), "wv": dense(d, kd), "wo": dense(qd, d)}
    mlp = {"up": dense(d, f), "down": dense(f, d)}
    if gated:
        mlp["gate"] = dense(d, f)
    return ln(), attn, ln(), mlp


VARIANTS = {
    "layernorm-gelu": dict(norm="layernorm", bias=False, gated=False, act="gelu",
                           rope=True, h=4, kh=4),
    "rmsnorm-bias-gated-silu-gqa": dict(norm="rmsnorm", bias=True, gated=True, act="silu",
                                        rope=True, h=4, kh=2),
    "layernorm-bias-gated-relu-norope": dict(norm="layernorm", bias=True, gated=True,
                                             act="relu", rope=False, h=4, kh=1),
    "rmsnorm-relu-norope-gqa": dict(norm="rmsnorm", bias=False, gated=False, act="relu",
                                    rope=False, h=6, kh=2),
    "rmsnorm-bias-gelu": dict(norm="rmsnorm", bias=True, gated=False, act="gelu",
                              rope=True, h=2, kh=2),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_plain_kernels_match_pallas(name):
    v = VARIANTS[name]
    rng = np.random.default_rng(sorted(VARIANTS).index(name))
    b, s, t, d, f, hd = 2, 3, 9, 24, 40, 8
    h, kh = v["h"], v["kh"]
    qd, kd, r, start, pos0 = h * hd, kh * hd, b * s, 4, 4
    ln1, attn_p, ln2, mlp_p = _params(rng, d, f, qd, kd, norm=v["norm"], bias=v["bias"],
                                      gated=v["gated"])
    x = rng.standard_normal((r, d)).astype(np.float32)
    pos_r = (pos0 + np.tile(np.arange(s), b)).astype(np.int32)[:, None]
    common = dict(heads=h, kv_heads=kh, head_dim=hd)

    # qkv_rope: q returned, k/v written at the cursor
    jq, jk_, jv = jk.qkv_rope_pallas(
        jnp.asarray(x), jnp.asarray(pos_r), ln1, attn_p, norm=v["norm"], eps=1e-6,
        use_bias=v["bias"], use_rope=v["rope"], theta=10000.0, interpret=True, **common)
    kbuf = torch.from_numpy(rng.standard_normal((b, t, kd)).astype(np.float32))
    vbuf = torch.from_numpy(rng.standard_normal((b, t, kd)).astype(np.float32))
    kinit, vinit = kbuf.clone(), vbuf.clone()
    cur = torch.tensor(start, dtype=torch.int32)
    q = qkv_rope(torch.from_numpy(x), _t(ln1), _t(attn_p), kbuf, vbuf, cur, pos0=pos0, seq=s,
                 norm=v["norm"], eps=1e-6, use_rope=v["rope"], theta=10000.0, **common)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=TOL, rtol=TOL)
    for buf, init, want in ((kbuf, kinit, jk_), (vbuf, vinit, jv)):
        np.testing.assert_allclose(buf[:, start:start + s].reshape(r, kd).numpy(),
                                   np.asarray(want), atol=TOL, rtol=TOL)
        outside = torch.ones(t, dtype=torch.bool)
        outside[start:start + s] = False
        assert torch.equal(buf[:, outside], init[:, outside])

    # attn_cached: the whole buffer, causal and validity masks
    a = attn_cached(q, kbuf, vbuf, cur, pos0=pos0, seq=s, **common)
    ja = jk.attn_cached_pallas(
        jnp.asarray(q.numpy()).reshape(b, s, qd), jnp.asarray(kbuf.numpy()),
        jnp.asarray(vbuf.numpy()), jnp.asarray(pos_r), jnp.full((1, 1), start + s, jnp.int32),
        seq=s, interpret=True, **common)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja).reshape(r, qd), atol=TOL, rtol=TOL)

    # post_attn and head
    out = post_attn(a, torch.from_numpy(x), _t(attn_p), _t(ln2), _t(mlp_p), norm=v["norm"],
                    eps=1e-6, act=v["act"])
    jout = jk.post_attn_pallas(jnp.asarray(a.numpy()), jnp.asarray(x), attn_p, ln2, mlp_p,
                               norm=v["norm"], eps=1e-6, use_bias=v["bias"], act=v["act"],
                               interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL, rtol=TOL)
    w = rng.standard_normal((d, VOCAB)).astype(np.float32)
    logits = head(out, _t(ln1), torch.from_numpy(w), norm=v["norm"], eps=1e-6)
    jlogits = jk.head_pallas(jnp.asarray(out.numpy()), ln1, jnp.asarray(w), norm=v["norm"],
                             eps=1e-6, interpret=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=TOL, rtol=TOL)


def _cfgs(**kw):
    base = dict(SMALL, **kw)
    return (jax_tiny_config(vocab_size=VOCAB, seq_len=64).replace(**base),
            tiny_config(vocab_size=VOCAB, seq_len=64).replace(**base))


def _perturb(params, seed):
    """Nonzero biases and norm parameters (they start at 0 / 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        if name.endswith(("['b']", "['bias']", "['scale']")):
            return x + 0.1 * jnp.asarray(rng.standard_normal(x.shape), jnp.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, params)


def _pair(seed=0, **kw):
    jcfg, cfg = _cfgs(**kw)
    jm = jax_build_model(jcfg)
    params = _perturb(jm.init(jax.random.key(seed)), seed)
    model = Model(cfg, device="cpu")
    model.load_state_dict(jax_params_to_torch(_flatten(params)), strict=True)
    return jm, params, model


MODEL_VARIANTS = {
    "dit": {},
    "rmsnorm-gated-bias-tied-gqa": dict(norm="rmsnorm", mlp_gated=True, use_bias=True,
                                        tie_embeddings=True, num_heads=4, num_kv_heads=2,
                                        act="silu"),
    "norope-relu": dict(rope_type="none", act="relu"),
}
# a pattern of two positions: stacked p0/p1 leaves plus one remainder layer.
# The JAX DraftDecoder runs only p0's layers there (fault R3 in ROADMAP.md),
# so the port is held against the JAX model's own prefill/decode_step.
PATTERN2 = dict(pattern=("attn", "attn"), num_layers=3)


def _cache_leaves(cache):
    """(path, array) of every leaf, in the JAX tree order."""
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
            jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, cache))]


@pytest.mark.parametrize("name", sorted(MODEL_VARIANTS))
def test_forward_chunk_matches_jax(name):
    """A 3-token prefill then a decode step: logits and cache leaves within
    1e-5 of the JAX kernel path's, cursors exact."""
    jm, params, model = _pair(**MODEL_VARIANTS[name])
    toks = np.random.default_rng(4).integers(0, VOCAB, (2, 4)).astype(np.int32)
    jdec, dec = JaxDraftDecoder(jm), DraftDecoder(model)
    jcache = jm.init_cache(2, 8, jnp.float32)
    cache = model.init_cache(2, 8, torch.float32)
    for lo, hi in ((0, 3), (3, 4)):
        jl, jcache = jdec.forward_chunk(params, jnp.asarray(toks[:, lo:hi]), jcache, lo)
        lg, cache = dec.forward_chunk(torch.from_numpy(toks[:, lo:hi]), cache, lo)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    want, got = _cache_leaves(jcache), _cache_leaves(cache)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if path.endswith("['pos']"):
            np.testing.assert_array_equal(g, w)
            assert (g == 4).all()
        else:
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)


def test_forward_chunk_with_remainder_layers_matches_jax_model():
    jm, params, model = _pair(**PATTERN2)
    toks = np.random.default_rng(4).integers(0, VOCAB, (2, 4)).astype(np.int32)
    dec = DraftDecoder(model)
    jcache = jm.init_cache(2, 8, jnp.float32)
    cache = model.init_cache(2, 8, torch.float32)
    jl, jcache = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :3])}, jcache)
    lg, cache = dec.forward_chunk(torch.from_numpy(toks[:, :3]), cache, 0)
    np.testing.assert_allclose(lg[:, -1:].numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    jl, jcache = jm.decode_step(params, jnp.asarray(toks[:, 3:]), jcache, 3)
    lg, cache = dec.forward_chunk(torch.from_numpy(toks[:, 3:]), cache, 3)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    want, got = _cache_leaves(jcache), _cache_leaves(cache)
    assert [p for p, _ in got] == [p for p, _ in want] and len(got) == 9
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", sorted(MODEL_VARIANTS) + ["pattern2-remainder"])
def test_batched_chunk_is_bit_identical_to_token_scan(name):
    """forward_chunk(B, S) == S single-token calls == chunks 3 + 1 + 4:
    logits and every cache leaf, bitwise."""
    _, _, model = _pair(seed=1, **MODEL_VARIANTS.get(name, PATTERN2))
    dec = DraftDecoder(model)
    b, s, t = 3, 8, 12
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, VOCAB, (b, s)).astype(np.int32))
    runs = []
    for split in ((8,), (1,) * 8, (3, 1, 4)):
        cache = model.init_cache(b, t, torch.float32)
        parts, pos = [], 0
        for w in split:
            lg, cache = dec.forward_chunk(toks[:, pos:pos + w], cache, pos)
            parts.append(lg)
            pos += w
        runs.append((torch.cat(parts, dim=1), cache))
    (ref_logits, ref_cache), *others = runs
    for logits, cache in others:
        assert torch.equal(logits, ref_logits)
        for (_, got), (_, want) in zip(_cache_leaves(cache), _cache_leaves(ref_cache)):
            np.testing.assert_array_equal(got, want)


def test_kernel_forward_close_to_plain_decode():
    """The kernel path tracks the model's own plain decode_step."""
    _, _, model = _pair(seed=2)
    dec = DraftDecoder(model)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, VOCAB, (2, 6)).astype(np.int32))
    ck, cx = model.init_cache(2, 16, torch.float32), model.init_cache(2, 16, torch.float32)
    for i in range(6):
        lk, ck = dec.forward_chunk(toks[:, i:i + 1], ck, i)
        with torch.no_grad():
            lx, cx = model.decode_step(toks[:, i:i + 1], cx, i)
        np.testing.assert_allclose(lk.numpy(), lx.numpy(), atol=TOL, rtol=TOL)


SUPPORT_CASES = {
    "base": {}, "rmsnorm": dict(norm="rmsnorm"), "bias-gated-tied": dict(
        use_bias=True, mlp_gated=True, tie_embeddings=True), "relu": dict(act="relu"),
    "norope": dict(rope_type="none"), "qk_norm": dict(qk_norm=True),
    "bf16": dict(dtype="bfloat16"), "softcap": dict(attn_logit_softcap=50.0),
    "post_norms": dict(post_norms=True), "embed_scale": dict(embed_scale=True),
    "mrope": dict(rope_type="mrope"), "dual": dict(rope_type="dual"),
    "local": dict(pattern=("attn", "local")), "prefix": dict(prefix=("attn",)),
    "vlm": dict(family="vlm"), "moe-family": dict(family="moe"),
    "param-bf16": dict(param_dtype="bfloat16"), "act-gelu-exact": dict(act="swish"),
}


@pytest.mark.parametrize("name", sorted(SUPPORT_CASES))
def test_supported_gate_agrees_with_jax(name):
    jcfg, cfg = _cfgs(**SUPPORT_CASES[name])
    assert draft_decode_supported(cfg) == jax_supported(jcfg)


def test_supported_gate_rejects_none():
    assert not draft_decode_supported(None) and not jax_supported(None)


def test_adapter_decode_impl_plumbing():
    _, _, model = _pair()
    assert TransformerDraftAdapter(model=model).exact_batched_prefill
    assert TransformerDraftAdapter(model=model, decode_impl="kernel").exact_batched_prefill
    assert not TransformerDraftAdapter(model=model, decode_impl="xla").exact_batched_prefill
    assert not TransformerDraftAdapter(model=model,
                                       cache_dtype=torch.bfloat16).exact_batched_prefill
    with pytest.raises(ValueError, match="decode_impl"):
        _ = TransformerDraftAdapter(model=model, decode_impl="nope").exact_batched_prefill


def test_wrappers_refuse_other_devices():
    x = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        head(x, {"scale": torch.zeros(4, device="meta")}, torch.zeros(4, 3, device="meta"),
             norm="rmsnorm", eps=1e-6)


# (D, V) -> (RT, NT, bytes of shared memory), as csrc/draft_decode.cu head_tiling picks
# them: the decode shape (one row a block, 32 blocks at 32 rows), the tied 50257 head
# (8 rows a block), D = 2056 (8 columns a block so the slab fits), small D at V = 257
# and 1000 (2 and 4 rows a block: the grid at 32 rows still fills 132 SMs), D = 7200
# (4 columns, and one row: two rows' shared memory would not fit)
HEAD_TILINGS = [
    (768, 27, 1, 32, 109056), (768, 50257, 8, 32, 137728), (2056, 27, 1, 8, 97792),
    (2056, 50257, 8, 8, 165888), (64, 1000, 4, 32, 14336), (90, 257, 2, 32, 16384),
    (7200, 1000, 1, 4, 214016),
]


@pytest.mark.parametrize("d,v,rt,nt,smem", HEAD_TILINGS)
def test_head_tiling_and_shared_memory(d, v, rt, nt, smem):
    assert ops._head_tiling(d, v) == (rt, nt)
    assert ops._head_smem(d, v, rt, nt) == smem <= ops.MAX_SMEM
    blocks_at_32_rows = -(-32 // rt) * -(-v // nt)
    assert blocks_at_32_rows >= 32
    # the rows may not double once more and still fill the card (or fit), or are at 8
    assert (rt == ops.HEAD_MAX_ROWS or -(-v // nt) * -(-32 // (2 * rt)) < ops.CARD_SMS
            or ops._head_smem(d, v, 2 * rt, nt) > ops.MAX_SMEM)


def test_head_limits_follow_the_tiling():
    """The wrapper's checks: a D whose slab, rows and partial sums take more
    than a block's shared memory is refused; the row tiles lie along grid x,
    so R may reach RT x (2^31 - 1), and the column tiles along y."""
    rt, nt = ops._head_tiling(12000, 27)
    assert (rt, nt) == (1, 4) and ops._head_smem(12000, 27, rt, nt) > ops.MAX_SMEM
    limit = ops.MAX_GRID_X
    with pytest.raises(ValueError, match="shared memory"):
        ops._check_limits("head", 32, rt, 12000, ops._head_smem(12000, 27, rt, nt),
                          max_blocks=limit)
    rt, nt = ops._head_tiling(768, 50257)
    smem = ops._head_smem(768, 50257, rt, nt)
    ops._check_limits("head", rt * limit, rt, 768, smem, max_blocks=limit)
    with pytest.raises(ValueError, match="rows"):
        ops._check_limits("head", rt * limit + 1, rt, 768, smem, max_blocks=limit)
    with pytest.raises(ValueError, match="rows"):
        ops._check_limits("head", 0, rt, 768, smem, max_blocks=limit)
    # the other kernels keep their rows along grid y
    with pytest.raises(ValueError, match="rows"):
        ops._check_limits("post_attn", 32 * ops.MAX_GRID_Y + 1, 32, 768, 1024)


@pytest.mark.parametrize("head_dim", ops.HEAD_DIMS)
def test_attn_slices_cover_t_for_every_length(head_dim):
    """attn_cached's split of T (``ops.attn_slices``): for T = 1 .. 65 536, C in
    1 .. 8 blocks and W = ceil(T / C), so the slices [s W, min(T, (s + 1) W))
    are contiguous and cover [0, T) once; a block's stage and its pairs fit in
    shared memory at every T."""
    worst = ops.ATTN_PAIRS
    for t in range(1, 65537):
        c, w = ops.attn_slices(t, head_dim)
        assert 1 <= c <= ops.ATTN_CLUSTER and w == -(-t // c)
    for t in (*range(1, 300), 57812, 65535, 65536):
        c, w = ops.attn_slices(t, head_dim)
        bounds = [(min(t, s * w), min(t, (s + 1) * w)) for s in range(c)]
        assert bounds[0][0] == 0 and bounds[-1][1] == t
        assert all(a[1] == b[0] and a[0] <= a[1] for a, b in zip(bounds, bounds[1:]))
    stage = ops.ATTN_STAGE[head_dim]
    # the shared memory grows with the stage, which stops growing at W = stage
    assert max(ops._attn_smem(t, head_dim, worst) for t in range(1, ops.ATTN_CLUSTER * stage + 1)) \
        == ops._attn_smem(65536, head_dim, worst) <= ops.MAX_SMEM
    with pytest.raises(ValueError, match="slices"):
        ops.attn_slices(0, head_dim)


@pytest.mark.parametrize("heads,kv_heads,seq,tiles", [
    (12, 12, 1, (1, 1)), (12, 12, 16, (1, 16)), (24, 2, 1, (12, 1)), (24, 2, 16, (12, 1)),
    (24, 8, 5, (3, 5)), (32, 1, 3, (16, 1)), (8, 2, 40, (4, 4))])
def test_attn_launch_takes_the_slices_of_t_alone(monkeypatch, heads, kv_heads, seq, tiles):
    """The wrapper hands the kernel ``attn_slices(T, hd)`` whatever the rows, the
    chunk length, the cursor or the group; only which cluster owns a (row, head)
    pair follows them (at most ATTN_PAIRS pairs a cluster)."""
    import contextlib

    seen = []

    class Lib:
        def draft_attn_cached_launch(self, *args):
            seen.append(args)
            return 0

    monkeypatch.setattr(ops._build, "library", lambda: Lib())
    monkeypatch.setattr(ops, "_stream", lambda device: 0)
    monkeypatch.setattr(ops.torch.cuda, "device", lambda device: contextlib.nullcontext())
    hd, t = 32, 271
    hg, qr = ops._attn_tiles(heads, kv_heads, seq)
    assert (hg, qr) == tiles and hg * qr <= ops.ATTN_PAIRS
    for b, cursor in ((1, 0), (7, 100), (32, t - seq)):
        q = torch.zeros(b * seq, heads * hd)
        buf = torch.zeros(b, t, kv_heads * hd)
        ops._launch_attn_cached(q, buf, buf, torch.tensor(cursor, dtype=torch.int32), q,
                                pos0=cursor, seq=seq, heads=heads, kv_heads=kv_heads,
                                head_dim=hd)
    # (R, S, T, H, KH, hd, pos0, C, W) after the five pointers
    assert {args[12:14] for args in seen} == {ops.attn_slices(t, hd)}
    assert [args[5:7] for args in seen] == [(seq, seq), (7 * seq, seq), (32 * seq, seq)]
