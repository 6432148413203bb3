"""The pieces of the port's graphed train step that run on the CPU, against
the JAX package: the optimizers' device body fed a step's values from the
host prologue as a float32 tensor (a CUDA graph's input) against the same
body fed Python floats (bitwise) and against JAX's AdamW and Adafactor over
5 ``warmup_cosine`` steps; the compile key of ``jit_train_step`` and of
``train_distilled``'s step against the executables JAX's jitted steps keep
after the same batches; the jitted step on the CPU (eager launches) against
the un-jitted one; and the launch counts of a capture's other threads. On
the card the graphs themselves are held against eager steps by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""

import collections
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.drafting.distill as jax_distill
from repro.checkpoint.io import _flatten
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import RunConfig as JaxRunConfig
from repro.core.paths import WarmStartPath as JaxPath
from repro.models import build_model as jax_build_model
from repro.optim import (
    Adafactor as JaxAdafactor, AdamW as JaxAdamW, warmup_cosine as jax_warmup_cosine,
)
from repro.training import TrainState as JaxTrainState
from repro.training import make_train_step as jax_make_train_step
from repro_torch import counts, prng
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.convert import jax_distilled_params_to_torch
from repro_torch.drafting import distill
from repro_torch.graphs import compile_key
from repro_torch.models import build_model
from repro_torch.models.rope import vlm_positions
from repro_torch.optim import Adafactor, AdamW, warmup_cosine
from repro_torch.optim.adamw import device_scalars, next_step
from repro_torch.training import Trainer, TrainState, jit_train_step, make_train_step

STEPS = 5


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread for these small tensors: the suite runs in
    several worker processes at once, where torch's default of a thread a
    core makes each small op wait on the others' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the optimizers' device body ------------------------------------------------------

# JAX leaves: two stacked (2 layers each) and two plain, one of them a vector
SHAPES = {"embed": (16, 8), "stack|blocks|p0|w": (2, 8, 12), "stack|blocks|p0|b": (2, 12),
          "head|b": (16,)}


def _tree(flat):
    """The JAX tree of a flat ``{"a|b": array}``."""
    tree = {}
    for name, x in flat.items():
        *path, last = name.split("|")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[last] = jnp.asarray(x)
    return tree


def _leaves(flat):
    """The port's ``{leaf: [tensor a layer]}`` of a flat dict (stacked
    leaves as per-layer tensors)."""
    return {k: [torch.from_numpy(np.array(x)) for x in v] if k.startswith("stack|")
            else [torch.from_numpy(np.array(v))] for k, v in flat.items()}


def _run_both_forms(jax_opt, opt):
    """STEPS updates on the same random gradients (each leaf at its own
    scale): JAX's, the port's body fed :meth:`hyper` as a float32 tensor
    and the port's body fed it as Python floats. Returns (JAX params, JAX
    state, [(leaves, state)] for the tensor and the float form)."""
    rng = np.random.default_rng(0)
    flat = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    params = _tree(flat)
    jstate = jax_opt.init(params)
    update = jax.jit(jax_opt.update)
    forms = []
    for _ in range(2):
        leaves = _leaves(flat)
        forms.append([leaves, opt.init(leaves)])
    for _ in range(STEPS):
        g = {k: (rng.standard_normal(s) * 10.0 ** rng.uniform(-4, 0)).astype(np.float32)
             for k, s in SHAPES.items()}
        params, jstate = update(_tree(g), jstate, params)
        for i, form in enumerate(forms):
            leaves, state = form
            h = opt.hyper(state)
            hyper = device_scalars(h, "cpu") if i == 0 else tuple(float(x) for x in h)
            opt.apply(_leaves(g), state, leaves, hyper)
            form[1] = next_step(state)
    return params, jstate, forms


def _stacked(ts):
    return torch.stack(ts).numpy() if len(ts) > 1 else ts[0].numpy()


def _assert_forms_bitwise(forms, fields):
    (la, sa), (lb, sb) = forms
    for k in SHAPES:
        for a, b in zip(la[k], lb[k]):
            assert torch.equal(a, b), k
    for f in fields:
        for k, a in getattr(sa, f).items():
            assert torch.equal(a, getattr(sb, f)[k]), (f, k)
    assert int(sa.step) == int(sb.step) == STEPS


@pytest.mark.parametrize("amsgrad,moments", [(True, "float32"), (False, "float32"),
                                             (True, "bfloat16")])
def test_adamw_device_body_is_the_host_float_form_and_jax(amsgrad, moments):
    """The tensor form equals the float form bit for bit, every parameter
    and moment. Against JAX the tolerances of
    ``tests/test_torch_training.py``: float32 moments, parameters within 4e-7
    relative and moments within 1e-5 relative plus 1e-6 of the leaf's max;
    bf16 moments, parameters within 1e-6 relative plus 2**-7 of the largest
    step and moments within 1e-2 relative plus 1e-5 of the leaf's max, 99.9%
    of them equal."""
    kw = dict(weight_decay=0.1, amsgrad=amsgrad, moments_dtype=moments)
    params, jstate, forms = _run_both_forms(
        JaxAdamW(learning_rate=jax_warmup_cosine(3e-4, 2, 10), **kw),
        AdamW(learning_rate=warmup_cosine(3e-4, 2, 10), **kw))
    fields = ("mu", "nu", "nu_max") if amsgrad else ("mu", "nu")
    _assert_forms_bitwise(forms, fields)
    leaves, state = forms[0]
    want = _flatten(params)
    for k, w in want.items():
        if moments == "float32":
            np.testing.assert_allclose(_stacked(leaves[k]), w, rtol=4e-7, atol=1e-9, err_msg=k)
        else:
            np.testing.assert_allclose(_stacked(leaves[k]), w, rtol=1e-6, atol=2.0 ** -7 * 3e-4,
                                       err_msg=k)
    for f in fields:
        for k, w in _flatten(getattr(jstate, f)).items():
            got = getattr(state, f)[k].float().numpy()
            w = np.asarray(w, np.float32)
            if moments == "float32":
                np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-6 * np.abs(w).max(),
                                           err_msg=f"{f} {k}")
            else:
                assert getattr(state, f)[k].dtype == torch.bfloat16
                np.testing.assert_allclose(got, w, rtol=1e-2, atol=1e-5 * np.abs(w).max(),
                                           err_msg=f"{f} {k}")
                assert (got == w).mean() >= 0.999, (f, k)


def test_adafactor_device_body_is_the_host_float_form_and_jax():
    """Bitwise between the two forms; against JAX, parameters within 4e-7
    relative and the stacked factors within 1e-5 relative, as in
    ``tests/test_torch_training.py``."""
    params, jstate, forms = _run_both_forms(
        JaxAdafactor(learning_rate=jax_warmup_cosine(1e-3, 2, 10), weight_decay=0.1),
        Adafactor(learning_rate=warmup_cosine(1e-3, 2, 10), weight_decay=0.1))
    _assert_forms_bitwise(forms, ("vr", "vc"))
    leaves, state = forms[0]
    for k, w in _flatten(params).items():
        np.testing.assert_allclose(_stacked(leaves[k]), w, rtol=4e-7, atol=1e-9, err_msg=k)
    for f in ("vr", "vc"):
        for k, w in _flatten(getattr(jstate, f)).items():
            got = getattr(state, f)[k].numpy()
            assert got.shape == w.shape, (f, k)
            np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-30, err_msg=f"{f} {k}")


@pytest.mark.parametrize("opt", [AdamW(learning_rate=warmup_cosine(3e-4, 2, 10)),
                                 Adafactor(learning_rate=warmup_cosine(1e-3, 2, 10))])
def test_hyper_is_the_host_step_s_float32_values(opt):
    """The prologue reads the host step only: step k + 1's values, float32,
    the learning rate the schedule's (AdamW's bias corrections with their
    float32 reciprocals, the card's divisor for a host scalar)."""
    leaves = _leaves({"embed": np.zeros((4, 2), np.float32)})
    state = opt.init(leaves)._replace(step=torch.tensor(3, dtype=torch.int32))
    h = opt.hyper(state)
    assert h.dtype == np.float32
    lr = h[0] if isinstance(opt, AdamW) else h[1]
    assert float(lr) == opt.learning_rate(4)
    if isinstance(opt, AdamW):
        assert h[1] == np.float32(1) - np.float32(0.9) ** np.float32(4)
        assert h[2] == np.float32(1) - np.float32(0.999) ** np.float32(4)
        assert (h[3], h[4]) == (np.float32(1) / h[1], np.float32(1) / h[2])
    else:
        assert h[0] == np.float32(1) - np.float32(4) ** np.float32(-0.8)


# -- the compile key against JAX's jit cache --------------------------------------------

VLM = "qwen2-vl-72b"


def _vlm_batches():
    """Two batches of one shape, one of another length, one with the
    patches and positions added: three compile keys."""
    cfg = get_smoke_config(VLM)
    rng = np.random.default_rng(0)
    p = cfg.num_vision_tokens
    grid = (2, p // 2)

    def tokens(n):
        return {k: rng.integers(0, cfg.vocab_size, (2, n)).astype(np.int32)
                for k in ("x_src", "x_tgt")}

    with_extras = tokens(16)
    with_extras["patches"] = (0.1 * rng.standard_normal((2, p, 1280))).astype(np.float32)
    with_extras["positions"] = vlm_positions(2, grid, 16).numpy()
    return [tokens(16), tokens(16), tokens(24), with_extras]


def test_train_step_compile_key_matches_jax_jit_cache():
    """JAX's jitted train step keeps one executable a compile key: after the
    four batches, as many as the port's distinct ``compile_key``s (3). The
    port's jitted step runs them on the CPU as eager steps: no graph."""
    batches = _vlm_batches()
    jcfg = jax_smoke_config(VLM)
    jmodel = jax_build_model(jcfg)
    opt = JaxAdamW(learning_rate=1e-3)
    jstep = jax.jit(jax_make_train_step(jmodel, jcfg, JaxRunConfig(), opt, JaxPath(0.8)))
    jstate = JaxTrainState.create(jmodel.init(jax.random.key(0)), opt)
    for i, b in enumerate(batches):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                          jax.random.key(i))
    keys = {compile_key({k: torch.from_numpy(v) for k, v in b.items()}) for b in batches}
    assert len(keys) == jstep._cache_size() == 3

    model = build_model(get_smoke_config(VLM), device="cpu", seed=0)
    step = jit_train_step(make_train_step(model, model.cfg, RunConfig(),
                                          AdamW(learning_rate=1e-3)))
    state = TrainState.create(model, step.step.optimizer)
    for i, b in enumerate(batches):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()}, prng.key(i))
        assert bool(torch.isfinite(m["loss"]))
    assert int(state.step) == int(state.opt_state.step) == 4
    assert step.graphs.captures == step.graphs.replays == len(step.graphs) == 0


def test_distill_step_compile_key_matches_jax_jit_cache(monkeypatch):
    """``train_distilled``'s jitted step keeps one executable a batch shape
    in JAX: the port's keys over the same batch order are as many (a length
    of 20 rows at batch 16 gives a tail batch of 4: three shapes)."""
    rng = np.random.default_rng(2)
    bufs = {}
    for pkg in (jax_distill, distill):
        bufs[pkg] = pkg.PairBuffer()
    for n, b in [(8, 20), (16, 9)]:
        d = rng.integers(0, 11, (b, n)).astype(np.int32)
        x = np.where(rng.uniform(size=(b, n)) < 0.3, 2, d).astype(np.int32)
        t0 = rng.uniform(0.5, 0.9, b)
        for buf in bufs.values():
            buf.add_batch(d, x, t0)
    jitted = []
    real_jit = jax.jit

    def recording_jit(*a, **kw):
        f = real_jit(*a, **kw)
        jitted.append(f)
        return f

    monkeypatch.setattr(jax, "jit", recording_jit)
    jhead = jax_distill.DistilledRefiner(vocab_size=11)
    jparams = jhead.init(jax.random.key(42))
    host = {k: np.asarray(v) for k, v in jparams.items()}     # JAX's step donates them
    jax_distill.train_distilled(jhead, bufs[jax_distill], key=jax.random.key(0),
                                params=jparams, epochs=2, batch_size=16, seed=4)
    monkeypatch.setattr(jax, "jit", real_jit)
    assert len(jitted) == 1

    batches = list(bufs[distill].batches(16, rng=np.random.default_rng(4)))
    keys = {compile_key({"draft": torch.from_numpy(np.asarray(d, np.int32)),
                         "refined": torch.from_numpy(np.asarray(r, np.int32)),
                         "t0": torch.from_numpy(np.asarray(t, np.float32))})
            for d, r, t in batches}
    assert len(keys) == jitted[0]._cache_size() == 3

    params = jax_distilled_params_to_torch(host, device="cpu")
    made = []
    real = distill.jit_distill_step

    def recording(step):
        made.append(real(step))
        return made[-1]

    monkeypatch.setattr(distill, "jit_distill_step", recording)
    _, rep = distill.train_distilled(distill.DistilledRefiner(vocab_size=11), bufs[distill],
                                     params=params, epochs=2, batch_size=16, seed=4,
                                     device="cpu")
    assert rep.steps == 6 and len(made) == 1
    assert made[0].graphs.captures == len(made[0].graphs) == 0     # eager on the CPU


# -- the jitted step on the CPU -------------------------------------------------------------

def test_jitted_step_on_the_cpu_is_the_eager_step_bitwise():
    """Three steps through ``jit_train_step`` and through the un-jitted step
    from one init (two copies of one seeded model), on the CPU: losses,
    grad norms, weights and AMSGrad moments equal bit for bit; the Trainer's
    step is the wrapper."""
    import copy

    cfg = get_smoke_config("dfm-dit")
    run = RunConfig(t0=0.8, learning_rate=1e-3, warmup_steps=1, total_steps=3)
    base = build_model(cfg, device="cpu", seed=0)
    runs = []
    for jit in (True, False):
        model = copy.deepcopy(base)
        opt = AdamW(learning_rate=warmup_cosine(1e-3, 1, 3), amsgrad=True)
        step = make_train_step(model, cfg, run, opt)
        step = jit_train_step(step) if jit else step
        state = TrainState.create(model, opt)
        rng = np.random.default_rng(3)
        metrics = []
        for i in range(3):
            batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))
                                         .astype(np.int32)) for k in ("x_src", "x_tgt")}
            state, m = step(state, batch, prng.key(i))
            metrics.append((m["loss"], m["grad_norm"]))
        runs.append((metrics, state))
    (ma, sa), (mb, sb) = runs
    for (la, ga), (lb, gb) in zip(ma, mb):
        assert torch.equal(la, lb) and torch.equal(ga, gb)
    for (n, p), q in zip(sa.params.named_parameters(), sb.params.parameters()):
        assert torch.equal(p, q), n
    for f in ("mu", "nu", "nu_max"):
        for k, a in getattr(sa.opt_state, f).items():
            assert torch.equal(a, getattr(sb.opt_state, f)[k]), (f, k)
    assert int(sa.step) == int(sa.opt_state.step) == 3
    trainer = Trainer(build_model(cfg, device="cpu", seed=0), cfg, run)
    assert trainer._step_fn.graphs.stateful and callable(trainer._step_fn.step)


# -- launch counts from a capture's other threads ---------------------------------------------

def test_counting_into_takes_other_threads_launches_on_the_captured_stream():
    """While a capture counts into its tally, a launch from another thread
    goes to the tally when that thread's stream is the captured one (the
    probe: autograd's engine running a backward), and to ``launches``
    otherwise (the scheduler's other thread)."""
    counts.launches.clear()
    tally = collections.Counter()
    captured = threading.local()

    def launch(on_captured_stream):
        captured.on = on_captured_stream
        counts.count("k")

    with counts.counting_into(tally, lambda: getattr(captured, "on", False)):
        counts.count("k")                          # the capturing thread
        for on in (True, False):
            t = threading.Thread(target=launch, args=(on,))
            t.start()
            t.join()
    counts.count("k")                              # after the capture
    assert tally == {"k": 2}
    assert counts.launches == {"k": 2}
    counts.launches.clear()
