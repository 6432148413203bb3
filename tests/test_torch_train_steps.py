"""Training the port's families past one gradient, against the JAX package
on the CPU (the smoke configs and weights of ``test_torch_train_families``):
three ``make_train_step`` steps (AdamW with AMSGrad, remat) against JAX's for
a recurrent arch and for whisper with its frames; ``TrainState``
checkpoints of each trained family restored bitwise in the other package,
both ways (the stacked ``stack|blocks|p{i}|…``, ``stack|zshared|…``,
``enc_blocks|…`` and ``dec_blocks|…`` leaves); ``Trainer.fit`` and
``launch.train`` on the recurrent family; reference fault R9 pinned on
both sides: JAX's trainer has no frames for the encoder-decoder.
Tolerances are stated where they are used.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _flatten
from repro.checkpoint.io import restore_checkpoint as jax_restore
from repro.checkpoint.io import save_checkpoint as jax_save
from repro.configs.base import RunConfig as JaxRunConfig
from repro.launch import train as jax_launch_train
from repro.optim import build_optimizer as jax_build_optimizer
from repro.training import TrainState as JaxTrainState
from repro.training import make_train_step as jax_make_train_step
from repro_torch import prng
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.checkpoint.io import flatten
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core.coupling import pair_iterator
from repro_torch.core.paths import WarmStartPath
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.optim import build_optimizer
from repro_torch.training import Trainer, TrainState, make_loss_fn, make_train_step
from test_torch_train_families import ARCHS, _model, _setup


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread for these smoke-size models: the suite runs in
    several worker processes at once, where torch's default of a thread a
    core makes each small op wait on the others' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(arch, **kw):
    return RunConfig(arch=arch, t0=0.8, learning_rate=1e-3, warmup_steps=1, total_steps=3,
                     remat="block", **kw)


@functools.lru_cache(maxsize=None)
def _three_steps(arch, with_jax):
    """Three ``make_train_step`` steps (AdamW with AMSGrad, weight decay,
    clipping, remat) on the port, and on JAX when ``with_jax``, from the
    same weights, batch and keys 0, 1, 2. Returns (port state, port
    metrics, JAX state, JAX metrics)."""
    jm, params, jbatch, tbatch = _setup(arch)
    model = _model(arch)
    run = _run(arch)
    opt = build_optimizer(run)
    step = make_train_step(model, model.cfg, run, opt)
    state = TrainState.create(model, opt)
    metrics = []
    for i in range(3):
        state, m = step(state, tbatch, prng.key(i))
        metrics.append({k: float(v) for k, v in m.items()})
    if not with_jax:
        return state, metrics, None, None
    jrun = JaxRunConfig(**{f: getattr(run, f) for f in (
        "arch", "t0", "learning_rate", "warmup_steps", "total_steps", "remat")})
    jopt = jax_build_optimizer(jrun)
    jstep = jax.jit(jax_make_train_step(jm, jm.cfg, jrun, jopt))
    jstate = JaxTrainState.create(params, jopt)
    jmetrics = []
    for i in range(3):
        jstate, m = jstep(jstate, jbatch, jax.random.key(i))
        jmetrics.append({k: float(v) for k, v in m.items()})
    return state, metrics, jstate, jmetrics


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "whisper-medium"])
def test_three_train_steps_match_jax(arch):
    """Each step's loss, CE and grad norm within 1e-5 relative, t_mean
    exact. The parameters after three steps: every element within 2 x the
    sum of the learning rates (AdamW moves an element about lr a step, and
    where a gradient is at float32's rounding its normalised step follows
    the rounding) and 99.9% of each leaf's elements within 1e-4 of its
    max |p|."""
    state, metrics, jstate, jmetrics = _three_steps(arch, True)
    for m, jm in zip(metrics, jmetrics):
        assert set(m) == set(jm)
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(m[k], jm[k], rtol=1e-5, err_msg=k)
        assert m["t_mean"] == jm["t_mean"]
    assert int(state.step) == int(jstate.step) == 3
    bound = 2 * sum(build_optimizer(_run(arch)).learning_rate(i) for i in (1, 2, 3))
    got, want = flatten(state), _flatten(jstate)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if not k.startswith("params|"):
            continue
        diff = np.abs(got[k] - w)
        assert diff.max() <= bound, (k, diff.max(), bound)
        assert (diff <= 1e-4 * np.abs(w).max()).mean() >= 0.999, k


@pytest.mark.parametrize("arch", ARCHS)
def test_trained_checkpoints_restore_bitwise_across_the_packages(arch, tmp_path):
    """The port's state after three steps (params, AdamW's mu, nu and
    nu_max, the steps), saved by the port and restored by JAX into its own
    ``TrainState`` template, then saved by JAX and restored by the port
    into a fresh template: every leaf bitwise, keys, shapes and dtypes
    equal; the stacked leaves keep their layer order."""
    jm, params, _, _ = _setup(arch)
    state = _three_steps(arch, False)[0]
    mine = flatten(state)
    save_checkpoint(str(tmp_path / "port"), state, step=3)
    jopt = jax_build_optimizer(JaxRunConfig(**{f: getattr(_run(arch), f) for f in (
        "arch", "learning_rate", "warmup_steps", "total_steps")}))
    jstate = jax_restore(str(tmp_path / "port"), JaxTrainState.create(params, jopt))
    theirs = _flatten(jstate)
    assert sorted(theirs) == sorted(mine)
    for k, a in mine.items():
        assert theirs[k].dtype == a.dtype and theirs[k].tobytes() == a.tobytes(), k
    stacked = [k for k in mine if k.startswith(("params|stack|blocks|", "params|enc_blocks|",
                                                "opt_state|mu|dec_blocks|",
                                                "params|stack|zshared|"))]
    assert stacked

    jax_save(str(tmp_path / "jax"), jstate, step=3)
    model = build_model(get_smoke_config(arch), device="cpu", seed=5)
    opt = build_optimizer(_run(arch))
    back = restore_checkpoint(str(tmp_path / "jax"), TrainState.create(model, opt))
    again = flatten(back)
    assert sorted(again) == sorted(mine)
    for k, a in mine.items():
        assert again[k].dtype == a.dtype and again[k].tobytes() == a.tobytes(), k


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-1.3b"])
def test_trainer_and_launcher_train_the_recurrent_family(arch, tmp_path):
    """``Trainer.fit`` (remat on) and ``launch.train.main`` take finite
    steps on the recurrent smoke configs and save a checkpoint."""
    model = build_model(get_smoke_config(arch), device="cpu")
    run = RunConfig(arch=arch, batch_size=2, total_steps=2, log_every=1, remat="block")
    trainer = Trainer(model, model.cfg, run)
    data = np.random.default_rng(0).integers(0, 512, (8, 16)).astype(np.int32)
    state = trainer.fit(trainer.init_state(),
                        pair_iterator(data[::-1].copy(), data, 2, np.random.default_rng(1)))
    assert int(state.step) == 2 and [i for i, _ in trainer.history] == [1, 2]
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
               for _, m in trainer.history)
    _, state, path = launch_train.main(
        ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "1", "--batch-size", "2",
         "--seq-len", "16", "--checkpoint-dir", str(tmp_path)])
    assert int(state.step) == 1 and path.endswith("step_00000001")


def test_r9_jax_trainer_has_no_frames_for_the_encoder_decoder(monkeypatch, tmp_path):
    """Reference fault R9: JAX's launcher (through ``Trainer.fit``, which
    builds batches of ``x_src``/``x_tgt`` only) fails at whisper's first
    step with ``KeyError: 'frames'``."""
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "whisper-medium", "--smoke", "--steps", "1", "--batch-size", "2",
        "--seq-len", "16", "--checkpoint-dir", str(tmp_path)])
    with pytest.raises(KeyError, match="frames"):
        jax_launch_train.main()


def test_r9_the_port_names_frames_before_the_first_step(tmp_path):
    """The port keeps R9's semantics (no frames are invented) and raises a
    ValueError naming ``frames`` before any step, in ``Trainer.fit`` and in
    the launcher; ``make_train_step`` with frames in the batch trains it
    (above), and a decoder-only model refuses frames by name."""
    model = _model("whisper-medium")
    trainer = Trainer(model, model.cfg, RunConfig(batch_size=2, total_steps=1))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="'frames'"):
        trainer.fit(trainer.init_state(), iter(()))
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())
    with pytest.raises(ValueError, match="'frames'"):
        launch_train.main(["--arch", "whisper-medium", "--smoke", "--device", "cpu",
                           "--steps", "1", "--checkpoint-dir", str(tmp_path)])
    dec = build_model(get_smoke_config("zamba2-2.7b"), device="cpu")
    batch = dict(_setup("whisper-medium")[3])
    with pytest.raises(NotImplementedError, match="frames"):
        make_loss_fn(dec, dec.cfg, WarmStartPath(0.8))(dec, batch, prng.key(0))
