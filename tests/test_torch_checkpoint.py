"""Checkpoints in both directions between the port and the JAX package:
the port's ``save_checkpoint`` writes what JAX's ``restore_checkpoint``
reads into a JAX ``TrainState`` template, and JAX's checkpoints restore in
the port, leaf for leaf bitwise; both manifests name the same keys,
shapes and dtypes (AdamW with and without AMSGrad, bf16 moments,
Adafactor). JAX restores no bf16 leaf at all (reference fault R6 in
ROADMAP.md), so bf16 moments go from JAX to the port only."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import (
    _flatten, restore_checkpoint as jax_restore, save_checkpoint as jax_save,
)
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import RunConfig as JaxRunConfig
from repro.models import build_model as jax_build_model
from repro.training import Trainer as JaxTrainer, TrainState as JaxTrainState
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.checkpoint.io import flatten
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core.coupling import pair_iterator
from repro_torch.models import build_model
from repro_torch.training import Trainer

ARCH = "dfm-dit"
RUNS = {
    "adamw-amsgrad": dict(),
    "adamw": dict(amsgrad=False),
    "adamw-bf16-moments": dict(moments_dtype="bfloat16"),
    "adafactor": dict(optimizer="adafactor"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread for these smoke-size models: the suite runs in
    several worker processes at once, where torch's default of a thread a
    core makes each small op wait on the others' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pairs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 27, (32, 16)).astype(np.int32),
            rng.integers(0, 27, (32, 16)).astype(np.int32))


def _run_kw(name, tmp_path):
    return dict(batch_size=4, total_steps=2, log_every=1, checkpoint_dir=str(tmp_path),
                **RUNS[name])


def _jax_state(name, tmp_path, steps):
    jcfg = jax_smoke_config(ARCH)
    trainer = JaxTrainer(jax_build_model(jcfg), jcfg, JaxRunConfig(**_run_kw(name, tmp_path)))
    state = trainer.init_state(jax.random.key(0))
    if steps:
        state = trainer.fit(state, pair_iterator(*_pairs(), 4, np.random.default_rng(0)),
                            steps=steps)
    return state


def _port_trainer(name, tmp_path, seed=0):
    model = build_model(get_smoke_config(ARCH), device="cpu", seed=seed)
    return Trainer(model, model.cfg, RunConfig(**_run_kw(name, tmp_path)))


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _assert_flat_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        if w.dtype == jnp.bfloat16:       # as numpy writes it: raw 2-byte records
            w = w.view(np.dtype("V2"))
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.shape, w.shape, g.dtype, w.dtype)
        assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("name", sorted(RUNS))
def test_port_checkpoint_restores_in_jax(name, tmp_path):
    """The port trains two steps and saves; JAX restores the checkpoint into
    its own TrainState template, leaf for leaf bitwise, and the manifest's
    keys, shapes and dtypes equal those of a checkpoint JAX writes."""
    trainer = _port_trainer(name, tmp_path / "port")
    state = trainer.fit(trainer.init_state(), pair_iterator(*_pairs(), 4,
                                                            np.random.default_rng(0)))
    path = save_checkpoint(str(tmp_path / "port"), state, step=int(state.step))
    assert path.endswith("step_00000002") and latest_step(str(tmp_path / "port")) == 2

    template = _jax_state(name, tmp_path / "jax", steps=0)
    jax_path = jax_save(str(tmp_path / "jax"), template, step=0)
    mine, theirs = _manifest(path), _manifest(jax_path)
    assert mine["keys"] == theirs["keys"]
    assert mine["shapes"] == theirs["shapes"] and mine["dtypes"] == theirs["dtypes"]
    assert mine["step"] == 2
    with np.load(os.path.join(path, "arrays.npz")) as a, \
            np.load(os.path.join(jax_path, "arrays.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].dtype == b[k].dtype and a[k].shape == b[k].shape for k in a.files)

    if RUNS[name].get("moments_dtype") == "bfloat16":
        # reference fault R6: JAX restores no bf16 leaf, its own checkpoint's
        # neither; numpy without ml_dtypes reads them back as raw 2-byte records
        for d in (str(tmp_path / "port"), str(tmp_path / "jax")):
            with pytest.raises(ValueError, match="No cast function"):
                jax_restore(d, template)
        return
    restored = jax_restore(str(tmp_path / "port"), template)
    assert isinstance(restored, JaxTrainState) and int(restored.step) == 2
    _assert_flat_equal(_flatten(restored), flatten(state))


@pytest.mark.parametrize("name", sorted(RUNS))
def test_jax_checkpoint_restores_in_port(name, tmp_path):
    """JAX trains two steps and saves; the port restores into a TrainState
    of a differently seeded model, leaf for leaf bitwise (parameters
    stacked back, moments or factors, both steps)."""
    jstate = _jax_state(name, tmp_path, steps=2)
    jax_save(str(tmp_path), jstate, step=2)
    trainer = _port_trainer(name, tmp_path, seed=5)
    template = trainer.init_state()
    restored = restore_checkpoint(str(tmp_path), template)
    assert restored.params is template.params
    _assert_flat_equal(flatten(restored), _flatten(jstate))
    assert int(restored.step) == int(restored.opt_state.step) == 2
    # the restored state trains on
    state = trainer.fit(restored, pair_iterator(*_pairs(1), 4, np.random.default_rng(1)),
                        steps=1)
    assert int(state.step) == 3 and np.isfinite(float(trainer.step_losses[0]))


def test_restore_refuses_a_mismatched_template(tmp_path):
    trainer = _port_trainer("adamw-amsgrad", tmp_path)
    state = trainer.init_state()
    save_checkpoint(str(tmp_path), state, step=7)
    save_checkpoint(str(tmp_path), state, step=3)
    assert latest_step(str(tmp_path)) == 7
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), state)
    other = _port_trainer("adafactor", tmp_path).init_state()
    with pytest.raises(KeyError, match="opt_state|vr"):
        restore_checkpoint(str(tmp_path), other)
    wide = build_model(get_smoke_config(ARCH).replace(d_ff=512), device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), Trainer(wide, wide.cfg, RunConfig()).init_state())
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_trainer_checkpoints_every_n_steps(tmp_path):
    trainer = _port_trainer("adamw-amsgrad", tmp_path)
    state = trainer.fit(trainer.init_state(), pair_iterator(*_pairs(), 4,
                                                            np.random.default_rng(0)),
                        steps=4, checkpoint_every=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000004"]
    restored = restore_checkpoint(str(tmp_path), _port_trainer("adamw-amsgrad", tmp_path,
                                                               seed=9).init_state())
    _assert_flat_equal(flatten(restored), flatten(state))
    with torch.no_grad():
        tok = torch.zeros((2, 16), dtype=torch.int32)
        t = torch.full((2,), 0.9)
        assert torch.equal(restored.params(tok, t), state.params(tok, t))
