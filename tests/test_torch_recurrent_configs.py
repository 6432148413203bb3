"""The recurrent family's configs and weights in the port against the JAX
package's: the registry, every field of zamba2-2.7b and xlstm-1.3b (full and
smoke), which configs the model takes, the JAX parameter tree converted both
ways bitwise (Mamba2, mLSTM and sLSTM leaves, Zamba2's shared block and its
per-layer ``fuse`` and unused ``ln1``) in JAX's leaf order, and a checkpoint
of the parameters written by either package restored by the other."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _flatten
from repro.checkpoint.io import restore_checkpoint as jax_restore
from repro.checkpoint.io import save_checkpoint as jax_save
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import build_model as jax_build_model
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.convert import jax_leaves, jax_params_to_torch, torch_params_to_jax
from repro_torch.models import Model
from repro_torch.models.model import check_supported, layer_kinds

ARCHS = ("zamba2-2.7b", "xlstm-1.3b")


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread for these smoke-size models: the suite runs in
    several worker processes at once, where torch's default of a thread a
    core makes each small op wait on the others' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("which", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_jax(arch, which):
    jax_fn, fn = ((jax_get_config, get_config) if which == "full"
                  else (jax_get_smoke_config, get_smoke_config))
    want, got = jax_fn(arch), fn(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.ssm) == dataclasses.asdict(want.ssm)
    assert got.scan_split() == want.scan_split() and got.head_dim == want.head_dim


def test_registry_holds_the_recurrent_family():
    assert set(ARCHS) <= set(list_archs())
    assert layer_kinds(get_config("zamba2-2.7b")) == (("mamba",) * 5 + ("zshared",)) * 9
    assert layer_kinds(get_config("xlstm-1.3b")) == (("mlstm",) * 7 + ("slstm",)) * 6


@pytest.mark.parametrize("arch", ARCHS)
def test_model_takes_the_family_in_float32(arch):
    """The smoke configs and the full configs at float32 pass; the full
    configs' own bfloat16 activations are refused, as for the dense zoo."""
    check_supported(get_smoke_config(arch))
    check_supported(get_config(arch).replace(dtype="float32"))
    with pytest.raises(NotImplementedError, match="dtype"):
        check_supported(get_config(arch))


def _params(arch, seed=2):
    return jax_build_model(jax_get_smoke_config(arch)).init(jax.random.key(seed))


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_convert_both_ways_bitwise(arch):
    """JAX leaves -> state dict -> JAX leaves, bitwise and in JAX's leaf
    order; the shared block once, under ``zshared``."""
    cfg = get_smoke_config(arch)
    flat = _flatten(_params(arch))
    sd = jax_params_to_torch(flat)
    model = Model(cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    model.load_state_dict(sd, strict=True)
    back = torch_params_to_jax(model.state_dict(), cfg)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype
    assert list(jax_leaves(model)) == list(flat)
    if arch == "zamba2-2.7b":
        shared = {k for k in flat if k.startswith("stack|zshared|")}
        assert {"stack|zshared|attn|wq|w", "stack|zshared|mlp|gate|w",
                "stack|zshared|ln1|scale", "stack|zshared|ln2|scale"} <= shared
        assert {k.replace("stack|", "", 1).replace("|", ".") for k in shared} <= set(sd)
        np.testing.assert_array_equal(sd["blocks.5.fuse.w"].numpy(),
                                      flat["stack|blocks|p5|fuse|w"][0])
        # every layer keeps an ln1, the zshared layers' never read
        assert "stack|blocks|p5|ln1|scale" in flat and "blocks.5.ln1.scale" in sd
        np.testing.assert_array_equal(sd["blocks.0.mamba.a_log"].numpy(),
                                      np.log(np.arange(1, 9, dtype=np.float32)))
        assert len(jax_leaves(model)["stack|zshared|attn|wq|w"]) == 1
    else:
        assert flat["stack|blocks|p0|mlstm|wq"].shape == (1, 4, 64, 64)
        assert flat["stack|blocks|p7|slstm|r_gates"].shape == (1, 4, 4, 32, 32)
        np.testing.assert_array_equal(sd["blocks.7.slstm.r_gates"].numpy(),
                                      flat["stack|blocks|p7|slstm|r_gates"][0])


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_round_trips_between_the_packages(arch, tmp_path):
    """The port writes ``{"params": model}`` as JAX writes ``{"params":
    params}``: the same manifest (keys, shapes, dtypes) and arrays; each
    package restores the other's checkpoint bitwise."""
    cfg = get_smoke_config(arch)
    params = _params(arch, seed=5)
    model = Model(cfg, device="cpu", seed=9)
    model.load_state_dict(jax_params_to_torch(_flatten(params)), strict=True)
    mine = save_checkpoint(str(tmp_path / "port"), {"params": model}, 3)
    theirs = jax_save(str(tmp_path / "jax"), {"params": params}, 3)
    assert _manifest(mine) == _manifest(theirs)
    back = jax_restore(str(tmp_path / "port"), {"params": params})
    for (path, want), (_, got) in zip(jax.tree_util.tree_leaves_with_path(params),
                                      jax.tree_util.tree_leaves_with_path(back["params"])):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=str(path))
    other = Model(cfg, device="cpu", seed=10)
    restore_checkpoint(str(tmp_path / "jax"), {"params": other})
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
