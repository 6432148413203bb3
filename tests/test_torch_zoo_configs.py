"""The dense zoo's configs and weights in the port against the JAX package's:
the registry (``get_config``, ``get_smoke_config``, ``list_archs``), every
config field of the four archs, which configs the model and the draft
kernels take, and the JAX parameter tree converted both ways, bitwise."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _flatten
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.kernels import draft_decode_supported as jax_draft_decode_supported
from repro.models import build_model as jax_build_model
from repro_torch import configs as registry
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.convert import jax_leaves, jax_params_to_torch, torch_params_to_jax
from repro_torch.kernels.draft_decode import draft_decode_supported
from repro_torch.models import EncDecModel, Model, build_model
from repro_torch.models.encdec import check_encdec_supported
from repro_torch.models.model import check_supported, layer_kinds

ZOO = ("starcoder2-3b", "minitron-4b", "command-r-plus-104b", "gemma3-1b")
NOT_PORTED: dict = {}                       # the VLM family was the last one
RECURRENT = ("zamba2-2.7b", "xlstm-1.3b")   # ported since the recurrent family
ENCDEC = ("whisper-medium",)                # ported since the encoder-decoder family
MOE = ("arctic-480b",)                      # ported since the MoE family
MLA = ("deepseek-v3-671b",)                 # ported since the MLA family
VLM = ("qwen2-vl-72b",)                     # ported since the VLM family


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
@pytest.mark.parametrize("arch", ZOO)
def test_config_fields_equal_jax(arch, which):
    jax_fn, fn = ((jax_get_config, get_config) if which == "full"
                  else (jax_get_smoke_config, get_smoke_config))
    want, got = jax_fn(arch), fn(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.scan_split() == want.scan_split() and got.head_dim == want.head_dim


def test_registry_lists_the_port_and_names_what_is_missing():
    """arctic-480b is listed and builds since the MoE family, deepseek-v3
    since the MLA family, qwen2-vl-72b since the VLM family: nothing of
    the JAX zoo is left unported, and an unknown id raises."""
    assert registry._NOT_PORTED == NOT_PORTED == {}
    assert list_archs() == sorted(ZOO + RECURRENT + ENCDEC + MOE + MLA + VLM + ("dfm-dit",))
    for arch in MOE + MLA:
        assert get_config(arch).family == get_smoke_config(arch).family == "moe"
    for arch in MLA:
        assert get_config(arch).mla is not None and get_smoke_config(arch).mla is not None
        check_supported(get_smoke_config(arch))
    for arch in VLM:
        assert get_config(arch).family == get_smoke_config(arch).family == "vlm"
        check_supported(get_smoke_config(arch))
        assert isinstance(build_model(get_smoke_config(arch), device="cpu"), Model)
    with pytest.raises(KeyError):
        get_config("gpt-2")


@pytest.mark.parametrize("which", ["full", "smoke"])
@pytest.mark.parametrize("arch", ENCDEC)
def test_encdec_config_builds_from_the_registry(arch, which):
    """whisper-medium's full and smoke configs from the registry equal JAX's
    field for field, build an ``EncDecModel`` (the full one in float32; its
    bfloat16 default is refused) and are refused by the decoder-only model
    and the draft kernels, as JAX's ``draft_decode_supported`` refuses them."""
    jax_fn, fn = ((jax_get_config, get_config) if which == "full"
                  else (jax_get_smoke_config, get_smoke_config))
    want, got = jax_fn(arch), fn(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.is_encoder_decoder and got.num_audio_frames == (1500 if which == "full" else 32)
    check_encdec_supported(got.replace(dtype="float32"))
    if which == "full":
        with pytest.raises(NotImplementedError, match="dtype"):
            check_encdec_supported(got)
    else:
        assert isinstance(build_model(got, device="cpu"), EncDecModel)
    with pytest.raises(NotImplementedError, match="family"):
        check_supported(got)
    assert not draft_decode_supported(got) and not jax_draft_decode_supported(got)


@pytest.mark.parametrize("arch", ZOO)
def test_model_and_draft_kernels_take_what_jax_takes(arch):
    """The port's model builds every zoo config in float32 (the full configs
    default to bfloat16, which it refuses); the draft kernels take exactly
    the configs JAX's ``draft_decode_supported`` takes."""
    for cfg in (get_smoke_config(arch), get_config(arch).replace(dtype="float32")):
        check_supported(cfg)
        assert draft_decode_supported(cfg) == jax_draft_decode_supported(cfg)
        assert draft_decode_supported(cfg) == (arch != "gemma3-1b")
    with pytest.raises(NotImplementedError, match="dtype"):
        check_supported(get_config(arch))
    kinds = layer_kinds(get_config(arch))
    assert len(kinds) == get_config(arch).num_layers
    if arch == "gemma3-1b":     # 4 repeats of 5 local + 1 global, then 2 local
        assert kinds == (("local",) * 5 + ("attn",)) * 4 + ("local", "local")


def test_check_supported_refuses_the_rest_of_the_zoo():
    """What stays refused: the MoE family or an MoE kind without experts,
    the ``shardmap`` dispatch, an MLA kind without ``cfg.mla``, the
    softcap, bfloat16, M-RoPE sections that do not fill head_dim / 2 and an
    encoder-decoder config. The VLM family and M-RoPE are taken since the
    VLM family."""
    cfg = get_smoke_config("gemma3-1b")
    moe = get_smoke_config("arctic-480b")
    for bad in (cfg.replace(family="moe"), cfg.replace(pattern=("moe",)),
                moe.replace(moe=dataclasses.replace(moe.moe, dispatch_impl="shardmap")),
                cfg.replace(prefix=("mla",)), cfg.replace(attn_logit_softcap=50.0),
                cfg.replace(dtype="bfloat16"),
                cfg.replace(rope_type="mrope", mrope_sections=(1, 1, 1)),
                cfg.replace(is_encoder_decoder=True)):
        with pytest.raises(NotImplementedError):
            check_supported(bad)
    check_supported(moe)
    half = cfg.head_dim // 2
    check_supported(cfg.replace(family="vlm"))
    check_supported(cfg.replace(rope_type="mrope", mrope_sections=(half - 2, 1, 1)))


@pytest.mark.parametrize("arch", ZOO + ("prefix",))
def test_weights_convert_both_ways_bitwise(arch):
    """JAX leaves -> state dict -> JAX leaves, bitwise: qk-norm, the
    post-norms, gemma3's six stacked positions p0-p5 and (``prefix``: a
    starcoder2 smoke config with a local prefix layer and a remainder) the
    ``stack|pre`` and ``stack|rem`` leaves."""
    cfg = (get_smoke_config("starcoder2-3b").replace(prefix=("local",), num_layers=4,
                                                     pattern=("attn", "local"))
           if arch == "prefix" else get_smoke_config(arch))
    params = jax_build_model(cfg).init(jax.random.key(2))
    flat = _flatten(params)
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
    if arch == "gemma3-1b":
        assert {f"stack|blocks|p{p}|attn|qnorm|scale" for p in range(6)} <= set(flat)
        assert "stack|blocks|p5|post_ffn|scale" in flat
    if arch == "prefix":
        assert "stack|pre|x0|attn|wq|w" in flat and "stack|rem|r0|attn|wq|w" in flat
        np.testing.assert_array_equal(sd["blocks.0.attn.wq.w"].numpy(),
                                      flat["stack|pre|x0|attn|wq|w"])
        np.testing.assert_array_equal(sd["blocks.3.attn.wq.w"].numpy(),
                                      flat["stack|rem|r0|attn|wq|w"])
