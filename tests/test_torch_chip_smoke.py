"""CPU checks of ``chip_smoke.py``'s helpers and of its refusal without a card.

``chip_smoke.py`` imports only torch at module level, so it loads on the CPU;
it lives at the repository root, outside any package, so it is loaded by path.
"""

import importlib.util
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# kernel names as torch.profiler reports them
@pytest.mark.parametrize("name,kind", [
    ("void (anonymous namespace)::post_attn_proj_kernel<32, 1, 128, 0>"
     "((anonymous namespace)::PostArgs)", "post_attn"),
    ("void (anonymous namespace)::post_attn_proj_kernel<64, 1, 128, 0>"
     "((anonymous namespace)::PostArgs)", "post_attn"),
    ("(anonymous namespace)::proj_kernel((anonymous namespace)::ProjArgs)", "head"),
    ("void (anonymous namespace)::head_proj_kernel<1, false>((anonymous namespace)::HeadArgs)",
     "head"),
    ("void (anonymous namespace)::head_proj_kernel<8, true>((anonymous namespace)::HeadArgs)",
     "head"),
    ("void (anonymous namespace)::ws_step_kernel<4>(float const*, int const*, float const*, "
     "int*, int, int, unsigned int, unsigned int, float)", "ws_step"),
    ("void (anonymous namespace)::ws_step_rows_kernel<32>(float const*, int const*, "
     "float const*, long const*, int*, int, int, int, float)", "ws_step_rows"),
    ("void (anonymous namespace)::ws_step_dkey_kernel<8>(float const*, int const*, "
     "float const*, long const*, int*, int, int, float)", "ws_step"),
    ("void (anonymous namespace)::ws_step_gumbel_dkey_kernel<8>(float const*, int const*, "
     "float const*, long const*, int*, int, int, int, int, float)", "ws_step_gumbel"),
    ("void (anonymous namespace)::flash_attn_kernel<64>(float const*, float const*)",
     "flash_attn"),
    ("(anonymous namespace)::qkv_rope_kernel((anonymous namespace)::QkvArgs)", "qkv_rope"),
    ("void (anonymous namespace)::qkv_rope_kernel<64>((anonymous namespace)::QkvArgs)",
     "qkv_rope"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8", "matmul"),
])
def test_profiler_names_map_to_their_kernel(smoke, name, kind):
    assert smoke._category(name) == kind


@pytest.mark.parametrize("name,kind", [
    ("void (anonymous namespace)::flash_attn_kernel<64>(float const*, float const*)",
     "flash_attn"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8", "gemm"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x128_8x4_nn_align1>(Params)", "gemm"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::"
     "(anonymous namespace)::TensorListMetadata<2>, at::native::(anonymous namespace)::"
     "BinaryOpListAlphaFunctor<float, 2, 2, 0>, std::multiplies<float>, float>(...)",
     "foreach (optimizer)"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float, float, float, "
     "at::native::(anonymous namespace)::SoftMaxForwardEpilogue>(float*, float const*, int)",
     "other"),
])
def test_train_profiler_names_map_to_their_kind(smoke, name, kind):
    assert smoke._train_category(name) == kind


def test_train_argv_is_launch_train_at_full_width(smoke):
    """The training phase drives ``launch/train.py`` with its own flags:
    the DiT at full width, 32 x 256, t0 = 0.8, on the card."""
    from repro_torch.launch.train import parse_args

    args = parse_args(smoke.train_argv("ckpt"))
    assert (args.arch, args.smoke, args.t0, args.batch_size, args.seq_len, args.steps,
            args.checkpoint_dir, args.device) == ("dfm-dit", False, smoke.T0, smoke.NUM,
                                                  smoke.SEQ, smoke.TRAIN_STEPS, "ckpt", "cuda")


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN21post_attn_proj_kernelILi32ELi1ELi128ELi0EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN21post_attn_proj_kernelILi32ELi1ELi128ELi0EEEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z17flash_attn_kernelILi128EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z17flash_attn_kernelILi128EEvv
    24 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 416 bytes cmem[0]
"""


@pytest.mark.parametrize("kernel,registers,spill", [
    ("_ZN21post_attn_proj_kernelILi32ELi1ELi128ELi0EEEv", 72, 0),
    ("_Z17flash_attn_kernelILi128EEvv", 255, 20),
])
def test_ptxas_usage_reads_registers_and_spills(smoke, kernel, registers, spill):
    assert smoke.ptxas_usage(PTXAS_LOG)[kernel] == {"spill": spill, "registers": registers}


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No CUDA device here: it exits 2 and prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    run = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 2
    assert '"ok"' not in run.stdout


def test_qkv_rope_ablation_cuts_every_phase_out_of_the_kernel():
    """tools/qkv_rope_ablation.py patches the kernel's source by text: each
    variant's anchors are still in csrc/draft_decode.cu, and each changes it."""
    spec = importlib.util.spec_from_file_location("qkv_rope_ablation",
                                                  ROOT / "tools" / "qkv_rope_ablation.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    text = (ROOT / "src" / "repro_torch" / "csrc" / "draft_decode.cu").read_text()
    assert tool.variant_source(text, "base") == text
    for name in tool.VARIANTS:
        if name != "base":
            assert tool.variant_source(text, name) != text


def test_head_ablation_cuts_every_phase_out_of_the_kernel():
    """tools/head_ablation.py patches the kernel's source by text: each variant's
    anchors are still in csrc/draft_decode.cu, and each changes it."""
    spec = importlib.util.spec_from_file_location("head_ablation",
                                                  ROOT / "tools" / "head_ablation.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    text = (ROOT / "src" / "repro_torch" / "csrc" / "draft_decode.cu").read_text()
    assert tool.variant_source(text, "base") == text
    for name in tool.VARIANTS:
        if name != "base":
            assert tool.variant_source(text, name) != text


def test_attn_cached_ablation_patches_the_kernel_it_times():
    """tools/attn_cached_ablation.py patches the kernel's source by text: each
    variant's anchors are still in csrc/draft_decode.cu, and each changes it."""
    spec = importlib.util.spec_from_file_location("attn_cached_ablation",
                                                  ROOT / "tools" / "attn_cached_ablation.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    text = (ROOT / "src" / "repro_torch" / "csrc" / "draft_decode.cu").read_text()
    for name in tool.VARIANTS:
        patched = tool._runner.variant_source(text, name, tool.VARIANTS)
        assert (patched == text) == (name == "base")


def test_expected_launches_count_a_distilled_micro_batch_as_k_steps(smoke):
    """A distilled micro-batch adds K ws_step_rows launches and no backbone
    (the head is plain PyTorch), twice when its key was captured in the run;
    a guaranteed one n steps of the backbone."""
    report = {"batches": [
        {"bucket_len": 128, "padded_rows": 8, "nfe": 2, "tier": "distilled"},
        {"bucket_len": 128, "padded_rows": 8, "nfe": 2, "tier": "distilled"},
        {"bucket_len": 128, "padded_rows": 8, "nfe": 13, "tier": "guaranteed"}]}
    want = smoke.expected_launches(report, 0, 12, refine_captured={(128, 8, 2, "distilled")},
                                   drafts=[])
    assert (want["ws_step_rows"], want["flash_attn"]) == (2 * 2 + 2 + 13, 13 * 12)


def test_encdec_launches_count_every_attention_and_the_draft_after_r8(smoke):
    """whisper-medium's serve: 72 flash_attn a NFE (24 encoder, 24 self, 24
    cross) and one ws_step; its draft of 256 tokens (``ar_generate`` at
    seq_len 257, R8) the encoder and the cross attention at the prefill, then
    the cross attention of each of 256 decode steps. The smoke config: 2 + 2
    layers."""
    from repro_torch.configs import get_config, get_smoke_config

    refine, draft = smoke.encdec_launches(get_config("whisper-medium"), 13)
    assert refine == {"flash_attn": 13 * 72, "ws_step": 13}
    assert draft == {"flash_attn": 48 + 24 * 256}
    refine, draft = smoke.encdec_launches(get_smoke_config("whisper-medium"), 4, seq=24)
    assert refine == {"flash_attn": 4 * 6, "ws_step": 4}
    assert draft == {"flash_attn": 4 + 2 * 24}


def test_encdec_serve_launches_count_the_first_serve_twice(smoke):
    """A whisper serve is one replay of the refine's graph and one of the
    draft's; the first serve also runs each capture's warm-up, so it counts
    both twice."""
    from repro_torch.configs import get_config

    refine, draft = smoke.encdec_launches(get_config("whisper-medium"), 13)
    one = {"flash_attn": 13 * 72 + 48 + 24 * 256, "ws_step": 13}
    assert smoke.encdec_serve_launches(refine, draft, first=False) == one
    assert smoke.encdec_serve_launches(refine, draft, first=True) == {
        k: 2 * n for k, n in one.items()}


@pytest.mark.parametrize("arch,per_forward", [("zamba2-2.7b", 9), ("xlstm-1.3b", 0),
                                              ("whisper-medium", 72)])
def test_train_zoo_launches_count_every_attention_once_a_forward(smoke, arch, per_forward):
    """A training step launches flash_attn once an attention a forward (the
    backward launches none) and twice under remat (the checkpointed forward
    runs again): zamba2-2.7b's 9 shared-attention positions, whisper's 24
    encoder, 24 self and 24 cross attentions, none in xlstm-1.3b."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    want = {"flash_attn": per_forward} if per_forward else {}
    assert smoke.train_zoo_launches(cfg, False) == want
    assert smoke.train_zoo_launches(cfg, True) == {k: 2 * v for k, v in want.items()}


def test_zero_grad_leaves_are_the_zshared_positions_ln1(smoke):
    """The gradients JAX leaves exactly zero: the ``ln1`` of each of
    zamba2-2.7b's 9 ``zshared`` positions (every sixth layer), none of
    whisper's or xlstm's."""
    from repro_torch.configs import get_config

    leaves = smoke.zero_grad_leaves(get_config("zamba2-2.7b"))
    assert {n for n in leaves if n.endswith(".scale")} == {
        f"blocks.{6 * g + 5}.ln1.scale" for g in range(9)}
    assert not smoke.zero_grad_leaves(get_config("whisper-medium"))
    assert not any(n.endswith(".scale") for n in smoke.zero_grad_leaves(
        get_config("xlstm-1.3b")))


def test_examples_phase_runs_the_readme_torch_snippet_and_every_torch_example(smoke):
    """The snippet ``examples_path`` runs is the README's torch one, on the
    card; it runs all four ``examples/*_torch.py`` and gates NFEs on each."""
    code = smoke.readme_torch_snippet()
    assert 'DEVICE = "cuda"\n' in code and "repro_torch" in code and "jax" not in code
    assert sorted(smoke.EXAMPLES) == sorted(
        p.stem for p in (ROOT / "examples").glob("*_torch.py"))
    assert set(smoke.EXAMPLE_HEADLINES) == set(smoke.EXAMPLE_NFES) == {
        "readme_quickstart_torch", *smoke.EXAMPLES}


def test_graph_equals_eager_gate_holds_bitwise_where_eager_runs_agree(smoke, monkeypatch):
    """``check_graph_equals_eager``: a leaf that two eager runs give bitwise
    must come out of the graph bitwise; a leaf that varies run to run may
    differ within the bound, not beyond it; the losses and grad norms are
    bitwise where nothing varies run to run, else within the relative
    tolerances."""
    import torch

    failed = []
    monkeypatch.setattr(smoke, "fail", failed.append)
    metrics = torch.tensor([[3.0, 1.0], [2.5, 0.5]])
    leaves = {("param", "w"): torch.ones(4), ("mu", "w"): torch.zeros(4)}
    eager = (metrics, leaves)
    again = (metrics.clone(), {**leaves, ("mu", "w"): torch.full((4,), 1e-6)})
    nondet = smoke.run_to_run(eager, again)
    assert nondet == ([], {("mu", "w")})
    graph = (metrics.clone(), {("param", "w"): torch.ones(4), ("mu", "w"): torch.full((4,), 2e-6)})
    res = smoke.check_graph_equals_eager("x", graph, eager, nondet, 1e-5)
    assert not failed and res["bitwise_leaves"] == 1
    assert res["worst_nondet_diff"] == float(torch.tensor(2e-6))
    smoke.check_graph_equals_eager("x", (metrics, {**graph[1], ("mu", "w"): torch.ones(4)}),
                                   eager, nondet, 1e-5)
    assert len(failed) == 1 and "bound" in failed[0]
    off = torch.ones(4)
    off[2] = torch.nextafter(torch.tensor(1.0), torch.tensor(2.0))
    smoke.check_graph_equals_eager("x", (metrics, {**graph[1], ("param", "w"): off}), eager,
                                   nondet, 1e-5)
    assert len(failed) == 2 and "bitwise run to run" in failed[1]
    smoke.check_graph_equals_eager("x", (metrics * (1 + 1e-6), graph[1]), eager, nondet, 1e-5)
    assert len(failed) == 2                        # the step varies: within 1e-4 relative
    smoke.check_graph_equals_eager("x", (metrics * (1 + 1e-3), graph[1]), eager, nondet, 1e-5)
    assert len(failed) == 4 and "step 1" in failed[2]
    smoke.check_graph_equals_eager("x", (metrics + 1e-7, leaves), eager, ([], set()), 1e-5)
    assert len(failed) == 6 and "bitwise run to run" in failed[4]
