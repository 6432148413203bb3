"""The README's torch quickstart and the four ``examples/*_torch.py`` on the
CPU (``device="cpu"``: the kernels' plain versions):

- the torch snippet (between the ``quickstart-torch`` markers) runs with
  ``DEVICE = "cpu"``, its own NFE and batch == stream assertions holding;
  then its requests, served on the JAX snippet's params carried into its
  model, give the tokens of the JAX snippet's batch results;
- each torch example runs with ``--device cpu`` and a few ``--steps``, its
  evaluation and pair counts cut by their module constants, and prints the
  NFEs its JAX twin guarantees (``repro.core.guarantees.warm_nfe``).
"""

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from repro.checkpoint.io import _flatten
from repro.core.guarantees import warm_nfe as jax_warm_nfe
from repro_torch.convert import jax_params_to_torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FENCE = re.compile(r"```python\n(.*?)```", re.DOTALL)


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread for these smoke-size models: the suite runs in
    several worker processes at once, where torch's default of a thread a
    core makes each small op wait on the others' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _snippet(begin: str, end: str) -> str:
    text = (ROOT / "README.md").read_text(encoding="utf-8")
    region = text.split(begin, 1)[1].split(end, 1)[0]
    return FENCE.search(region).group(1)


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_readme_torch_snippet_runs_on_the_cpu_and_matches_the_jax_snippet(capsys):
    code = _snippet("<!-- quickstart-torch:begin -->", "<!-- quickstart-torch:end -->")
    assert code.count('DEVICE = "cuda"\n') == 1 and "is_available" not in code
    ns: dict = {}
    exec(compile(code.replace('DEVICE = "cuda"\n', 'DEVICE = "cpu"\n'), "readme_torch", "exec"),
         ns)
    out = capsys.readouterr().out
    assert "batch: 6 requests" in out and out.count("streamed [") == 6
    assert ns["model"].device.type == "cpu"

    # the JAX snippet's batch half (its stream half repeats the same tokens)
    extract = _load(ROOT / "tools" / "extract_readme_snippet.py", "extract_readme_snippet")
    jax_code = extract.extract(ROOT / "README.md")
    batch_half = jax_code.split("# 2. streaming", 1)[0]
    assert batch_half != jax_code
    jns: dict = {}
    exec(compile(batch_half, "readme_jax", "exec"), jns)
    ns["model"].load_state_dict(jax_params_to_torch(_flatten(jns["params"])), strict=True)
    results, _ = ns["make_scheduler"]().serve_requests(ns["requests"])
    assert sorted(results) == sorted(jns["results"])
    for rid, want in jns["results"].items():
        assert results[rid].nfe == want.nfe == jax_warm_nfe(16, 0.8)
        np.testing.assert_array_equal(results[rid].tokens, np.asarray(want.tokens))


def _capped_oracle(base):
    class CappedOracle(base):
        """Reference fault R5: ``WordOracle`` raises on a fragment longer
        than its corpus's longest word, which an LSTM trained a few steps
        drafts; the fragment is cut to that length here."""

        def _nearest_word(self, frag):
            return super()._nearest_word(frag[:self.maxlen])

    return CappedOracle


# name, --steps, module constants cut for the CPU, the NFEs printed (a regex
# each, its groups the numbers) and the guaranteed NFEs they must equal
EXAMPLES = {
    "quickstart_torch": (
        "2", {"EVAL": 256},
        [(r"cold DFM: .* cold_nfe=(\d+) warm_nfe=(\d+)", (20, jax_warm_nfe(20, 0.0))),
         (r"WS-DFM: .* cold_nfe=(\d+) warm_nfe=(\d+)", (20, jax_warm_nfe(20, 0.8)))]),
    "serve_pipeline_torch": (
        "2", {"LSTM_STEPS": 2},
        [(r"request batch \d \(n=\d+\): nfe=(\d+)/(\d+)", (jax_warm_nfe(40, 0.8), 40))] * 3
        + [(r"nfe=(\d+) t0=0.9 bucket", (jax_warm_nfe(40, 0.9),)),
           (r"nfe=(\d+) t0=0.8 bucket", (jax_warm_nfe(40, 0.8),)),
           (r"t0=0.8 would cost (\d+)", (jax_warm_nfe(40, 0.8),))]),
    "text_generation_torch": (
        "2", {"EVAL": 4, "PAIRS": 64, "FINETUNE_MIN": 2},
        [(r"cold DFM .* NFE=(\d+)", (64,)),
         (r"WS-DFM .* NFE=(\d+)", (jax_warm_nfe(64, 0.8),))]),
    "image_refinement_torch": (
        "2", {"EVAL": 8, "PAIRS": 64},
        [(r"cold  FID-proxy: [-\d.]+  NFE=(\d+)", (48,)),
         (r"warm  FID-proxy: [-\d.]+  NFE=(\d+)", (jax_warm_nfe(48, 0.5),))]),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_torch_example_runs_on_the_cpu_with_its_twins_nfe(name, monkeypatch, capsys):
    steps, cuts, wants = EXAMPLES[name]
    module = _load(ROOT / "examples" / f"{name}.py", name)
    for const, value in cuts.items():
        assert hasattr(module, const), const
        monkeypatch.setattr(module, const, value)
    if hasattr(module, "WordOracle"):
        monkeypatch.setattr(module, "WordOracle", _capped_oracle(module.WordOracle))
    module.main(["--device", "cpu", "--steps", steps])
    out = capsys.readouterr().out
    found = {}
    for pattern, want in wants:
        matches = found.setdefault(pattern, re.findall(pattern, out))
        assert matches, (pattern, out[-2000:])
        got = matches.pop(0)
        got = tuple(int(x) for x in ((got,) if isinstance(got, str) else got))
        assert got == want, (pattern, got, want)
