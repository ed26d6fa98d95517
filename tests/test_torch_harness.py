"""The port's per-stage benchmark harness (visualslam_tpu_torch/harness.py)
against the JAX package's benchmarks/harness.py: the same rows under the
same result keys, on the CPU at a small image. The JAX harness's keys are
read from its source (running it would rewrite its committed
benchmarks/results.json)."""

import ast
import hashlib
import json
import math
import os

import pytest
import torch

from visualslam_tpu_torch.harness import run_benchmarks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_HARNESS = os.path.join(ROOT, "benchmarks", "harness.py")
JAX_RESULTS = os.path.join(ROOT, "benchmarks", "results.json")


def jax_result_keys() -> set:
    """The keys the JAX harness stores into `results`: its
    results["..."] assignments and the dict _bench_ba returns."""
    tree = ast.parse(open(JAX_HARNESS).read())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Name)
                and node.value.id == "results"
                and isinstance(node.slice, ast.Constant)):
            keys.add(node.slice.value)
        if isinstance(node, ast.FunctionDef) and node.name == "_bench_ba":
            for n in ast.walk(node):
                if isinstance(n, ast.Return) and isinstance(n.value,
                                                            ast.Dict):
                    keys.update(k.value for k in n.value.keys)
    return keys


def _digest(path) -> str:
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    before = _digest(JAX_RESULTS)
    out = tmp_path_factory.mktemp("harness") / "HARNESS_TORCH.json"
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        results = run_benchmarks(device="cpu", h=64, w=96, out=str(out))
    finally:
        torch.set_num_threads(n)
    return results, json.loads(out.read_text()), before


def test_harness_rows_are_the_jax_harness_rows(harness):
    results, written, _ = harness
    keys = jax_result_keys()
    assert len(keys) == 9
    assert set(results) == keys
    # the JAX harness's committed artifact carries the same rows
    assert keys <= set(json.load(open(JAX_RESULTS)))
    assert written["device"] == "cpu" and written["image"] == "64x96"
    assert {k: written[k] for k in keys} == results


def test_harness_rows_are_finite_and_positive(harness):
    results, _, _ = harness
    for k, v in results.items():
        assert math.isfinite(v) and v > 0, (k, v)
    assert results["ba_iters_per_s"] == pytest.approx(
        1000.0 / results["ba_iter_ms"])


def test_harness_leaves_the_jax_results_untouched(harness):
    _, _, before = harness
    assert _digest(JAX_RESULTS) == before


def test_harness_without_a_card_raises(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_benchmarks(out=str(tmp_path / "x.json"))
        assert not (tmp_path / "x.json").exists()
