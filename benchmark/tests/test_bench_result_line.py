"""The result line: exactly its required keys, and the check last; no
result without a card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run
from benchmark.tests import tiny

REPO = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_untraced_line_has_the_keys_and_the_cells_metrics(tmp_path):
    from flowspec_tpu_torch.utils.profiler import prof
    prof.reset()
    root, bench = tiny.make_root(tmp_path)
    res = run.run_cell("tinyqwen.tinymix", 5, 0.5, False, "cpu", root=root,
                       bench=bench)
    # an untraced run leaves the port's recorder off
    assert not prof.enabled and prof.spans == []
    assert list(res) == KEYS + ["check"]
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m]
    assert set(res["metrics"]) == {m["name"] for m in e2e}
    for m in e2e:
        got = res["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert list(res["check"]) == ["max_gap", "failed", "short"]
    moe = run.run_cell("tinymoe.tinymix", 5, 0.5, False, "cpu", root=root,
                       bench=bench)
    assert list(moe["check"]) == ["decided_mean_gap", "failed", "short"]
    assert all(set(v) == {"value", "limit"} for v in res["check"].values())
    json.dumps(res)


def test_traced_line_adds_the_breakdown():
    reqs = [run.Served(0, 0, [1], 1, [2], 1, 1, 0.0, 1.0)]
    line = run.result_line(True, reqs, {}, {"busy_s": 1.0},
                           {"device_ops": [], "idle_gaps": []},
                           {"max_gap": {"value": 0.0, "limit": 1.0}})
    assert list(line) == KEYS + ["breakdown", "check"]


def test_device_metrics_without_a_card_fail_clearly(tmp_path):
    root, bench = tiny.make_root(tmp_path)
    with pytest.raises(RuntimeError, match="need a CUDA card"):
        run.run_cell("tinyqwen.tinymix", 5, 0.5, True, "cpu", root=root,
                     bench=bench)


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "qwen2-7b-int8.chat", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA card" in out.stderr


def test_no_result_in_a_checkout_without_the_program(tmp_path):
    import shutil
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "qwen2-7b-int8.chat", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
