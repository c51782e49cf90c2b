"""Every part of a cell is found by name, and a configuration, a mix or a
metric is added with new files and entries alone."""

import json

import pytest

from benchmark import run
from benchmark.lib import spec
from benchmark.tests import tiny


def test_every_cell_finds_its_parts():
    bench = spec.load_benchmark()
    for c in bench["configs"]:
        cfg = spec.config(c["name"])
        assert cfg["name"] == c["name"]
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        for key in cfg["reduced"]:
            assert cfg["published"][key] != cfg[key]
        spec.family(cfg["family"])
    for w in bench["workloads"]:
        spec.config(w["config"])
        spec.mix(w["traffic"])
        lim = spec.limits(w["name"])
        assert {"failed", "short"} < set(lim["limits"])
        assert set(lim["limits"]) - {"failed", "short"} <= {
            "max_gap", "decided_mean_gap"}
        if "decided_mean_gap" in lim["limits"]:
            assert lim["router_margin"] > 0
        for traced in (False, True):
            for m in spec.metrics_of(bench, w["name"], traced):
                assert callable(spec.reader(m["name"]))


def test_metrics_of_a_cell():
    bench = spec.load_benchmark()
    e2e = [m["name"] for m in spec.metrics_of(bench, "qwen2-7b-int8.chat",
                                              False)]
    assert e2e == ["tok_s", "ms_per_token_p50", "ms_per_token_p95",
                   "setup_s"]
    qwen = {m["name"] for m in spec.metrics_of(bench, "qwen2-7b-int8.chat",
                                               True)}
    moe = {m["name"] for m in spec.metrics_of(
        bench, "mixtral-8x7b-bf16-16l.chat", True)}
    assert moe - qwen == {"moe_roofline"}
    assert all(m["moves"] == "tok_s" for m in bench["per_layer"])


def test_missing_parts_name_what_is_missing(tmp_path):
    with pytest.raises(FileNotFoundError, match="configuration"):
        spec.config("no-such-model", tmp_path)
    with pytest.raises(FileNotFoundError, match="metric 'nope'"):
        spec.reader("nope", tmp_path)
    with pytest.raises(KeyError, match="no workload"):
        spec.cell(spec.load_benchmark(), "no.such")


def test_a_cell_added_as_files_alone(tmp_path):
    """A new configuration, mix, end-to-end metric and per-layer metric in
    a folder of their own, named in the benchmark's entries, with no edit
    to a file that is there."""
    root, bench = tiny.make_root(tmp_path)
    mix = json.loads((root / "traffic" / "tinymix.json").read_text())
    mix.update(name="tinylong", block=2,
               prompt_tokens=[60, 90, 120])
    (root / "traffic" / "tinylong.json").write_text(json.dumps(mix))
    (root / "limits" / "tinyqwen.tinylong.json").write_text(
        json.dumps(tiny.LIMITS["tinyqwen"]))
    (root / "metrics" / "prompt_tokens_s.py").write_text(
        "def read(run):\n"
        "    return sum(r.prompt_len for r in run.requests) / run.window_s\n")
    (root / "metrics" / "rounds_per_request.py").write_text(
        "def read(run):\n"
        "    return sum(r.rounds for r in run.traced) / len(run.traced)\n")
    bench["workloads"].append({"name": "tinyqwen.tinylong",
                               "config": "tinyqwen", "traffic": "tinylong",
                               "chips": 1, "why": "a test's size"})
    bench["end_to_end"].append({"name": "prompt_tokens_s",
                                "unit": "tokens/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["tinyqwen.tinylong"]})
    bench["per_layer"].append({"name": "rounds_per_request",
                               "unit": "rounds", "better": "lower",
                               "source": "program_counter", "layer": "request",
                               "moves": "tok_s"})
    res = run.run_cell("tinyqwen.tinylong", 9, 0.3, False, "cpu", root=root,
                       bench=bench)
    assert res["correct"]
    assert res["metrics"]["prompt_tokens_s"]["value"] > 0
    traced = [m["name"] for m in spec.metrics_of(bench, "tinyqwen.tinylong",
                                                 True)]
    assert "rounds_per_request" in traced
    reqs = [run.Served(0, 0, [1] * 4, 3, [2] * 3, 3, 1, 0.0, 1.0)]
    r = run.Run(cfg={}, mix={}, dims=None, requests=reqs, window_s=1.0,
                setup_s=1.0, traced=reqs)
    assert spec.reader("rounds_per_request", root)(r) == 3
    # the cells that were there read only their own metrics
    other = run.run_cell("tinyqwen.tinymix", 9, 0.3, False, "cpu",
                         root=root, bench=bench)
    assert "prompt_tokens_s" not in other["metrics"]
