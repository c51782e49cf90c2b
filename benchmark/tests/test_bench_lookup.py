"""Every part of a cell is found by name, and a configuration, a mix or a
metric is added with new files and entries alone."""

import json

import pytest

from benchmark import run
from benchmark.lib import spec, trace
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
    """An untraced run reports the end-to-end metrics that name the cell or
    no cell; a traced run the per-layer metrics that name it, or that name
    no cell and move one of those."""
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        def applies(m):
            return w["name"] in m.get("workloads", [w["name"]])
        e2e = spec.metrics_of(bench, w["name"], False)
        assert e2e == [m for m in bench["end_to_end"] if applies(m)]
        moved = {m["name"] for m in e2e}
        traced = spec.metrics_of(bench, w["name"], True)
        assert traced == [m for m in bench["per_layer"] if applies(m) and (
            "workloads" in m or m["moves"] in moved)]
        assert all(m["moves"] in moved for m in traced)
    qwen = {m["name"] for m in spec.metrics_of(bench, "qwen2-7b-int8.chat",
                                               True)}
    moe = {m["name"] for m in spec.metrics_of(
        bench, "mixtral-8x7b-bf16-16l.chat", True)}
    assert moe - qwen == {"moe_roofline"}
    assert {"round_device_ms", "round_gap_us", "prefill_ms_per_chunk",
            "grow_ms", "capture_s"} <= qwen


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


HALF_FAMILY = '''"""Qwen2 with each layer's MLP output times 0.5: the port serves
it with w_down's column scales halved (the same product)."""

from benchmark.families import qwen2

model_config, draw, draft = qwen2.model_config, qwen2.draw, qwen2.draft
{reference}KERNEL_FAMILIES = (("halfmlp_gemm", "half_mlp"),)


def port_params(w):
    down = w["layers"]["w_down"]
    return qwen2.port_params(dict(w, layers=dict(
        w["layers"], w_down=dict(down, scale=down["scale"] * 0.5))))


class Work:
    def attention_bound_s(self, reqs):
        return 5e-7 * len(reqs)

    def int8_bound_s(self, reqs):
        return None


def work(cfg, mix):
    return Work()
'''
HALF_REFERENCE = '''"""The decoder reference with each layer's MLP output times 0.5."""

from benchmark.reference import decoder


def next_token_logits(w, cfg, seqs, rows, weight, dtype, margins):
    down = w["layers"]["w_down"]
    half = dict(w, layers=dict(w["layers"], w_down=dict(
        down, scale=down["scale"] * 0.5)))
    return decoder.next_token_logits(half, cfg, seqs, rows, weight, dtype,
                                     margins)
'''


@pytest.mark.parametrize("own_reference", [True, False])
def test_a_family_added_as_files_alone(tmp_path, own_reference):
    """A family with its own reference, work and kernel names, and no
    expert probe, in a folder of its own beside a cell that names it: the
    run is correct under the family's reference and not under the default
    one, a generic reader asks the family's work, and the family's pair
    names its kernel before the frozen `gemm` does."""
    root, bench = tiny.make_root(tmp_path)
    (root / "families").mkdir()
    (root / "reference").mkdir()
    (root / "families" / "halfmlp.py").write_text(HALF_FAMILY.format(
        reference='REFERENCE = "halfmlp"\n' if own_reference else ""))
    (root / "reference" / "halfmlp.py").write_text(HALF_REFERENCE)
    cfg = dict(spec.config("tinyqwen", root), name="tinyhalf",
               family="halfmlp")
    (root / "configs" / "tinyhalf.json").write_text(json.dumps(cfg))
    (root / "limits" / "tinyhalf.tinymix.json").write_text(
        json.dumps(tiny.LIMITS["tinyqwen"]))
    bench["workloads"].append({"name": "tinyhalf.tinymix",
                               "config": "tinyhalf", "traffic": "tinymix",
                               "chips": 1, "why": "a test's size"})
    res = run.run_cell("tinyhalf.tinymix", 2**31 + 5, 0.3, False, "cpu",
                       root=root, bench=bench)
    assert res["correct"] is own_reference, res["check"]

    fam = spec.family("halfmlp", root)
    assert fam.expert_gemm_names(None, cfg, {}, "cpu") == frozenset()
    ops = [("void halfmlp_gemm_kernel<64>", 0, 4000),
           ("void tree_attention_mma<128, 4>(x)", 4000, 6000),
           ("void qmm_kernel<0, 128, 4>(x)", 6000, 7000)]
    t = trace.Trace(ops, [("request", 0, 7000)], keys=fam.kernel_families)
    assert t.family_s == pytest.approx({"half_mlp": 4e-6,
                                        "tree_attention": 2e-6,
                                        "int8_matmul": 1e-6})
    assert trace.Trace(ops, [("request", 0, 7000)]).family_s[
        "cublas_gemm"] == pytest.approx(4e-6)
    reqs = [run.Served(0, 1, [1] * 4, 2, [2, 2], 2, 1, 0.0, 1.0)] * 2
    r = run.Run(cfg=cfg, mix={}, dims=fam.work(cfg, {}), requests=reqs,
                window_s=1.0, setup_s=1.0, traced=reqs, trace=t)
    assert spec.reader("attention_roofline", root)(r) == pytest.approx(50.0)
    assert spec.reader("int8_roofline", root)(r) is None
