"""A tiny cell of each family, written as files into a folder of its own,
beside copies of the benchmark's metric readers, for the CPU tests: the
same harness, configuration keys and traffic laws as the real cells at a
test's size, in float32 so that a sound run reads no gap at all."""

import json
import shutil

from benchmark.lib import spec

TINY = {"hidden_size": 128, "intermediate_size": 256, "num_hidden_layers": 4,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "vocab_size": 512, "torch_dtype": "float32"}
MIX = {"name": "tinymix", "block": 4,
       "prompt_tokens": [8, 20, 40, 60, 90, 120],
       "new_tokens": [40, 48, 56, 64],
       "engine": {"max_seq_len": 256, "kv_buckets": [96, 192],
                  "prefill_chunk": 16},
       "check": {"served_tokens": 120}}
# a sound float32 run reads no gap at all
LIMITS = {"tinyqwen": {"limits": {"max_gap": 1e-3, "failed": 0,
                                  "short": 0}},
          "tinymoe": {"limits": {"decided_mean_gap": 1e-3, "failed": 0,
                                 "short": 0}, "router_margin": 0.05}}
CELLS = {"tinyqwen.tinymix": "qwen2-7b-int8",
         "tinymoe.tinymix": "mixtral-8x7b-bf16-16l"}


def make_root(tmp_path):
    """(root, bench): a benchmark folder with the tiny cells."""
    root = tmp_path / "bench"
    shutil.copytree(spec.ROOT / "metrics", root / "metrics")
    for d in ("configs", "traffic", "limits"):
        (root / d).mkdir()
    mix = dict(spec.mix("chat"), **MIX)
    (root / "traffic" / "tinymix.json").write_text(json.dumps(mix))
    bench = spec.load_benchmark()
    bench["workloads"] = []
    for cell, real in CELLS.items():
        name = cell.split(".")[0]
        cfg = dict(spec.config(real), name=name, **TINY)
        if "num_local_experts" in cfg:
            cfg["num_local_experts"] = 4
        (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        (root / "limits" / f"{cell}.json").write_text(
            json.dumps(LIMITS[name]))
        bench["workloads"].append({"name": cell, "config": name,
                                   "traffic": "tinymix", "chips": 1,
                                   "why": "a test's size"})
    return root, bench
