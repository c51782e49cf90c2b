"""Finding a cell's parts by name: the cell in `BENCHMARK.json`, its
configuration in `configs/<name>.json`, its traffic mix in
`traffic/<name>.json`, the limits of its check in `limits/<cell>.json`, a
metric's reader in `metrics/<name>.py`, a family in `families/<name>.py`
with its hooks (`Family`) and a reference in `reference/<name>.py`.
`root` is the benchmark's folder; tests point it at a folder of their
own."""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path

from benchmark.lib import traffic
from benchmark.lib.work import Dims

ROOT = Path(__file__).resolve().parent.parent
BENCHMARK_JSON = ROOT.parent / "BENCHMARK.json"


def _json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no {what} at {path}")
    return json.loads(path.read_text())


def load_benchmark(path: Path = BENCHMARK_JSON) -> dict:
    return _json(Path(path), "benchmark definition")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(name: str, root: Path = ROOT) -> dict:
    return _json(Path(root) / "configs" / f"{name}.json", "configuration")


def mix(name: str, root: Path = ROOT) -> dict:
    return traffic.check_mix(
        _json(Path(root) / "traffic" / f"{name}.json", "traffic mix"))


def limits(cell_name: str, root: Path = ROOT) -> dict:
    return _json(Path(root) / "limits" / f"{cell_name}.json",
                 "limits of the output check")


def reader(name: str, root: Path = ROOT):
    """The `read(run)` function of metric `name`."""
    path = Path(root) / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    return _load(path, "metric", name).read


def _load(path: Path, kind: str, name: str):
    """The module in file `path`, loaded as `benchmark_<kind>_<name>`."""
    key = f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(key, path)
    mod = sys.modules[key] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _module(folder: str, name: str, root: Path):
    """Module `name` of `folder` ("families", "reference"): the file under
    `root` where a test's folder has one, else the benchmark's own."""
    path = Path(root) / folder / f"{name}.py"
    if Path(root).resolve() == ROOT or not path.is_file():
        return importlib.import_module(f"benchmark.{folder}.{name}")
    return _load(path, folder, name)


class Family:
    """A model family: its module (`families/<name>.py`), whose
    `model_config`, `draw`, `port_params` and `draft` are read through this
    object as they are, and the harness's hooks, each the module's own
    where it defines one, else the default that the LLaMA-style families
    (Qwen2, Mixtral) use (`families/__init__.py`)."""

    def __init__(self, module, root: Path = ROOT):
        self.module, self.root = module, root
        self.kernel_families = tuple(getattr(module, "KERNEL_FAMILIES", ()))

    def __getattr__(self, name: str):
        return getattr(self.module, name)

    def reference_logits(self, w, cfg, seqs, rows, weight, dtype, margins):
        """The plain reference's logits at `rows` of each of `seqs`: the
        module's `reference_logits`, else `next_token_logits` of the
        reference module its `REFERENCE` names, by default the LLaMA
        decoder (`reference/decoder.py`)."""
        own = getattr(self.module, "reference_logits", None)
        if own is None:
            own = _module("reference", getattr(self.module, "REFERENCE",
                                               "decoder"),
                          self.root).next_token_logits
        return own(w, cfg, seqs, rows, weight, dtype, margins)

    def work(self, cfg: dict, mix: dict):
        """`run.dims`, the work the served requests needed: the module's
        `work(cfg, mix)`, else `lib/work.py Dims`."""
        own = getattr(self.module, "work", None)
        return own(cfg, mix) if own is not None else Dims.of(cfg, mix)

    def expert_gemm_names(self, eng, cfg: dict, mix: dict,
                          device) -> frozenset:
        """The GEMM kernels of the expert products (the trace's
        `moe_experts`): the module's probe, else none."""
        own = getattr(self.module, "expert_gemm_names", None)
        return (frozenset(own(eng, cfg, mix, device)) if own is not None
                else frozenset())


def family(name: str, root: Path = ROOT) -> Family:
    return Family(_module("families", name, root), root)


def metrics_of(bench: dict, cell_name: str, traced: bool) -> list:
    """The metric entries the cell reports: its end-to-end metrics in an
    untraced run, its per-layer ones in a traced run. A metric with a
    "workloads" list applies to those cells; a per-layer metric without one
    to every cell that reports the end-to-end metric it moves."""
    def listed(m):
        return "workloads" not in m or cell_name in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if listed(m)]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in names)]
