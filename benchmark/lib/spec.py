"""Finding a cell's parts by name: the cell in `BENCHMARK.json`, its
configuration in `configs/<name>.json`, its traffic mix in
`traffic/<name>.json`, the limits of its check in `limits/<cell>.json`, a
metric's reader in `metrics/<name>.py` and a family in
`families/<name>.py`. `root` is the benchmark's folder; tests point it at
a folder of their own."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

from benchmark.lib import traffic

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
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def family(name: str):
    return importlib.import_module(f"benchmark.families.{name}")


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
