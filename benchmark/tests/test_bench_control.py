"""The control at a test's size: the reference in the precision below the
configuration's own fails the check that sound runs of the port pass.
On the card (`cuda`), the same at each cell's own size."""

import pytest

from benchmark import control
from benchmark.lib import spec
from benchmark.reference import precision
from benchmark.tests import tiny


def compared(limits: dict) -> dict:
    return {k: v for k, v in limits["limits"].items()
            if k not in ("failed", "short")}


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_the_control_fails_where_the_program_passes(cell, tmp_path):
    root, bench = tiny.make_root(tmp_path)
    limits = compared(spec.limits(cell, root))
    cfg = spec.config(spec.cell(bench, cell)["config"], root)
    lower = precision.LOWER[cfg["weights"]["precision"]].__name__
    for seed in (21, 22, 23):
        r = control.readings(cell, seed, "cpu", root=root, bench=bench)
        assert all(r["program"][k] <= v for k, v in limits.items()), r
        assert any(r[f"control_{lower}"][k] > v
                   for k, v in limits.items()), r


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_the_control_fails_on_the_card(cell, card):
    limits = compared(spec.limits(cell))
    lower = precision.LOWER[spec.config(spec.cell(
        spec.load_benchmark(), cell)["config"])["weights"]["precision"]]
    r = control.readings(cell, 31, card)
    assert all(r["program"][k] <= v for k, v in limits.items()), r
    assert any(r[f"control_{lower.__name__}"][k] > v
               for k, v in limits.items()), r
