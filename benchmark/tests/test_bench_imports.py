"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the port; the frozen kernel families
agree with the names the port's smoke script expects today, and keep
those of kernels the port no longer launches."""

import ast
import importlib.util
import subprocess
import sys
from pathlib import Path

from benchmark.lib import spec, trace

BENCH = spec.ROOT
REPO = BENCH.parent
JAX = {"jax", "jaxlib", "flax", "flowspec_tpu"}


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not imported(path) & JAX, path


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "flowspec_tpu_torch" not in imported(path), path
        assert imported(path) <= {"torch", "contextlib", "__future__",
                                  "benchmark"}, path
    for path in (BENCH / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module.startswith(
                    "benchmark"):
                assert node.module.startswith("benchmark.reference"), path


def test_a_run_loads_no_jax(tmp_path):
    code = f"""
import sys
sys.path.insert(0, {str(REPO)!r})
from pathlib import Path
from benchmark import run
from benchmark.tests import tiny
root, bench = tiny.make_root(Path({str(tmp_path)!r}))
res = run.run_cell("tinymoe.tinymix", 3, 0.3, False, "cpu", root=root,
                   bench=bench)
assert res["correct"], res
print(run.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    from benchmark import run
    monkeypatch.setitem(sys.modules, "flowspec_tpu_torch_extra", sys)
    assert run.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & JAX)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.forbidden_modules()


KERNELS = [
    "void qmm_kernel<0, 128, 4>(bf16 const*, signed char const*)",
    "void qmm_kernel<1, 64, 2>(x)", "void qmm_kernel<2, 64, 2>(x)",
    "int8_matmul_kernel",
    "void p4_matmul_kernel<true, 4>(x)", "void p4_matmul_kernel<false, 4>",
    "int4_splitk_kernel", "tree_attention_simt_kernel",
    "void tree_attention_mma<128, 4>(x)", "head_wgmma_kernel<2>",
    "head_select_kernel", "head_partial_kernel", "head_merge_kernel",
    "nvjet_tst_192x192_64x3_1x2_h_bz_coopB_TNT",
    "sm90_xmma_gemm_bf16bf16_bf16f32", "ampere_bf16_s16816gemm_bf16_128x64",
    "cutlass::Kernel2<cutlass_80_wmma>",
    "void at::native::radixSortKVInPlace<2, -1>", "void at::native::sort",
    "void at::native::topk_kernel", "void at::native::vectorized_elementwise",
    "Memcpy DtoD (Device -> Device)", "Memset (Device)"]
# kernels the port no longer launches, which the smoke script no longer
# names and the frozen families still do (their family reads 0)
RETIRED = {"void qmm_reduce<128>(float const*)": "matmul_reduce"}


def test_the_frozen_families_match_the_smoke_script():
    spec_ = importlib.util.spec_from_file_location("chip_smoke",
                                                   REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(smoke)
    moe = frozenset({"nvjet_tst_192x192_64x3_1x2_h_bz_coopB_TNT"})
    for name in KERNELS:
        assert trace.family(name) == smoke.family(name), name
        assert trace.family(name, moe) == smoke.family(name, moe), name
    for name, fam in RETIRED.items():
        assert trace.family(name) == fam, name
    assert trace.GEMM_KEYS == smoke.GEMM_KEYS
