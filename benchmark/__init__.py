"""The benchmark of the PyTorch / CUDA port (`flowspec_tpu_torch`).

`python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once on one card and
prints its result as the last line. Configurations (`configs/`), traffic
mixes (`traffic/`), per-metric readers (`metrics/`) and the limits of each
cell's output check (`limits/`) are files found by name; `lib/` holds the
harness's frozen arithmetic, `families/` the weight draws, `reference/`
the plain float32 reference that decides `correct`, `control.py` the
readings the limits were set from, `tests/` the CPU tests
(`python -m pytest benchmark/tests`). Nothing here imports JAX or the JAX
package.
"""
