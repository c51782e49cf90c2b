"""Build and load the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` compiles on first use into its own shared library with
a plain C interface (`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`), loaded with `ctypes`. Libraries land in `_build/` (listed
in `.gitignore`) under a name that carries the hash of the sources, so an
edited source rebuilds and a stale library is never loaded. Nothing here runs
at import: the CPU tests import every module and this machine class has no
`nvcc`.

Every C entry point returns `cudaGetLastError()` after its launch; `check`
turns a non-zero code into an exception, because a refused launch never runs
and `torch.cuda.synchronize()` does not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
KERNELS = ("int8_matmul", "tree_attention", "head_topk", "nf4_matmul",
           "int4_matmul", "int4_matmul_smallm", "mla_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    """Library path for kernel `name`, keyed by the hash of its source and
    every shared header (a header edit rebuilds every kernel)."""
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Compile every missing library in `names`, one `nvcc` per source, all
    started together. Returns {name: seconds} for the ones built; raises with
    the compiler's output if any fails. The ptxas report (registers, shared
    memory, spills) is kept beside each library as `<lib>.log`. A build that
    compiles something is a `kernel_build` span of the recorder
    (`utils/profiler.py prof`), when it is on."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0, t0_ns = time.perf_counter(), time.time_ns()
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"{name}:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if procs:
        from flowspec_tpu_torch.utils.profiler import prof
        if prof.enabled:
            prof.close(prof.open("kernel_build", t0_ns))
    if errors:
        raise RuntimeError("nvcc failed for " + "\n".join(errors))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if missing."""
    with _lock:
        if name not in _libs:
            path = lib_path(name)
            if not path.exists():
                build((name,))
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


def bind(name: str, n_ptrs: int, n_ints: int, n_floats: int = 0,
         lib: str | None = None):
    """The C entry point `name` of kernel library `lib` (default: the
    library of the same name), taking n_ptrs pointers, then n_ints ints, then
    n_floats floats, then the stream, and returning cudaGetLastError()
    (declared in full: ctypes would otherwise pass each pointer as a 32-bit
    int)."""
    fn = getattr(library(lib or name), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def refuse_grad(name: str, *operands) -> None:
    """Raise if autograd would need a gradient through kernel `name`: grad
    mode is on and an operand requires one. A kernel writes a tensor the
    wrapper allocated, which autograd cannot see into, so its result would
    silently carry no gradient; training takes the plain differentiable
    forward (`train/forward.py`) instead. Serving never hands a kernel an
    operand that requires a gradient."""
    import torch
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in operands):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward, and an "
                           "operand requires a gradient (run it under "
                           "torch.no_grad(), or train through the "
                           "differentiable forward)")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def aligned16(t):
    """`t` contiguous at a 16-byte aligned address (the kernels load with
    16-byte vectors); a view at an odd offset is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
