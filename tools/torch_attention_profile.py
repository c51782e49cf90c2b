#!/usr/bin/env python3
"""Tree attention on one card: the phases of a launch and the plan's choices.

    python3 tools/torch_attention_profile.py

What chip_smoke.py's event timing cannot separate, at each of its
ATTN_SHAPES rows (inputs made as there):
  - "phases": the kernel built a second time with -DFS_ATTN_STAMPS, in which
    thread 0 of every block writes %globaltimer at 8 points of the call
    (csrc/tree_attention.cu FS_STAMP); one launch by `attention_plan` after
    an L2 flush. Per phase the median over blocks, in µs; the spread of the
    blocks' start times (a second wave shows as a spread about one block
    long) and the span from the first start to the last end;
  - "plans": the serving library's kernel under plan variants (rows a
    block: every balanced width of 1-6 warps the shape allows; 1 or 2
    64-key tiles a split), each timed like chip_smoke.py (median of
    CUDA-event pairs, L2 flushed before every launch), beside SDPA on the
    same rows and the plan's own choice.
One JSON line per shape on stdout and in attention_profile.jsonl in
chip_smoke.py's output directory.
Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PHASES = ("k_landed", "scores", "v_wait", "softmax_pv", "barrier_1", "join",
          "barrier_2")


def stamped_library():
    """tree_attention.cu built with -DFS_ATTN_STAMPS beside the serving
    library (its own file name), loaded with ctypes."""
    from flowspec_tpu_torch.ops import _build
    out = _build.lib_path("tree_attention")
    out = out.with_name(out.stem.replace("tree_attention",
                                         "tree_attention_stamps") + ".so")
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                        "-DFS_ATTN_STAMPS", "-o", str(out),
                        str(_build.CSRC / "tree_attention.cu")],
                       check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.tree_attention.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                                   + [ctypes.c_float, ctypes.c_void_p])
    lib.tree_attention.restype = ctypes.c_int
    lib.tree_attention_set_stamps.argtypes = [ctypes.c_void_p]
    lib.tree_attention_set_stamps.restype = ctypes.c_int
    return lib


def phases(lib, cs, flush, q, k, v, bias, plan):
    """One stamped launch by `plan`: medians over blocks of each phase, the
    start spread and the span, in µs."""
    import torch
    nkv, s_max, d = k.shape[1], k.shape[2], k.shape[3]
    t = q.shape[2]
    stamps = torch.zeros(plan.blocks * 8, dtype=torch.int64, device=q.device)
    out = torch.empty_like(q)
    assert lib.tree_attention_set_stamps(stamps.data_ptr()) == 0
    cs.flush_l2(flush)
    err = lib.tree_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             bias.data_ptr(), None, out.data_ptr(), 1, nkv,
                             q.shape[1] // nkv, t, s_max, d, plan.n_keys,
                             plan.warps, plan.splits, plan.tiles_per_split,
                             d ** -0.5, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0 and lib.tree_attention_set_stamps(None) == 0
    st = stamps.view(plan.blocks, 8).cpu().tolist()
    res = {}
    for i, name in enumerate(PHASES):
        dts = [(b[i + 1] - b[i]) / 1e3 for b in st if b[i + 1] and b[i]]
        if dts:
            res[name] = statistics.median(dts)
    t0 = min(b[0] for b in st)
    res["start_spread"] = (max(b[0] for b in st) - t0) / 1e3
    res["span"] = (max(max(b) for b in st) - t0) / 1e3
    res["block_median"] = statistics.median((max(b) - b[0]) / 1e3 for b in st)
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_attention_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F
    import chip_smoke as cs
    from flowspec_tpu_torch.ops import tree_attention as ta

    dev = torch.device("cuda")
    cs.OUT_DIR.mkdir(exist_ok=True)
    lib = stamped_library()
    out = open(cs.OUT_DIR / "attention_profile.jsonl", "w")

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        out.write(line + "\n")

    emit({"device": torch.cuda.get_device_name(0),
          "nvidia_smi": cs.nvidia_smi()})
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    flush = torch.zeros(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    for name, nq, nkv, t, s_max, n_valid in cs.ATTN_SHAPES:
        q, k, v, bias = cs.attention_inputs(gen, dev, nq, nkv, t, s_max,
                                            n_valid)
        g = nq // nkv
        n_keys = ta.kernel_keys(s_max, n_valid)
        plan = ta.attention_plan(nkv, g, t, n_keys)
        row = {"shape": name, "plan": plan._asdict(),
               "phases_us": phases(lib, cs, flush, q, k, v, bias, plan)}
        m16, tiles = -(-g * t // 16), n_keys // ta.KEY_TILE
        variants = {}
        for warps in sorted({-(-m16 // rt) for rt in range(1, m16 + 1)
                             if -(-m16 // rt) <= ta.MAX_WARPS}):
            for per in (1, 2):
                splits = -(-tiles // per)
                if per > tiles or splits > ta.MAX_SPLITS:
                    continue
                key = (f"warps{warps}_rowtiles{-(-m16 // warps)}"
                       f"_splits{splits}x{per}")
                variants[key] = cs.time_ms(
                    lambda: ta._launch(ta.tree_attention, q, k, v, bias,
                                       n_keys, (warps, splits, per)), flush)
        row["plans_ms"] = variants
        kr = k[:, :, :n_keys].repeat_interleave(g, dim=1)
        vr = v[:, :, :n_keys].repeat_interleave(g, dim=1)
        mask = bias[:, :n_keys].to(torch.bfloat16).contiguous()
        row["sdpa_ms"] = cs.time_ms(
            lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask),
            flush)
        emit(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
