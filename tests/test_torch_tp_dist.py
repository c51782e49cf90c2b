"""The port's tensor parallelism over `torch.distributed`, its fused and
int8 TP engines, and its multi-device dry run, on the CPU.

Two processes over gloo (`parallel/comm.py DistGroup`, one TP rank each,
`tests/torch_tp_dist_worker.py`) run `TPEngine` at tp 2, plain and galaxy:
their tokens and stats equal the in-process engine's and their gathered KV
its KV, bit for bit (f32; a sum of two partials does not depend on its
order). The pair runs in subprocesses with a free port and a timeout of
its own, so that a hang fails the test instead of stalling the suite.
`entry.dryrun_multichip(4, device="cpu")` passes (the six schedules over
4 stages, TP and galaxy at tp 4, the (2, 2) stage x tp mesh on an uneven
split, each equal to the AR stream), and `entry.entry` gives a round that
runs. On tests/test_torch_tp.py's setup (f32), `TPEngine` int8-quantized
at tp 2, and through `generate_fused`, gives JAX's `TPEngine`'s tokens,
rounds and accept/round; a TP state saved unsharded resumes as the kept
one does; `BatchedSpecEngine.serve` over megatron-sharded weights gives
the unsharded serve's streams (tests/test_tp.py:122-144).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from flowspec_tpu.draft.eagle import quantize_eagle_params
from flowspec_tpu.models.llama import quantize_llama_params
from flowspec_tpu.parallel import tp as jtp
from flowspec_tpu.parallel.mesh import tp_mesh as jtp_mesh
from flowspec_tpu_torch.entry import dryrun_multichip, entry
from flowspec_tpu_torch.parallel import (
    TPEngine, shard_draft_tp, shard_params_tp, tp_mesh,
)
from flowspec_tpu_torch.runtime.batched import BatchedSpecEngine
from tests.test_torch_tp import (  # noqa: F401 (a fixture)
    N_NEW as TP_NEW, equal_runs, setup,
)
from tests.torch_bridge_util import port_eagle, port_llama
from tests.torch_tp_dist_worker import N_NEW, tiny_tp_setup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_tp_dist_worker.py")
TIMEOUT_S = 120


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_tp_equals_in_process(tmp_path):
    port = free_port()
    env = {**os.environ, "PYTHONPATH": ROOT}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "2", str(port), str(tmp_path)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    got = json.loads((tmp_path / "result.json").read_text())

    params, draft, cfg, prompt = tiny_tp_setup()
    for name, galaxy in (("tp", False), ("galaxy", True)):
        eng = TPEngine(params, draft, cfg, mesh=tp_mesh(2), galaxy=galaxy,
                       device="cpu")
        out, stats, st = eng.generate(prompt, max_new_tokens=N_NEW,
                                      eos_token_id=-1, return_state=True)
        assert got[name]["tokens"] == out, name
        assert got[name]["stats"] == stats, name
        np.testing.assert_array_equal(
            np.load(tmp_path / f"{name}_k.npy"), st.base_cache.k.numpy())
        if galaxy:
            assert got[name]["engaged"] == eng.forward_fn.engaged > 0


def test_dryrun_multichip_on_cpu():
    report = dryrun_multichip(4, device="cpu")
    paths = ("continuous", "pruned", "naive", "serial", "ar", "pipedec",
             "tp4", "galaxy_tp4", "stage2_tp2")
    assert all(report[k]["ok"] and report[k]["equal"] for k in paths)
    assert report["stage2_tp2"]["split"] == [3, 5]
    assert report["galaxy_tp4"]["engaged"] > 0


def test_entry_round_runs():
    """`entry` at a small shape (its defaults are the flagship's): one
    round from the seeded one-pair context accepts at least the root."""
    fn, args = entry(device="cpu", vocab=256, hidden=128, layers=2, heads=4)
    state, accepted, n_acc = fn(*args)
    assert int(n_acc[0]) >= 1 and int(accepted[0, 0]) >= 0
    assert int(state.commit_len[0]) == 1 + int(n_acc[0])


def test_tp_engine_int8_matches_jax(setup):
    jcfg, cfg, p, d, prompt = setup
    qp, qd = quantize_llama_params(p, "int8"), quantize_eagle_params(d,
                                                                     "int8")
    jeng = jtp.TPEngine(qp, qd, jcfg, mesh=jtp_mesh(2))
    eng = TPEngine(port_llama(qp), port_eagle(qd), cfg, mesh=tp_mesh(2),
                   device="cpu")
    equal_runs(jeng, eng, prompt, n_new=20)


def test_tp_engine_fused_matches_jax(setup):
    """`generate_fused` (on the CPU the captured loop's body, uncaptured)
    and `generate` give JAX's fused stream and stats."""
    jcfg, cfg, p, d, prompt = setup
    jeng = jtp.TPEngine(p, d, jcfg, mesh=jtp_mesh(2))
    eng = TPEngine(port_llama(p), port_eagle(d), cfg, mesh=tp_mesh(2),
                   device="cpu")
    got, stats = equal_runs(jeng, eng, prompt, "generate_fused")
    assert stats["new_tokens"] == TP_NEW
    assert eng.generate(prompt, max_new_tokens=TP_NEW,
                        eos_token_id=-1)[0] == got


def test_tp_engine_state_round_trip(setup, tmp_path):
    """`save_state` writes the unsharded layout; `load_state` resumes it
    as a fresh continuation does."""
    _, cfg, p, d, prompt = setup
    eng = TPEngine(port_llama(p), port_eagle(d), cfg, mesh=tp_mesh(2),
                   device="cpu")
    out, _, st = eng.generate(prompt, max_new_tokens=8, eos_token_id=-1,
                              return_state=True)
    eng.save_state(st, str(tmp_path))
    extra = [5, 6, 7]
    a, _ = eng.resume_and_generate(st, out, extra, max_new_tokens=6,
                                   eos_token_id=-1)
    b, _ = eng.resume_and_generate(eng.load_state(str(tmp_path)), out,
                                   extra, max_new_tokens=6, eos_token_id=-1)
    assert a == b


def test_tp_sharded_continuous_serving(setup):
    """`BatchedSpecEngine.serve` over megatron-sharded weights (no engine
    change): every request's stream equals the unsharded serve's."""
    _, cfg, p, d, _ = setup
    rng = np.random.default_rng(21)
    prompts = [rng.integers(3, 60, 6 + i).tolist() for i in range(4)]
    tp_, td = port_llama(p), port_eagle(d)
    refs, _ = BatchedSpecEngine(tp_, td, cfg, batch_size=2,
                                device="cpu").serve(
        prompts, max_new_tokens=8, eos_token_id=-1)
    mesh = tp_mesh(2)
    eng = BatchedSpecEngine(shard_params_tp(tp_, mesh),
                            shard_draft_tp(td, mesh), cfg, batch_size=2,
                            device="cpu")
    outs, stats = eng.serve(prompts, max_new_tokens=8, eos_token_id=-1)
    assert outs == refs
    assert stats["per_request"] == [8] * 4
