"""The port's pipeline with a block of stages a process, over gloo on the
CPU (f32).

On tests/test_torch_pipeline.py's tiny setup (vocab 12, four layers, node
cap 64, chunks of 6; the JAX draw, bridged), groups of worker processes
(this file run as a script: `python tests/test_torch_multihost.py <job>
<rank>`, one torch thread each, a free localhost port, a timeout of their
own) run `PipelineEngine` on a distributed `stage_mesh` / `stage_tp_mesh`
(`parallel/mesh.py`) and write what rank 0 saw:

- 2 processes x 2 stages and 4 processes x 1 stage, all six schedules:
  tokens and every stat equal the in-process port engine's, and the KV
  gathered from the processes (`gather_state`) equals its KV bit for bit;
  continuous and pruned equal JAX's `PipelineEngine` on the same weights;
- `generate_fused`, `save_state` (every rank gathers, rank 0 writes), a
  resume from the gathered whole state (cut to each block), the uneven
  split (0, 2, 2, 2) with its 0-layer stage in a process of its own, and
  PP x TP with an in-process tp 2 in each of 2 processes, each against the
  in-process engine;
- a world that does not divide the stages raises; a flag vector that one
  rank perturbs (the worker's test-only `inject`) makes every rank raise
  at that turn, naming the rank, instead of hanging; a collective whose
  peer never comes ends at the process group's timeout;
- `python -m flowspec_tpu_torch.multihost_dryrun --device cpu` at 2 x 4
  stages passes; `--device cuda` without a card exits non-zero at once.

The groups run side by side in one module fixture.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEDULES = ["ar", "serial", "naive", "pruned", "continuous", "pipedec"]
TREE = dict(top_k=8, depth=4, total_tokens=24, expand_tokens=12,
            expand_depth=2, node_cap=64, leaf_cap=64, depth_cap=14,
            chunk_len=6, chunk_cap=12)
N_NEW = 20
RESUME = (7, 10)                 # extra prompt tokens, new tokens after them
TIMEOUT_S = 120                  # a group's processes, start to end
HANG_S = 10                      # the checks group's process group timeout
INJECT = {"rank": 1, "call": 4}  # the 4th flag gather of the check's run


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def prompts():
    rng = np.random.default_rng(0)
    return (rng.integers(3, 11, 9).tolist(), rng.integers(3, 11, RESUME[0])
            .tolist())


def port_config(model: dict, split, max_seq=256):
    """The port's EngineConfig of `model` at sum(split) layers."""
    from flowspec_tpu_torch import config as tcfg
    model = dict(model, num_hidden_layers=sum(split))
    return tcfg.EngineConfig(
        model=tcfg.ModelConfig(**model), tree=tcfg.TreeConfig(**TREE),
        sampling=tcfg.SamplingConfig(), max_seq_len=max_seq,
        prefill_chunk=8,
        topology=tcfg.StageTopology(len(split), tuple(split)))


# ---- the worker ------------------------------------------------------------

def worker(job_path: str, rank: int) -> int:
    """One rank of a group: the job's runs on a distributed mesh, then its
    checks; writes rank<r>.json into the job's directory."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    from flowspec_tpu_torch.models.checkpoint import load_params
    from flowspec_tpu_torch.parallel import (
        PipelineEngine, init_multihost, stage_mesh, stage_tp_mesh)
    job = json.loads(open(job_path).read())
    out_dir = os.path.dirname(job_path)
    init_multihost(f"127.0.0.1:{job['port']}", job["world"], rank,
                   device="cpu", timeout=job["timeout"])
    pairs = {n: [load_params(os.path.join(job["weights"], f"{k}{n}"),
                             device="cpu") for k in ("base", "draft")]
             for n in (4, 6)}
    prompt, extra = prompts()
    res = {}
    for run in job["runs"]:
        split, tp = run["split"], run.get("tp", 1)
        params, draft = pairs[sum(split)]
        cfg = port_config(job["model"], split)
        mesh = (stage_mesh(len(split), distributed=True) if tp == 1 else
                stage_tp_mesh(len(split), tp, distributed=True))
        eng = PipelineEngine(params, draft, cfg, schedule=run["schedule"],
                             device="cpu", mesh=mesh)
        if run["name"] == "inject":
            res["inject"] = inject(eng, rank, prompt)
            continue
        out, stats, st = getattr(eng, run.get("method", "generate"))(
            prompt, max_new_tokens=N_NEW, eos_token_id=-1,
            return_state=True)
        r = res[run["name"]] = {"tokens": out, "stats": stats,
                                "layers_here": eng.n_layers,
                                "reads": eng.reads.count}
        whole = eng.gather_state(st)
        if rank == 0:
            np.save(os.path.join(out_dir, f"{run['name']}_k.npy"),
                    whole.kv.k.numpy())
            np.save(os.path.join(out_dir, f"{run['name']}_v.npy"),
                    whole.kv.v.numpy())
        if run.get("save"):
            eng.save_state(st, os.path.join(out_dir, run["name"] + "_state"))
        if run.get("resume"):
            r["resume"] = eng.resume_and_generate(
                whole, out, extra, max_new_tokens=RESUME[1],
                eos_token_id=-1)
    if job.get("divide"):
        try:
            stage_mesh(job["divide"], distributed=True)
            res["divide"] = None
        except ValueError as e:
            res["divide"] = str(e)
    if job.get("hang"):
        res["hang"] = hang(rank)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    if job.get("hang"):
        os._exit(0)          # the group is broken by design: no teardown
    dist.destroy_process_group()
    return 0


def inject(eng, rank: int, prompt) -> dict:
    """Run with rank INJECT["rank"] adding 1 to the first flag of its
    INJECT["call"]-th gather; every rank must raise at that gather."""
    ring = eng.ring
    gather, calls = ring.all_gather_ints, [0]

    def perturbed(vals):
        calls[0] += 1
        if rank == INJECT["rank"] and calls[0] == INJECT["call"]:
            vals = list(vals)
            vals[2 * len(eng.local) + 2] += 1
        return gather(vals)
    ring.all_gather_ints = perturbed
    t0 = time.perf_counter()
    try:
        eng.generate(prompt, max_new_tokens=N_NEW, eos_token_id=-1)
        return {"error": None}
    except RuntimeError as e:
        return {"error": str(e), "seconds": time.perf_counter() - t0,
                "calls": calls[0]}


def hang(rank: int) -> dict:
    """Rank 0 gathers, rank 1 never does: rank 0 must fail at the group's
    timeout."""
    from flowspec_tpu_torch.parallel.comm import DistGroup
    if rank != 0:
        time.sleep(HANG_S + 5)
        return {}
    t0 = time.perf_counter()
    try:
        DistGroup().all_gather_ints([0])
        return {"error": None}
    except RuntimeError as e:
        return {"error": str(e)[:200], "seconds": time.perf_counter() - t0}


# ---- the groups ------------------------------------------------------------

def group_jobs(model, weights):
    cont = {"schedule": "continuous", "split": [1, 1, 1, 1]}
    two = [{"name": s, "schedule": s, "split": [1, 1, 1, 1]}
           for s in SCHEDULES]
    two += [dict(cont, name="fused", method="generate_fused", save=True),
            dict(cont, name="resume", resume=True),
            dict(cont, name="pp_x_tp", tp=2)]
    four = [{"name": s, "schedule": s, "split": [1, 1, 1, 1]}
            for s in SCHEDULES]
    four += [dict(cont, name="uneven", split=[0, 2, 2, 2]),
             dict(cont, name="uneven_pruned", schedule="pruned",
                  split=[0, 2, 2, 2]),
             dict(cont, name="resume", resume=True)]
    base = {"model": model, "weights": weights, "timeout": TIMEOUT_S}
    return {"2x2": dict(base, world=2, runs=two, divide=3),
            "4x1": dict(base, world=4, runs=four),
            "checks": dict(base, world=2, timeout=HANG_S, hang=True,
                           runs=[dict(cont, name="inject")])}


def launch(name, job, tmp) -> tuple:
    d = tmp / name
    d.mkdir()
    job = dict(job, port=free_port())
    (d / "job.json").write_text(json.dumps(job))
    env = {**os.environ, "PYTHONPATH": ROOT}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(d / "job.json"),
         str(r)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(job["world"])]
    return d, procs


def finish(procs, t_end) -> list:
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(t_end - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return logs


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(JAX ModelConfig, JAX params, draft, port params, draft, the port's
    saved weights): tests/test_torch_pipeline.py's draw; the directory also
    holds a 6-layer draw (tests/test_torch_tree_pipeline.py's, for the
    uneven split), {4: pair, 6: pair} as the last item."""
    import jax
    import jax.numpy as jnp
    from flowspec_tpu.draft.eagle import init_eagle_params
    from flowspec_tpu.models.llama import init_llama_params
    from flowspec_tpu_torch.models.checkpoint import save_params
    from tests.test_torch_pipeline import tiny_model
    from tests.torch_bridge_util import port_eagle, port_llama
    out = tmp_path_factory.mktemp("weights")
    drawn = {}
    for n in (4, 6):
        mc = tiny_model(12, n_layers=n)
        p = init_llama_params(jax.random.key(2), mc, dtype=jnp.float32)
        d = init_eagle_params(jax.random.key(7), mc, embed=p.embed,
                              dtype=jnp.float32)
        drawn[n] = (mc, p, d, port_llama(p), port_eagle(d))
        save_params(drawn[n][3], str(out / f"base{n}"))
        save_params(drawn[n][4], str(out / f"draft{n}"))
    return (*drawn[4], str(out), {n: v[3:] for n, v in drawn.items()})


@pytest.fixture(scope="module")
def groups(weights, tmp_path_factory):
    """Every group and the launcher, started together; {name: (dir, exit
    codes, logs)}."""
    tmp = tmp_path_factory.mktemp("multihost")
    model = dataclasses.asdict(weights[0])
    started = {n: launch(n, job, tmp)
               for n, job in group_jobs(model, weights[5]).items()}
    dry = subprocess.Popen(
        [sys.executable, "-m", "flowspec_tpu_torch.multihost_dryrun",
         "--device", "cpu", "--procs", "2", "--stages", "4", "--out",
         str(tmp / "dryrun"), "--timeout", str(TIMEOUT_S)], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    t_end = time.monotonic() + TIMEOUT_S
    out = {}
    for n, (d, procs) in started.items():
        logs = finish(procs, t_end)
        out[n] = (d, [p.returncode for p in procs], logs)
    logs = finish([dry], t_end)
    out["dryrun"] = (tmp / "dryrun", [dry.returncode], logs)
    return out


def result(groups, name, rank=0):
    d, codes, logs = groups[name]
    assert codes == [0] * len(codes), "\n".join(logs)
    return json.loads((d / f"rank{rank}.json").read_text())


def in_process(weights, schedule, split=(1, 1, 1, 1), tp=1):
    from flowspec_tpu_torch.parallel import PipelineEngine, stage_tp_mesh
    cfg = port_config(dataclasses.asdict(weights[0]), split)
    mesh = stage_tp_mesh(len(split), tp) if tp > 1 else None
    return PipelineEngine(*weights[6][sum(split)], cfg, schedule=schedule,
                          device="cpu", mesh=mesh)


# ---- the tests -------------------------------------------------------------

@pytest.mark.parametrize("group", ["2x2", "4x1"])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedule_across_processes_equals_in_process(weights, groups, group,
                                                     schedule):
    """Tokens, every stat and the gathered KV equal the in-process engine's;
    every rank returned the same tokens and stats."""
    prompt, _ = prompts()
    eng = in_process(weights, schedule)
    want, wstats, st = eng.generate(prompt, max_new_tokens=N_NEW,
                                    eos_token_id=-1, return_state=True)
    world = 2 if group == "2x2" else 4
    for r in range(world):
        got = result(groups, group, r)[schedule]
        assert got["tokens"] == want and got["stats"] == wstats, r
        assert got["layers_here"] == 4 // world
    d = groups[group][0]
    np.testing.assert_array_equal(np.load(d / f"{schedule}_k.npy"),
                                  st.kv.k.numpy())
    np.testing.assert_array_equal(np.load(d / f"{schedule}_v.npy"),
                                  st.kv.v.numpy())


@pytest.mark.parametrize("schedule", ["continuous", "pruned"])
def test_across_processes_equals_jax(weights, groups, schedule):
    from flowspec_tpu.parallel import PipelineEngine as JPipelineEngine
    from tests.test_torch_pipeline import configs
    mc, p, d = weights[:3]
    prompt, _ = prompts()
    jeng = JPipelineEngine(p, d, configs(mc)[0], schedule=schedule)
    want, wstats = jeng.generate(prompt, max_new_tokens=N_NEW,
                                 eos_token_id=-1)
    got = result(groups, "4x1")[schedule]
    assert got["tokens"] == [int(t) for t in want]
    assert got["stats"] == wstats


def test_fused_and_saved_state_across_processes(weights, groups):
    """`generate_fused` over 2 processes equals the in-process fused run,
    and the state rank 0 saved loads as the in-process state."""
    from flowspec_tpu_torch.models.checkpoint import load_state
    prompt, _ = prompts()
    eng = in_process(weights, "continuous")
    want, wstats, st = eng.generate_fused(prompt, max_new_tokens=N_NEW,
                                          eos_token_id=-1, return_state=True)
    got = result(groups, "2x2")["fused"]
    assert got["tokens"] == want and got["stats"] == wstats
    saved = load_state(str(groups["2x2"][0] / "fused_state"), device="cpu",
                       layer_split=eng.layer_split)
    np.testing.assert_array_equal(saved.kv.k.numpy(), st.kv.k.numpy())
    assert int(saved.commit_len) == int(st.commit_len)


@pytest.mark.parametrize("group", ["2x2", "4x1"])
def test_resume_across_processes_equals_in_process(weights, groups, group):
    """A resume from the gathered whole state, cut to each block, equals
    the in-process resume."""
    prompt, extra = prompts()
    eng = in_process(weights, "continuous")
    out, _, st = eng.generate(prompt, max_new_tokens=N_NEW, eos_token_id=-1,
                              return_state=True)
    want = eng.resume_and_generate(st, out, extra, max_new_tokens=RESUME[1],
                                   eos_token_id=-1)
    got = result(groups, group)["resume"]["resume"]
    assert got[0] == want[0] and got[1] == want[1]


@pytest.mark.parametrize("schedule", ["continuous", "pruned"])
def test_uneven_split_zero_layer_stage_in_its_own_process(weights, groups,
                                                          schedule):
    prompt, _ = prompts()
    eng = in_process(weights, schedule, split=(0, 2, 2, 2))
    want, wstats, st = eng.generate(prompt, max_new_tokens=N_NEW,
                                    eos_token_id=-1, return_state=True)
    name = "uneven" if schedule == "continuous" else "uneven_pruned"
    for r, layers in enumerate((0, 2, 2, 2)):
        got = result(groups, "4x1", r)[name]
        assert got["tokens"] == want and got["stats"] == wstats
        assert got["layers_here"] == layers
    np.testing.assert_array_equal(
        np.load(groups["4x1"][0] / f"{name}_k.npy"), st.kv.k.numpy())


def test_stage_tp_mesh_tp2_in_each_process(weights, groups):
    prompt, _ = prompts()
    eng = in_process(weights, "continuous", tp=2)
    want, wstats = eng.generate(prompt, max_new_tokens=N_NEW,
                                eos_token_id=-1)
    got = result(groups, "2x2")["pp_x_tp"]
    assert got["tokens"] == want and got["stats"] == wstats


def test_world_that_does_not_divide_the_stages_raises(groups):
    assert "do not split over a world of 2" in result(groups, "2x2")["divide"]


def test_cuda_without_a_card_raises(weights):
    """No silent CPU fallback: the engine and the dry run refuse `cuda`
    without a card."""
    from flowspec_tpu_torch.parallel import PipelineEngine
    cfg = port_config(dataclasses.asdict(weights[0]), (1, 1, 1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PipelineEngine(weights[3], weights[4], cfg, device="cuda")
    r = subprocess.run(
        [sys.executable, "-m", "flowspec_tpu_torch.multihost_dryrun",
         "--device", "cuda", "--out", "unused"], cwd=ROOT,
        capture_output=True, text=True, timeout=TIMEOUT_S)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert not os.path.exists(os.path.join(ROOT, "unused"))


def test_disagreeing_flags_fail_every_rank_at_that_turn(groups):
    """Rank 1's perturbed flag vector: both ranks raise at the same gather,
    naming the turn and rank 1, well inside the group's timeout."""
    for r in range(2):
        got = result(groups, "checks", r)["inject"]
        assert got["calls"] == INJECT["call"], got
        assert "disagree at the turn check of turn" in got["error"]
        assert "ranks [1] differ from rank 0" in got["error"]
        assert got["seconds"] < HANG_S


def test_a_hung_collective_ends_at_the_group_timeout(groups):
    got = result(groups, "checks")["hang"]
    assert got["error"] is not None
    assert HANG_S - 1 <= got["seconds"] < HANG_S + 5, got


def test_multihost_dryrun_launcher_on_cpu(groups):
    d, codes, logs = groups["dryrun"]
    assert codes == [0], logs[0]
    rep = json.loads(logs[0].strip().splitlines()[-1])
    assert rep["ok"] and len(rep["ranks"]) == 2
    for r in rep["ranks"]:
        assert all(r[k]["ok"] and r[k]["equal"] for k in SCHEDULES
                   + ["continuous_pp_x_tp", "galaxy_tp2"])
        assert r["galaxy_tp2"]["engaged"] > 0
        assert r["transport"] == "gloo"


if __name__ == "__main__":
    sys.exit(worker(sys.argv[1], int(sys.argv[2])))
