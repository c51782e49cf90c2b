"""One rank of the two-process tensor-parallel check
(tests/test_torch_tp_dist.py): the tiny f32 pair of `tiny_tp_setup` (the
same seeded weights in every process) through `TPEngine` on a
`torch.distributed` mesh over gloo, plain and galaxy; rank 0 writes the
tokens, the stats and the gathered KV to the output directory.

    python tests/torch_tp_dist_worker.py <rank> <world> <port> <out_dir>
"""

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_NEW = 16


def tiny_tp_setup():
    """(params, draft, cfg, prompt): tests/test_tp.py's model shape (8
    query heads on 4 KV heads, vocab 64, f32), weights from a seeded
    generator."""
    from flowspec_tpu_torch.config import (
        EngineConfig, ModelConfig, SamplingConfig, TreeConfig)
    from flowspec_tpu_torch.draft.eagle import init_eagle_params
    from flowspec_tpu_torch.entry import random_llama
    mc = ModelConfig(vocab_size=64, hidden_size=64, intermediate_size=128,
                     num_hidden_layers=2, num_attention_heads=8,
                     num_key_value_heads=4, max_position_embeddings=512,
                     dtype="float32")
    tc = TreeConfig(top_k=6, depth=3, total_tokens=15, expand_tokens=8,
                    expand_depth=2, node_cap=32, leaf_cap=32, depth_cap=10,
                    chunk_len=8)
    cfg = EngineConfig(model=mc, tree=tc, sampling=SamplingConfig(),
                       max_seq_len=256, prefill_chunk=16)
    gen = torch.Generator().manual_seed(3)
    params = random_llama(mc, gen, "cpu")
    draft = init_eagle_params(gen, mc, embed=params.embed)
    prompt = np.random.default_rng(0).integers(3, 60, 11).tolist()
    return params, draft, cfg, prompt


def run(eng, prompt):
    """(tokens, stats, the gathered state) of one request."""
    out, stats, st = eng.generate(prompt, max_new_tokens=N_NEW,
                                  eos_token_id=-1, return_state=True)
    return out, stats, eng.gather_state(st)


def main(rank: int, world: int, port: int, out_dir: str) -> int:
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    import torch.distributed as dist
    from flowspec_tpu_torch.parallel import TPEngine, init_multihost, tp_mesh
    init_multihost(f"127.0.0.1:{port}", world, rank, device="cpu")
    params, draft, cfg, prompt = tiny_tp_setup()
    mesh = tp_mesh(world, distributed=True)
    result = {}
    for name, galaxy in (("tp", False), ("galaxy", True)):
        eng = TPEngine(params, draft, cfg, mesh=mesh, galaxy=galaxy,
                       device="cpu")
        assert eng.init_state().base_cache.k.shape[2] == 4 // world
        out, stats, whole = run(eng, prompt)
        result[name] = {"tokens": out, "stats": stats}
        if galaxy:
            result[name]["engaged"] = eng.forward_fn.engaged
        if rank == 0:
            np.save(os.path.join(out_dir, f"{name}_k.npy"),
                    whole.base_cache.k.numpy())
    if rank == 0:
        with open(os.path.join(out_dir, "result.json"), "w") as f:
            json.dump(result, f)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                  sys.argv[4]))
