"""What the base gives the draft to learn from, with the kernels on the card.

Nothing here needs a gradient, so it runs under `torch.no_grad()` through
the serving code: greedy rollouts through `SpecEngine.generate_ar_fused`
(`tools/train_bench_draft.py:121-138`, `train_tiny_draft.py:88`), and the
teacher's final-norm hiddens by one prefill of `lanes` sequences a call
(`:143-153`, `train_struct_base.py:321-331`), its KV rows rounded up to
256 as the attention kernel reads them (the JAX struct tool rounds to 64;
the bias masks the rows past the sequence, so the hiddens are the same).

The corpus (rollouts and hiddens) can be kept in a file whose name says the
port wrote it and for which base (`corpus_path`): the JAX tool's cache
(`/tmp/flowspec_corpus_*.npz`) holds another base's hiddens.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from flowspec_tpu_torch.config import ModelConfig
from flowspec_tpu_torch.models import model_forward
from flowspec_tpu_torch.models.bias import prefill_bias
from flowspec_tpu_torch.models.kv_cache import init_kv_cache
from flowspec_tpu_torch.models.llama import embed_tokens, final_hidden

KV_ROUND = 256


@torch.no_grad()
def greedy_rollouts(eng, prompts, gen_tokens: int) -> np.ndarray:
    """(N, P + gen_tokens) int32: each prompt and the base's greedy
    continuation, EOS off, through `eng.generate_ar_fused` (one captured
    CUDA graph of the AR step on the card)."""
    seqs = []
    for prompt in prompts:
        out, _ = eng.generate_ar_fused(prompt, max_new_tokens=gen_tokens,
                                       eos_token_id=-1)
        seqs.append(np.asarray(out[:len(prompt) + gen_tokens], np.int32))
    return np.stack(seqs)


@torch.no_grad()
def teacher_hiddens(params, tokens, mc: ModelConfig,
                    lanes: int = 1) -> torch.Tensor:
    """(N, T, H) final-norm hiddens of the base over (N, T) tokens, in the
    params' working dtype on their device: one prefill a call of `lanes`
    sequences (the last call may hold fewer) into fresh caches of T rows
    rounded up to KV_ROUND."""
    dev = params.embed.device
    dt = getattr(torch, mc.dtype)
    tokens = torch.as_tensor(tokens).to(dev)
    n, t = tokens.shape
    rows = -(-t // KV_ROUND) * KV_ROUND
    bias = prefill_bias(0, t, rows, device=dev)
    pos = torch.arange(t, device=dev)
    out = []
    for i in range(0, n, lanes):
        seqs = tokens[i:i + lanes]
        cache = init_kv_cache(mc.num_hidden_layers, seqs.shape[0],
                              mc.num_key_value_heads, rows, mc.head_dim_,
                              dt, dev)
        x, _ = model_forward(params, cache, embed_tokens(params, seqs), pos,
                             bias, 0, mc)
        out.append(final_hidden(params, x, mc))
    return torch.cat(out)


def corpus_path(cache_dir, base_law: str, seed: int, n: int,
                seq_len: int) -> Path:
    """The port's corpus file for a base named by `base_law` (its scale,
    kind and how it was drawn or loaded) and `seed`."""
    return Path(cache_dir) / (f"flowspec_torch_corpus_{base_law}_seed{seed}_"
                              f"{n}x{seq_len}.npz")


def save_corpus(path, tokens: np.ndarray, hiddens: torch.Tensor,
                base_law: str) -> None:
    """Tokens and hiddens (bf16 kept as its bits) with the base's law."""
    h = hiddens.cpu()
    bits = (h.view(torch.int16).numpy() if h.dtype == torch.bfloat16
            else h.numpy())
    np.savez(path, tokens=tokens, hiddens=bits, base_law=base_law,
             hiddens_dtype=str(h.dtype).replace("torch.", ""))


def load_corpus(path, base_law: str, device):
    """(tokens, hiddens) from `save_corpus`; a file of another base
    raises."""
    with np.load(path) as z:
        if str(z["base_law"]) != base_law:
            raise ValueError(f"{path} holds the corpus of {z['base_law']}, "
                             f"not of {base_law}")
        h = torch.from_numpy(z["hiddens"])
        if str(z["hiddens_dtype"]) == "bfloat16":
            h = h.view(torch.bfloat16)
        return z["tokens"], h.to(device)
