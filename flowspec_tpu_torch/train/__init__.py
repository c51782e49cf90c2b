"""Training on the card: the counterparts of the JAX package's trainers.

`tools/train_bench_draft.py` (a thin EAGLE draft distilled on a random
quantized base's greedy rollouts), `tools/train_tiny_draft.py` (the tiny
trained-draft fixtures) and `tools/train_struct_base.py` (a base trained on
the structured corpus, then its draft) as `python -m
flowspec_tpu_torch.train.bench_draft`, `.tiny_draft` and `.struct_base`.
The differentiable part (`forward.py`, `losses.py`) is products, norms and
a dense softmax attention in plain PyTorch, as JAX computes it outside any
Pallas kernel; the kernels run where nothing needs a gradient: the greedy
rollouts, the teacher's hiddens (`teacher.py`) and the evaluation through
`SpecEngine`. The optimizer (`optim.py`) is optax's `adamw` over a cosine
decay.
"""
