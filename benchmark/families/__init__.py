"""One module a model family, found by a configuration's "family" key
(`lib/spec.py family`). Every family defines `model_config(cfg)` (the
port's ModelConfig), `draw(cfg, draw)` (the base's weights from the seed,
a dict of plain tensors the reference reads too), `port_params(w)` (the
port's params over those same tensors) and `draft(cfg, draw, w)` (the
draft the port serves with).

Where a family's architecture meets the harness, it may define hooks;
where it defines none, the harness uses the default of the LLaMA-style
families here (Qwen2, and Mixtral with its one probe):
- `reference_logits(w, cfg, seqs, rows, weight, dtype, margins)`, or
  `REFERENCE`, the name of a module under `reference/` whose
  `next_token_logits` has that signature: the plain reference that decides
  `correct`, plain PyTorch in float32 with TF32 off, importing nothing of
  the program. Default: `reference/decoder.py`, the LLaMA decoder with an
  optional Mixtral MLP (head dim `head_dim`, else hidden / heads).
- `work(cfg, mix)`: the object that becomes `run.dims`. The readers ask it
  `attention_bound_s(reqs)`, `int8_bound_s(reqs)`, `head_bound_s(reqs)`,
  `moe_bound_s(reqs)` (seconds) and `model_flops(reqs)`; for a kernel the
  family does not launch it answers None, and the reader reports nothing.
  Default: `lib/work.py Dims`.
- `expert_gemm_names(eng, cfg, mix, device)`: the GEMM kernels of the
  expert products, probed once set-up is done, which the trace counts as
  `moe_experts`. Default: none. Mixtral's is `lib/trace.py moe_gemm_names`.
- `KERNEL_FAMILIES`: (substring of the lower-cased kernel name, family)
  pairs for kernels the family's path adds, consulted in its cells before
  the frozen ones of `lib/trace.py`. Default: none.
"""
