"""Quantization containers and the kernel wrappers (int8 dequant-matmul,
tree attention, latent attention, fused head top-k), each beside its plain
PyTorch version."""

from functools import lru_cache


@lru_cache(maxsize=None)
def counted_wrappers() -> dict:
    """{name: wrapper} of every kernel entry point that counts its launches
    in `wrapper.launches`, the comparison-only ones included (the wrappers
    themselves, as first imported: a caller that routes a module's name to
    another function does not change whose count this reads)."""
    from flowspec_tpu_torch.ops import head_topk as hk
    from flowspec_tpu_torch.ops import mla_attention as ma
    from flowspec_tpu_torch.ops import quant_matmul as qm
    from flowspec_tpu_torch.ops import tree_attention as ta
    return {"int8_matmul": qm.int8_matmul, "tree_attention": ta.tree_attention,
            "head_topk": hk.head_topk, "nf4_matmul": qm.nf4_matmul,
            "int4_matmul": qm.int4_matmul,
            "int4_matmul_smallm": qm.int4_matmul_smallm,
            "int8_matmul_strip": qm.int8_matmul_strip,
            "nf4_matmul_strip": qm.nf4_matmul_strip,
            "int4_matmul_strip": qm.int4_matmul_strip,
            "tree_attention_simt": ta.tree_attention_simt,
            "head_topk_strip": hk.head_topk_strip,
            "int4_matmul_splitk": qm.int4_matmul_splitk,
            "mla_attention": ma.mla_attention}
