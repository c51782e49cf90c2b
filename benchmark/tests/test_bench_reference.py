"""The plain reference against itself, and a sound run of the port held
to it, at a tiny Qwen2 and a tiny Mixtral on the CPU."""

import pytest
import torch

from benchmark import run
from benchmark.families.common import Draw
from benchmark.lib import spec
from benchmark.reference import decoder, precision
from benchmark.tests import tiny


def drawn(cell, tmp_path):
    root, bench = tiny.make_root(tmp_path)
    c = spec.cell(bench, cell)
    cfg = spec.config(c["config"], root)
    gen = torch.Generator().manual_seed(3)
    w = spec.family(cfg["family"]).draw(cfg, Draw(gen, "cpu", torch.float32))
    return dict(cfg, head_dim=cfg["hidden_size"]
                // cfg["num_attention_heads"]), w


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_reference_is_causal_and_blockwise(cell, tmp_path, monkeypatch):
    cfg, w = drawn(cell, tmp_path)
    seq = torch.randint(0, cfg["vocab_size"], (37,),
                        generator=torch.Generator().manual_seed(4))
    full = decoder.next_token_logits(w, cfg, [seq], [torch.arange(37)])[0]
    # a prefix gives the same logits: nothing reads a later position
    for n in (1, 20):
        part = decoder.next_token_logits(w, cfg, [seq[:n]],
                                         [torch.arange(n)])[0]
        torch.testing.assert_close(part, full[:n], rtol=1e-5, atol=1e-5)
    # query blocks of 8 rows give the same logits as one block
    monkeypatch.setattr(decoder, "QUERY_BLOCK", 8)
    blocked = decoder.next_token_logits(w, cfg, [seq], [torch.arange(37)])[0]
    torch.testing.assert_close(blocked, full, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_lower_precision_moves_the_logits(cell, tmp_path):
    cfg, w = drawn(cell, tmp_path)
    seq = torch.randint(0, cfg["vocab_size"], (16,),
                        generator=torch.Generator().manual_seed(5))
    rows = [torch.arange(16)]
    exact = decoder.next_token_logits(w, cfg, [seq], rows)[0]
    lower = decoder.next_token_logits(
        w, cfg, [seq], rows,
        precision.LOWER[cfg["weights"]["precision"]])[0]
    assert (exact - lower).abs().max() > 1e-3


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_a_sound_run_is_correct(cell, tmp_path):
    root, bench = tiny.make_root(tmp_path)
    res = run.run_cell(cell, 2**31 + 11, 0.5, False, "cpu", root=root,
                       bench=bench)
    assert res["correct"], res["check"]
    gap = res["check"].get("max_gap", res["check"].get("decided_mean_gap"))
    assert gap["value"] < 1e-4
    assert res["attempted"] >= 4 and res["failed"] == 0
