"""Card-only tests: each CUDA kernel of flowspec_tpu_torch against its plain
PyTorch version on the same CUDA tensors, at several shapes (ragged M, T
and n_valid included), plus the head top-k tie order and the wrappers'
refusals. Marked `cuda`; they skip without a card, decided inside the
`cuda` fixture (never at import, so every xdist worker collects the same
tests). On a machine with a card and the CUDA toolkit:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX, which these tests do not
use.) Tolerances: int8, nf4, int4 and attention outputs are bf16, compared
at one bf16 rounding (1e-2 relative + 1e-2, and 2e-2 absolute); head
log-probs are f32 sums of H terms, compared at 1e-3. The stream-K kernels
(int8, nf4, int4, small-M int4), the head top-k and the cluster-joined tree
attention must give equal bits on every launch (no atomics); all six are
also held against their earlier versions (`*_strip`, `int4_matmul_splitk`,
`tree_attention_simt`, `head_topk_strip`), whose launches count apart.
The attention with a device n_valid (a grid for the whole allocation,
splits past the live tiles empty) must give the bits of the host-n_valid
grid; on a tiny model, a replayed CUDA graph of the decode loop's body must
give the eager body's bits, replay after replay; the lm_head's f32-output
GEMM must stay within f32 summation order of the f32 product (2e-3 abs,
1e-3 relative: sums of H = 4096 exact bf16 products) and make no f32 copy
of the head. The model families' shapes: attention at Qwen2-7B's G 7 (4 KV
heads) and Mixtral's G 4 (8 KV heads), head top-k at Qwen2's V 152064 (1188
strips, keys merged from device memory) with a tie across strips; a tiny
Mixtral's round captured and replayed with the eager round's bits; the
loaders and checkpoints put every tensor on the card when no device is
named. Lanes: the attention kernel over B lanes (each with its own bias and
live rows, read per lane) against plain, lane b bit-equal to a one-lane
launch of lane b; the gated lane loop's graph replayed with the eager lane
body's bits; a second `serve` call with the same lanes and queue capacity,
and a `serve` after `warmup`, capture no graph. Streaming and the dynamic
modes: the tree variants of one width captured over one set of buffers (a
variant switch copies no lane state), a width switch moving lanes by JAX's
permutation, `serve_stream` through graphs equal to its eager body, no
capture after `warmup`, and a capture's launch tally unchanged by a cold
prefix built in a thread. The pipeline (`parallel/pipeline.py`): every
schedule of a tiny int8 pipeline with empty stages on the card against the
same engine on the CPU under the lossless rule (a first divergence only at
a top-2 gap < 0.05), KV rows a multiple of 256, at most three flag reads a
turn, generate_fused equal to generate, and a resume. Tensor parallelism
(`parallel/tp.py`, in-process ranks): the tiny int8 pair at tp 2 / 4 on the
card against the same engine on the CPU under the lossless rule, a TP
round's graph replayed with the eager body's bits, the int8 kernel at the
7B pair's shard widths (64-column strips at Out 2752 / 704), galaxy at tp 2
against plain TP, and `entry.dryrun_multichip(4)`. The evaluation path:
`run_eval` (fused, and with the resume) and `run_eval_serve` (two turns, a
ConversationStore that keeps or evicts) on the struct tiny8 pair in bf16
(head dim 64) through the port's struct loaders, each answer against AR
under the lossless rule; the profiler's readings of the CUDA allocator;
the recorder's round, prefill and growth spans with device figures from
timing events made once per engine and graph, never per replay.
Stream-K and the split cut: every product shape of the benchmark cells
(Qwen2-7B's base and draft, Mixtral-8x7B's draft, a ragged M 19 prefill
chunk) against plain with equal bits on two launches and the split tiles
counted; a captured product of each cut replayed three times with the eager
bits and the flags left zero; one profiled launch of each cut, every kernel
of the benchmark's `int8_matmul` family.
Training: every kernel wrapper refuses, naming itself, an operand that
requires a gradient under grad mode (and launches as before under
`torch.no_grad()`); one step of a tiny base and of its draft on the card
gives every field a gradient and launches no kernel.
DeepSeek-V3: the latent-attention kernel against its plain version at 128
heads, 576-wide rows and 512 values, T 64 / 81 / 96, 1-4096 live keys read
from the card (the host count's bits), and two lanes against one-lane
launches; a tiny DeepSeek's round graph replayed with the eager bits.
"""

import pytest
import torch

from flowspec_tpu_torch.ops.head_topk import (
    head_logits, head_plan, head_topk, head_topk_int8, head_topk_plain,
    head_topk_strip)
from flowspec_tpu_torch.ops.quant import Int8Tensor
from flowspec_tpu_torch.ops.quant_matmul import (
    int4_matmul, int4_matmul_plain, int4_matmul_smallm, int4_matmul_splitk,
    int4_matmul_strip, int4_matmul_wide, int8_matmul, int8_matmul_plain,
    int8_matmul_strip, matmul_plan, nf4_matmul, nf4_matmul_plain,
    nf4_matmul_strip)
from flowspec_tpu_torch.ops.tree_attention import (
    attention_plan, kernel_keys, live_keys, tree_attention,
    tree_attention_plain, tree_attention_simt)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


@pytest.mark.parametrize("m,n_in,n_out", [
    (1, 4096, 4096), (7, 64, 96), (10, 1024, 2816), (17, 8192, 1024),
    (33, 128, 64), (64, 4096, 11008), (81, 11008, 4096), (130, 256, 640)])
def test_int8_matmul_matches_plain(cuda, m, n_in, n_out):
    x = torch.randn((1, m, n_in), generator=cuda, device="cuda").to(
        torch.bfloat16)
    q = torch.randint(-127, 128, (n_in, n_out), generator=cuda,
                      device="cuda").to(torch.int8)
    s = torch.rand((n_out,), generator=cuda, device="cuda") * n_in ** -0.5 / 64
    before = int8_matmul.launches
    got = int8_matmul(x, q, s)
    want = int8_matmul_plain(x, q, s)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1
    err = (got.float() - want.float()).abs()
    assert bool((err <= 1e-2 * want.float().abs() + 1e-2).all()), err.max()


def _packed4(gen, m, n_in, n_out, step):
    x = torch.randn((1, m, n_in), generator=gen, device="cuda").to(
        torch.bfloat16)
    q = torch.randint(0, 256, (n_in // 2, n_out), generator=gen,
                      device="cuda").to(torch.uint8)
    s = (torch.rand((n_in // 64, n_out), generator=gen, device="cuda") + 0.5
         ) * n_in ** -0.5 * step
    return x, q, s


def _close(got, want):
    err = (got.float() - want.float()).abs()
    return bool((err <= 1e-2 * want.float().abs() + 1e-2).all()), err.max()


# one small and the path's shapes: 7B base and thin draft at every M
@pytest.mark.parametrize("m,n_in,n_out", [
    (1, 64, 32), (7, 128, 96), (1, 4096, 4096), (10, 1024, 2816),
    (9, 8192, 1024), (33, 256, 64), (64, 4096, 11008), (81, 11008, 4096),
    (130, 256, 640)])
def test_nf4_matmul_matches_plain(cuda, m, n_in, n_out):
    x, q, s = _packed4(cuda, m, n_in, n_out, 1.0)
    before = nf4_matmul.launches
    got = nf4_matmul(x, q, s)
    want = nf4_matmul_plain(x, q, s)
    torch.cuda.synchronize()
    assert nf4_matmul.launches == before + 1
    ok, err = _close(got, want)
    assert ok, err


# the stream-K wgmma kernels at ragged shapes: Out a multiple of 32 but not
# of 64 and of 64 but not of 128, In = 64 (one block, never split), In / 64
# prime (ranges that do not divide the tiles), M around every width
RAGGED = [(m, n_in, n_out)
          for n_in, n_out in ((832, 1056), (2368, 1088), (64, 1056),
                              (2368, 4096))
          for m in (1, 8, 17, 81, 96, 130)]


def _int8(gen, m, n_in, n_out):
    x = torch.randn((1, m, n_in), generator=gen, device="cuda").to(
        torch.bfloat16)
    q = torch.randint(-127, 128, (n_in, n_out), generator=gen,
                      device="cuda").to(torch.int8)
    s = (torch.rand((n_out,), generator=gen, device="cuda") + 0.5
         ) * n_in ** -0.5 / 127
    return x, q, s


@pytest.mark.parametrize("kind", ["int8", "nf4", "int4"])
@pytest.mark.parametrize("m,n_in,n_out", RAGGED + [
    (1, 4096, 4096), (10, 8192, 1024), (64, 4096, 11008), (81, 11008, 4096),
    (64, 5120, 5120), (81, 5120, 5120)])
def test_wgmma_matmul_equal_bits_and_agrees_with_strip(cuda, kind, m, n_in,
                                                       n_out):
    counter = None
    if kind == "int8":
        x, q, s = _int8(cuda, m, n_in, n_out)
        new, strip, plain = int8_matmul, int8_matmul_strip, int8_matmul_plain
    elif kind == "nf4":
        x, q, s = _packed4(cuda, m, n_in, n_out, 1.0)
        new, strip, plain = nf4_matmul, nf4_matmul_strip, nf4_matmul_plain
    else:     # the wgmma kernel at every M (int4_matmul's own path: M > 32)
        x, q, s = _packed4(cuda, m, n_in, n_out, 1 / 7)
        new, strip, plain = int4_matmul_wide, int4_matmul_strip, \
            int4_matmul_plain
        counter = int4_matmul
    counter = counter or new
    before = counter.launches, strip.launches
    got, again, old = new(x, q, s), new(x, q, s), strip(x, q, s)
    want = plain(x, q, s)
    torch.cuda.synchronize()
    assert (counter.launches, strip.launches) == (before[0] + 2,
                                                  before[1] + 1)
    ok, err = _close(got, want)
    assert ok, (err, matmul_plan(m, n_in, n_out, kind))
    ok, err = _close(got, old)
    assert ok, err
    assert torch.equal(got, again)        # fixed-order reduction, no atomics


# wide kernel: 13B wq at prefill and verify width, and ragged small shapes
@pytest.mark.parametrize("m,n_in,n_out", [
    (33, 128, 96), (40, 256, 64), (64, 5120, 5120), (81, 5120, 5120),
    (130, 192, 640)])
def test_int4_matmul_wide_matches_plain(cuda, m, n_in, n_out):
    x, q, s = _packed4(cuda, m, n_in, n_out, 1 / 7)
    before = int4_matmul.launches, int4_matmul_smallm.launches
    got = int4_matmul(x, q, s)
    want = int4_matmul_plain(x, q, s)
    torch.cuda.synchronize()
    assert (int4_matmul.launches, int4_matmul_smallm.launches) == (
        before[0] + 1, before[1])
    ok, err = _close(got, want)
    assert ok, err


# small-M entry: 13B wq, the 7B w_down whose half-In has no divisor that is
# a multiple of 256, strips of 32 / 64 / 128 columns, a single 64-row block,
# both widths (16 up to 16 rows, 64 above); against the plain version and the
# earlier split-K kernel
@pytest.mark.parametrize("m,n_in,n_out", [
    (1, 64, 32), (5, 128, 96), (17, 256, 64), (1, 5120, 5120),
    (9, 5120, 5120), (16, 5120, 5120), (17, 5120, 5120), (32, 5120, 5120),
    (1, 11008, 4096), (10, 10240, 1280)])
def test_int4_matmul_smallm_matches_plain_with_equal_bits(cuda, m, n_in,
                                                          n_out):
    x, q, s = _packed4(cuda, m, n_in, n_out, 1 / 7)
    counters = (int4_matmul, int4_matmul_smallm, int4_matmul_splitk)
    before = [c.launches for c in counters]
    got = int4_matmul(x, q, s)            # dispatches on M <= 32
    again = int4_matmul_smallm(x, q, s)
    old = int4_matmul_splitk(x, q, s)
    want = int4_matmul_plain(x, q, s)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [before[0], before[1] + 2,
                                              before[2] + 1]
    ok, err = _close(got, want)
    assert ok, (err, matmul_plan(m, n_in, n_out, "int4"))
    ok, err = _close(got, old)
    assert ok, err
    assert torch.equal(got, again)        # fixed-order reduction


def test_two_libraries_with_one_instantiation_each_opt_in(cuda):
    # the width-64 int4 kernel (77 KB of dynamic shared memory) is built in
    # the wide and in the small-M library; each must make its own opt-in,
    # whichever launches first
    x, q, s = _packed4(cuda, 17, 256, 128, 1 / 7)
    want = int4_matmul_plain(x, q, s)
    for fn in (int4_matmul_wide, int4_matmul_smallm, int4_matmul_wide):
        ok, err = _close(fn(x, q, s), want)
        assert ok, err


def test_small_m_int4_counts_under_smallm_and_old_entries_stay_at_zero(cuda):
    olds = (int4_matmul_strip, int4_matmul_splitk, int8_matmul_strip,
            nf4_matmul_strip, head_topk_strip, tree_attention_simt)
    before = [c.launches for c in olds]
    n = int4_matmul.launches, int4_matmul_smallm.launches
    for m in (1, 9, 16, 17, 32, 33):
        x, q, s = _packed4(cuda, m, 256, 128, 1 / 7)
        int4_matmul(x, q, s)
    x = torch.randn((10, 256), generator=cuda, device="cuda").to(
        torch.bfloat16)
    head_topk(x, Int8Tensor(q=torch.ones((256, 1024), dtype=torch.int8,
                                         device="cuda"),
                            scale=torch.ones((1024,), device="cuda")), 4)
    torch.cuda.synchronize()
    assert (int4_matmul.launches, int4_matmul_smallm.launches) == (
        n[0] + 1, n[1] + 5)
    assert [c.launches for c in olds] == before


def _attn(gen, nq, nkv, t, s_max, d, n_valid):
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for shape in ((1, nq, t, d), (1, nkv, s_max, d),
                                      (1, nkv, s_max, d)))
    ctx = n_valid - t
    tree = (torch.rand((t, t), generator=gen, device="cuda") < 0.4).tril()
    tree |= torch.eye(t, dtype=torch.bool, device="cuda")
    bias = torch.full((t, s_max), -1e9, device="cuda")
    bias[:, :ctx] = 0.0
    bias[:, ctx:n_valid] = torch.where(tree, 0.0, -1e9)
    return q, k, v, bias


@pytest.mark.parametrize("g,t,d,n_valid", [
    (1, 1, 128, 1), (1, 10, 128, 37), (1, 81, 128, 209), (4, 96, 64, 300),
    (4, 10, 128, 511), (1, 64, 128, 64), (2, 33, 64, 257)])
def test_tree_attention_matches_plain(cuda, g, t, d, n_valid):
    nkv, s_max = 4, 512
    q, k, v, bias = _attn(cuda, nkv * g, nkv, t, s_max, d, n_valid)
    before = tree_attention.launches
    got = tree_attention(q, k, v, bias, n_valid)
    want = tree_attention_plain(q, k, v, bias, live_keys(s_max, n_valid))
    torch.cuda.synchronize()
    assert tree_attention.launches == before + 1
    assert float((got.float() - want.float()).abs().max()) <= 2e-2


# the redesigned kernel against the plain version and the earlier kernel:
# GQA groups, both head dims, n_valid on both sides of 256 (the late verify
# rounds), a cache of 2560 rows (several 64-key tiles a split)
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t,n_valid,s_max", [
    (1, 200, 512), (10, 230, 512), (81, 209, 512), (81, 256, 512),
    (81, 273, 512), (96, 512, 512), (17, 1100, 2560)])
def test_tree_attention_new_vs_plain_vs_simt_equal_bits(cuda, g, d, t,
                                                        n_valid, s_max):
    nkv = 4
    q, k, v, bias = _attn(cuda, nkv * g, nkv, t, s_max, d, n_valid)
    before = tree_attention.launches, tree_attention_simt.launches
    got = tree_attention(q, k, v, bias, n_valid)
    again = tree_attention(q, k, v, bias, n_valid)
    old = tree_attention_simt(q, k, v, bias, n_valid)
    want = tree_attention_plain(q, k, v, bias, live_keys(s_max, n_valid))
    torch.cuda.synchronize()
    assert (tree_attention.launches, tree_attention_simt.launches) == (
        before[0] + 2, before[1] + 1)
    plan = attention_plan(nkv, g, t, kernel_keys(s_max, n_valid))
    assert float((got.float() - want.float()).abs().max()) <= 2e-2, plan
    assert float((got.float() - old.float()).abs().max()) <= 2e-2, plan
    assert torch.equal(got, again)        # the cluster joins in fixed order


def _head(gen, t, h, v, scale=4.0):
    x = (torch.randn((t, h), generator=gen, device="cuda") * scale).to(
        torch.bfloat16)
    q = torch.randint(-127, 128, (h, v), generator=gen,
                      device="cuda").to(torch.int8)
    s = torch.full((v,), h ** -0.5 / 127.0, device="cuda")
    return x, q, s


def _plain_lp_of(x, q, s, tok):
    logits = head_logits(x, Int8Tensor(q=q, scale=s))
    return logits.gather(1, tok.long()) - torch.logsumexp(
        logits, -1, keepdim=True)


# the path's T 1 and 10, both sides of the width boundary (16 / 17), a
# second row tile (65), 17 strips, k 1 and k 128, and k 32 at V 32000, whose
# 64 KB of keys a row the merge reads from device memory instead of staging
@pytest.mark.parametrize("t,h,v,k", [
    (1, 4096, 32000, 10), (10, 4096, 32000, 10), (16, 4096, 32000, 10),
    (17, 4096, 32000, 10), (10, 5120, 32000, 10), (17, 256, 2048, 5),
    (40, 128, 1024, 16), (65, 256, 2176, 10), (10, 4096, 2176, 1),
    (3, 128, 256, 128), (4, 256, 32000, 32)])
def test_head_topk_matches_plain(cuda, t, h, v, k):
    x, q, s = _head(cuda, t, h, v)
    before = head_topk.launches, head_topk_strip.launches
    lp, tok = head_topk(x, Int8Tensor(q=q, scale=s), k)
    lp2, tok2 = head_topk_int8(x, q, s, k)
    old_lp, _ = head_topk_strip(x, q, s, k)
    want_lp, _ = head_topk_plain(x, q, s, k)
    torch.cuda.synchronize()
    assert (head_topk.launches, head_topk_strip.launches) == (
        before[0] + 2, before[1] + 1)
    # the kernel's tokens carry exactly the plain top-k log-probs (a pick
    # that differs only at an f32 summation-order near-tie is still exact)
    plan = head_plan(t, h, v)
    assert float((lp - want_lp).abs().max()) <= 1e-3, plan
    assert float((_plain_lp_of(x, q, s, tok) - want_lp).abs().max()) <= 1e-3
    assert float((lp - old_lp).abs().max()) <= 1e-3
    assert bool((tok[:, :-1] != tok[:, 1:]).all())
    assert torch.equal(lp, lp2) and torch.equal(tok, tok2)   # no atomics


def test_head_topk_tie_goes_to_lowest_index(cuda):
    h, v, k = 512, 4096, 6
    x = torch.randn((3, h), generator=cuda, device="cuda").to(torch.bfloat16)
    q = torch.randint(-127, 128, (h, v), generator=cuda,
                      device="cuda").to(torch.int8)
    s = torch.full((v,), h ** -0.5 / 127.0, device="cuda")
    best = int(head_logits(x, Int8Tensor(q=q, scale=s))[0].argmax())
    for dup in (v - 1, v // 2 + 3):       # copies in other column blocks
        q[:, dup] = q[:, best]
    lp, tok = head_topk_int8(x, q, s, k)
    _, want_tok = head_topk_plain(x, q, s, k)
    torch.cuda.synchronize()
    assert torch.equal(tok, want_tok)
    assert tok[0, :3].tolist() == sorted([best, v - 1, v // 2 + 3])
    assert lp[0, 0] == lp[0, 1] == lp[0, 2]


@pytest.mark.parametrize("where", ["inside_strip", "across_strips"])
@pytest.mark.parametrize("fn", [head_topk_int8, head_topk_strip])
def test_head_topk_ties_inside_and_across_strips(cuda, where, fn):
    x, q, s = _head(cuda, 2, 4096, 32000, scale=1.0)
    best = int(head_logits(x, Int8Tensor(q=q, scale=s))[1].argmax())
    dup = (best - best % 128 + (best % 128 + 37) % 128
           if where == "inside_strip" else (best + 128 * 97) % 32000)
    q[:, dup], s[dup] = q[:, best], s[best]
    lp, tok = fn(x, q, s, 10)
    _, want_tok = head_topk_plain(x, q, s, 10)
    torch.cuda.synchronize()
    assert torch.equal(tok[1], want_tok[1])
    assert tok[1, :2].tolist() == sorted([best, dup])
    assert lp[1, 0] == lp[1, 1]


def test_wrappers_refuse_instead_of_falling_back(cuda):
    x = torch.randn((1, 4, 64), device="cuda")              # f32, not bf16
    q = torch.zeros((64, 32), dtype=torch.int8, device="cuda")
    s = torch.ones((32,), device="cuda")
    with pytest.raises(TypeError):
        int8_matmul(x, q, s)
    with pytest.raises(ValueError):                         # Out % 32 != 0
        int8_matmul(x.bfloat16(), q[:, :24].contiguous(), s[:24])
    qa = torch.zeros((1, 2, 3, 96), dtype=torch.bfloat16, device="cuda")
    kv = torch.zeros((1, 2, 256, 96), dtype=torch.bfloat16, device="cuda")
    for fn in (tree_attention, tree_attention_simt):
        with pytest.raises(ValueError):                     # D = 96
            fn(qa, kv, kv, torch.zeros((3, 256), device="cuda"))
        with pytest.raises(TypeError):                      # f32 q
            fn(qa[..., :64].float().contiguous(), kv[..., :64].contiguous(),
               kv[..., :64].contiguous(), torch.zeros((3, 256), device="cuda"))
    for fn in (head_topk_int8, head_topk_strip):
        with pytest.raises(TypeError):                      # f32 x
            fn(x[0], q, s, 4)
        with pytest.raises(ValueError):                     # V % 128 != 0
            fn(x[0].bfloat16(), q, s, 4)
    q4 = torch.zeros((32, 32), dtype=torch.uint8, device="cuda")
    s4 = torch.ones((1, 32), device="cuda")
    with pytest.raises(TypeError):                          # f32 x
        int8_matmul_strip(x, q, s)
    with pytest.raises(ValueError):                         # q on the CPU
        int8_matmul(x.bfloat16(), q.cpu(), s)
    with pytest.raises(ValueError):                         # misaligned scale
        int8_matmul(x.bfloat16(), q, torch.ones((33,), device="cuda")[1:])
    counters = (int8_matmul, nf4_matmul, int4_matmul, int4_matmul_strip,
                int4_matmul_smallm, int4_matmul_splitk, tree_attention,
                tree_attention_simt, head_topk, head_topk_strip)
    before = [c.launches for c in counters]
    for fn in (nf4_matmul, nf4_matmul_strip, int4_matmul, int4_matmul_smallm,
               int4_matmul_wide, int4_matmul_strip, int4_matmul_splitk):
        with pytest.raises(TypeError):                      # f32 x
            fn(x, q4, s4)
        with pytest.raises(ValueError):                     # Out % 32 != 0
            fn(x.bfloat16(), q4[:, :24].contiguous(),
               s4[:, :24].contiguous())
    for fn in (int4_matmul_smallm, int4_matmul_splitk):
        with pytest.raises(ValueError):                     # 40 rows
            fn(torch.zeros((1, 40, 64), dtype=torch.bfloat16,
                           device="cuda"), q4, s4)
    # a refusal launches nothing, neither the kernel nor a stand-in for it
    assert [c.launches for c in counters] == before


# the device n_valid against the host n_valid: one live tile (1, 63, 64),
# a second (65), the verify's 209 and the whole allocation, at the two
# allocations of the main path (4 and 8 splits, most of them empty early)
# and the pipeline's 768 rows (6 splits of two tiles)
@pytest.mark.parametrize("s_max", [256, 512, 768])
@pytest.mark.parametrize("n_valid", [1, 63, 64, 65, 209, "S"])
@pytest.mark.parametrize("nkv,g,t", [(32, 1, 81), (8, 1, 10), (4, 4, 9)])
def test_tree_attention_device_n_valid_equals_host_bits(cuda, s_max, n_valid,
                                                        nkv, g, t):
    n_valid = s_max if n_valid == "S" else n_valid
    q, k, v, bias = _attn(cuda, nkv * g, nkv, max(t, 1), s_max, 128,
                          max(n_valid, t))
    if n_valid < t:                           # fewer live rows than queries
        bias[:, n_valid:] = -1e9
        bias[:, :n_valid] = 0.0
    nv = torch.tensor(n_valid, dtype=torch.int32, device="cuda")
    before = tree_attention.launches
    host = tree_attention(q, k, v, bias, n_valid)
    dev = tree_attention(q, k, v, bias, nv)
    want = tree_attention_plain(q, k, v, bias, live_keys(s_max, n_valid))
    torch.cuda.synchronize()
    assert tree_attention.launches == before + 2
    grid = attention_plan(nkv, g, t, s_max)   # the device n_valid's grid
    assert grid.tiles_per_split == (1 if s_max <= 512 else 2)
    assert grid.splits == -(-(s_max // 64) // grid.tiles_per_split)
    assert torch.equal(dev, host), float((dev.float()
                                         - host.float()).abs().max())
    assert float((dev.float() - want.float()).abs().max()) <= 2e-2


def _tiny_cuda_engine():
    """A 2-layer int8 LLaMA (H 256, D 64, V 1024) and an int8 draft of the
    same width, random from a seeded generator, on the card."""
    from flowspec_tpu_torch.config import (
        EngineConfig, ModelConfig, SamplingConfig, TreeConfig)
    from flowspec_tpu_torch.draft.eagle import (
        EagleParams, quantize_eagle_params)
    from flowspec_tpu_torch.models.llama import random_llama_params
    from flowspec_tpu_torch.runtime import SpecEngine
    mc = ModelConfig(vocab_size=1024, hidden_size=256, intermediate_size=512,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=4)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    params = random_llama_params(mc, gen, "cuda", "int8")
    h, i = mc.hidden_size, mc.intermediate_size
    w = lambda a, b: (torch.randn((a, b), generator=gen, device="cuda")
                      * a ** -0.5).to(torch.bfloat16)
    draft = quantize_eagle_params(EagleParams(
        embed=params.embed, fc_w=w(2 * h, h),
        fc_b=torch.zeros((h,), dtype=torch.bfloat16, device="cuda"),
        wq=w(h, h), wk=w(h, h), wv=w(h, h), wo=w(h, h), w_gate=w(h, i),
        w_up=w(h, i), w_down=w(i, h),
        post_ln=torch.ones((h,), dtype=torch.bfloat16, device="cuda")),
        "int8")
    tc = TreeConfig(top_k=8, depth=4, total_tokens=24, node_cap=48,
                    leaf_cap=48, depth_cap=12)
    cfg = EngineConfig(model=mc, tree=tc, sampling=SamplingConfig(),
                       max_seq_len=200, prefill_chunk=16)
    return SpecEngine(params, draft, cfg)


def test_graph_replay_equals_eager_round_bits(cuda):
    """The decode loop's body captured once and replayed five times gives,
    after every replay, the state and loop carry of the same body run
    eagerly, bit for bit; the wrappers count the graph's launches once a
    replay, generate_fused's stream equals generate's, and another
    request length reuses its graph."""
    from flowspec_tpu_torch.ops import counted_wrappers
    from flowspec_tpu_torch.runtime import graphs
    eng = _tiny_cuda_engine()
    prompt = list(range(3, 40))
    state = eng.prefill(eng.init_state(0), prompt)
    loop = graphs._loop_buffers(64, -1, state.commit_len.device)
    eager, eager_loop = graphs._clone(state), graphs._clone(loop)
    g = graphs.DecodeGraph(eng, graphs._spec_body, state, loop)
    assert g.launches["tree_attention"] == 2 + eng.cfg.tree.depth + 1
    counters = counted_wrappers()
    for _ in range(5):
        before = {n: fn.launches for n, fn in counters.items()}
        g.replay()
        for n, fn in counters.items():
            assert fn.launches - before[n] == g.launches.get(n, 0), n
        eager = graphs._spec_body(eng, eager, eager_loop)
        torch.cuda.synchronize()
        for a, b in zip(graphs._fields(g.state), graphs._fields(eager)):
            assert torch.equal(a, b)
        for a, b in zip(graphs._fields(g.loop), graphs._fields(eager_loop)):
            assert torch.equal(a, b)
    spec, stats = eng.generate(prompt, max_new_tokens=40, eos_token_id=-1)
    fused, fstats = eng.generate_fused(prompt, max_new_tokens=40,
                                       eos_token_id=-1)
    assert fused == spec and fstats["rounds"] == stats["rounds"]
    n_graphs = len(eng._graphs)        # keyed by bucket, not by length
    eng.generate_fused(prompt, max_new_tokens=24, eos_token_id=-1)
    assert len(eng._graphs) == n_graphs
    ar, _ = eng.generate_ar(prompt, max_new_tokens=20, eos_token_id=-1)
    ar_fused, _ = eng.generate_ar_fused(prompt, max_new_tokens=20,
                                        eos_token_id=-1)
    assert ar_fused == ar


def test_recorder_device_figures_on_a_captured_graph(cuda, monkeypatch):
    """With the recorder on, generate_fused over two KV buckets gives each
    round span the graph's device ms (> 0) and, past a segment's first
    round, the device's idle since the previous round (>= 0); the prefill
    finish and the growth carry device ms; the first request captures (a
    `capture` span each graph) and makes the timing events (a pair for the
    prefill, one for the growth, one a round of each graph's segment), and
    a second request makes no event and captures nothing."""
    import dataclasses
    from flowspec_tpu_torch.runtime import SpecEngine
    from flowspec_tpu_torch.utils.profiler import prof
    made, event = [], torch.cuda.Event

    def counted(*a, **kw):
        made.append(1)
        return event(*a, **kw)

    monkeypatch.setattr(torch.cuda, "Event", counted)
    tiny = _tiny_cuda_engine()
    eng = SpecEngine(tiny.params, tiny.draft, dataclasses.replace(
        tiny.cfg, max_seq_len=600, kv_buckets=(64, 512)))
    prompt = list(range(3, 40))
    prof.reset()
    prof.enabled = True
    try:
        first, stats = eng.generate_fused(prompt, max_new_tokens=40,
                                          eos_token_id=-1)
        n_made, n_spans = len(made), len(prof.spans)
        captures = [sp for sp in prof.spans if sp.name == "capture"]
        first_rounds = sum(sp.name == "round" for sp in prof.spans)
        second, _ = eng.generate_fused(prompt, max_new_tokens=40,
                                       eos_token_id=-1)
        spans = prof.spans[n_spans:]
    finally:
        prof.enabled = False
    prof.reset()
    off, _ = eng.generate_fused(prompt, max_new_tokens=40, eos_token_id=-1)
    assert first == second == off and stats["kv_buckets_used"] == 2
    assert first_rounds == stats["rounds"]
    assert n_made == 2 + 2 + 2 * first_rounds
    assert len(made) == n_made
    assert sorted((sp.t1_ns - sp.t0_ns) / 1e9 for sp in captures) == sorted(
        g.capture_s for g in eng._graphs.values())
    names = [sp.name for sp in spans]
    assert "capture" not in names and names.count("grow_kv") == 1
    rounds = [sp for sp in spans if sp.name == "round"]
    assert len(rounds) == stats["rounds"]
    assert all(sp.device_ms > 0 for sp in rounds)
    firsts = [i for i, sp in enumerate(spans) if sp.name == "segment.load"]
    for i, sp in enumerate(spans):
        if sp.name == "round":
            assert (sp.gap_ms is None) == (spans[i - 1].name
                                           == "segment.load"), i
            assert sp.gap_ms is None or sp.gap_ms >= 0
    assert len(firsts) == 2
    for name in ("prefill.finish", "grow_kv"):
        (sp,) = [sp for sp in spans if sp.name == name]
        assert sp.device_ms > 0, name


def test_lm_head_logits_no_f32_copy_of_the_head(cuda):
    from flowspec_tpu_torch.models.llama import LlamaParams, lm_head_logits
    h, v, t = 4096, 32000, 81
    head = (torch.randn((h, v), generator=cuda, device="cuda")
            * h ** -0.5).to(torch.bfloat16)
    x = torch.randn((1, t, h), generator=cuda, device="cuda").to(
        torch.bfloat16)
    params = LlamaParams(embed=None, layers=None, final_norm=None,
                         lm_head=head)
    lm_head_logits(params, x)                    # cuBLAS set up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = lm_head_logits(params, x)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert got.dtype == torch.float32 and got.shape == (1, t, v)
    assert peak < h * v * 4, peak                 # one f32 head: 0.52 GB
    want = x.float() @ head.float()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=2e-3)


def test_fused_sampling_replays_with_the_request_generator(cuda):
    """Stochastic rounds captured with the request's draw stream (a state
    tensor, loaded into the graph's like the lengths): in-vocabulary
    tokens, the same stream for the same seed and as the eager loop's,
    another for another seed."""
    import dataclasses
    from flowspec_tpu_torch.config import SamplingConfig
    from flowspec_tpu_torch.runtime import SpecEngine
    eng = _tiny_cuda_engine()
    eng = SpecEngine(eng.params, eng.draft, dataclasses.replace(
        eng.cfg, sampling=SamplingConfig(temperature=1.0)))
    prompt = list(range(3, 40))
    a, stats = eng.generate_fused(prompt, max_new_tokens=40,
                                  eos_token_id=-1, seed=1)
    b, _ = eng.generate_fused(prompt, max_new_tokens=40, eos_token_id=-1,
                              seed=1)
    c, _ = eng.generate_fused(prompt, max_new_tokens=40, eos_token_id=-1,
                              seed=2)
    assert a == b and a != c
    assert a == eng.generate(prompt, max_new_tokens=40, eos_token_id=-1,
                             seed=1)[0]
    assert len(a) == len(prompt) + 40 and all(0 <= t < 1024 for t in a)
    assert stats["accept_per_round"] >= 1.0
    d, _ = eng.generate_ar_fused(prompt, max_new_tokens=20, eos_token_id=-1,
                                 seed=3)
    e, _ = eng.generate_ar_fused(prompt, max_new_tokens=20, eos_token_id=-1,
                                 seed=3)
    assert d == e


# the families' attention shapes at S 512: Qwen2-7B (nkv 4, G 7: 567 rows a
# KV head at verify) and Mixtral (nkv 8, G 4), at verify, prefill, AR and
# the draft's T 10; the device n_valid must give the host n_valid's bits
@pytest.mark.parametrize("nkv,g", [(4, 7), (8, 4)])
@pytest.mark.parametrize("t,n_valid", [(81, 209), (81, 273), (64, 64),
                                       (1, 200), (10, 150)])
def test_tree_attention_family_shapes_match_plain(cuda, nkv, g, t, n_valid):
    s_max = 512
    q, k, v, bias = _attn(cuda, nkv * g, nkv, t, s_max, 128, n_valid)
    nv = torch.tensor(n_valid, dtype=torch.int32, device="cuda")
    before = tree_attention.launches
    dev = tree_attention(q, k, v, bias, nv)
    host = tree_attention(q, k, v, bias, n_valid)
    want = tree_attention_plain(q, k, v, bias, live_keys(s_max, n_valid))
    torch.cuda.synchronize()
    assert tree_attention.launches == before + 2
    plan = attention_plan(nkv, g, t, s_max)
    assert float((dev.float() - want.float()).abs().max()) <= 2e-2, plan
    assert torch.equal(dev, host)


@pytest.mark.parametrize("t", [1, 10])
def test_head_topk_qwen2_vocab_matches_plain(cuda, t):
    """V 152064 at H 3584, k 10: 11880 keys a row, past the merge's
    staging limit, so the merge reads them from device memory."""
    h, v, k = 3584, 152064, 10
    x, q, s = _head(cuda, t, h, v)
    lp, tok = head_topk_int8(x, q, s, k)
    lp2, tok2 = head_topk_int8(x, q, s, k)
    want_lp, _ = head_topk_plain(x, q, s, k)
    torch.cuda.synchronize()
    assert float((lp - want_lp).abs().max()) <= 1e-3, head_plan(t, h, v)
    assert float((_plain_lp_of(x, q, s, tok) - want_lp).abs().max()) <= 1e-3
    assert torch.equal(lp, lp2) and torch.equal(tok, tok2)
    best = int(head_logits(x, Int8Tensor(q=q, scale=s))[0].argmax())
    dup = (best + 128 * 601) % v                # another strip, far away
    q[:, dup], s[dup] = q[:, best], s[best]
    lp, tok = head_topk_int8(x, q, s, k)
    _, want_tok = head_topk_plain(x, q, s, k)
    torch.cuda.synchronize()
    assert torch.equal(tok[0], want_tok[0])
    assert tok[0, :2].tolist() == sorted([best, dup]) and lp[0, 0] == lp[0, 1]


def _tiny_mixtral_engine():
    """A 2-layer bf16 Mixtral (H 256, 4 experts top-2, 4/2 heads, V 1024)
    and a full-width int8 draft, random from a seeded generator."""
    from flowspec_tpu_torch.config import (
        EngineConfig, ModelConfig, SamplingConfig, TreeConfig)
    from flowspec_tpu_torch.draft.eagle import (
        init_eagle_params, quantize_eagle_params)
    from flowspec_tpu_torch.models.mixtral import random_mixtral_params
    from flowspec_tpu_torch.runtime import SpecEngine
    mc = ModelConfig(vocab_size=1024, hidden_size=256, intermediate_size=512,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, num_local_experts=4,
                     num_experts_per_tok=2, rope_theta=1e6)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    params = random_mixtral_params(mc, gen, "cuda")
    draft = quantize_eagle_params(init_eagle_params(
        gen, mc, embed=params.embed), "int8")
    tc = TreeConfig(top_k=8, depth=4, total_tokens=24, node_cap=48,
                    leaf_cap=48, depth_cap=12)
    cfg = EngineConfig(model=mc, tree=tc, sampling=SamplingConfig(),
                       max_seq_len=200, prefill_chunk=16)
    return SpecEngine(params, draft, cfg)


def test_mixtral_graph_replay_equals_eager_round_bits(cuda):
    """A Mixtral round (MoE through batched products, the router's top-k by
    a stable sort, the mixture scattered into zeros) captures and replays
    with the eager round's bits; fused streams equal eager ones, spec and
    AR."""
    from flowspec_tpu_torch.runtime import graphs
    eng = _tiny_mixtral_engine()
    prompt = list(range(3, 40))
    state = eng.prefill(eng.init_state(0), prompt)
    loop = graphs._loop_buffers(64, -1, state.commit_len.device)
    eager, eager_loop = graphs._clone(state), graphs._clone(loop)
    g = graphs.DecodeGraph(eng, graphs._spec_body, state, loop)
    assert "int8_matmul" in g.launches and "head_topk" in g.launches
    for _ in range(3):
        g.replay()
        eager = graphs._spec_body(eng, eager, eager_loop)
        torch.cuda.synchronize()
        for a, b in zip(graphs._fields(g.state), graphs._fields(eager)):
            assert torch.equal(a, b)
        for a, b in zip(graphs._fields(g.loop), graphs._fields(eager_loop)):
            assert torch.equal(a, b)
    spec, stats = eng.generate(prompt, max_new_tokens=30, eos_token_id=-1)
    fused, fstats = eng.generate_fused(prompt, max_new_tokens=30,
                                       eos_token_id=-1)
    assert fused == spec and fstats["rounds"] == stats["rounds"]
    ar, _ = eng.generate_ar(prompt, max_new_tokens=16, eos_token_id=-1)
    ar_fused, _ = eng.generate_ar_fused(prompt, max_new_tokens=16,
                                        eos_token_id=-1)
    assert ar_fused == ar


def test_loaders_and_checkpoints_default_to_the_card(cuda, tmp_path):
    import json
    from chip_smoke import write_safetensors
    from flowspec_tpu_torch.models import checkpoint, loader
    h, i, v, n = 64, 128, 256, 2
    cfg = {"model_type": "qwen2", "vocab_size": v, "hidden_size": h,
           "intermediate_size": i, "num_hidden_layers": n,
           "num_attention_heads": 4, "num_key_value_heads": 2}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    r = lambda *shape: torch.randn(shape, generator=cuda, device="cuda")
    t = {"model.embed_tokens.weight": r(v, h), "model.norm.weight": r(h),
         "lm_head.weight": r(v, h)}
    for layer in range(n):
        pre = f"model.layers.{layer}."
        for name, shape in (("self_attn.q_proj", (h, h)),
                            ("self_attn.k_proj", (h // 2, h)),
                            ("self_attn.v_proj", (h // 2, h)),
                            ("self_attn.o_proj", (h, h)),
                            ("mlp.gate_proj", (i, h)), ("mlp.up_proj", (i, h)),
                            ("mlp.down_proj", (h, i))):
            t[pre + name + ".weight"] = r(*shape)
        for name, width in (("q_proj", h), ("k_proj", h // 2),
                            ("v_proj", h // 2)):
            t[pre + f"self_attn.{name}.bias"] = r(width)
        t[pre + "input_layernorm.weight"] = r(h)
        t[pre + "post_attention_layernorm.weight"] = r(h)
    write_safetensors(tmp_path / "model.safetensors",
                      {k: x.to(torch.bfloat16) for k, x in t.items()})
    p = loader.load_llama_params(str(tmp_path))
    assert torch.equal(p.layers.wk[1],
                       t["model.layers.1.self_attn.k_proj.weight"].to(
                           torch.bfloat16).T)
    assert torch.equal(p.lm_head, t["lm_head.weight"].to(torch.bfloat16).T)
    checkpoint.save_params(p, str(tmp_path / "ckpt"))
    back = checkpoint.load_params(str(tmp_path / "ckpt"))
    for tree in (p, back):
        leaves = [getattr(x, f) for x in (tree, tree.layers)
                  for f in vars(x) if isinstance(getattr(x, f),
                                                 torch.Tensor)]
        assert len(leaves) == 3 + 12
        assert all(x.device.type == "cuda" for x in leaves)
    assert torch.equal(back.layers.bv, p.layers.bv)


@pytest.mark.parametrize("nq,nkv,t", [(32, 32, 32), (8, 8, 10), (28, 4, 9)])
def test_tree_attention_lanes_match_plain_and_one_lane_bits(cuda, nq, nkv, t):
    """Four lanes in one launch, each with its own bias and live rows (one
    tile, a partial tile, 300, the whole allocation): every lane within
    one bf16 rounding of plain, bit-equal to a one-lane launch of it (with
    a device n_valid and with a host one), and each lane reads its own
    n_valid: rows past a lane's live tiles hold NaN and change nothing."""
    b, s_max, d = 4, 512, 128
    n_valid = [40, 97, 300, 512]
    parts = [_attn(cuda, nq, nkv, t, s_max, d, max(n, t)) for n in n_valid]
    q, k, v = (torch.cat([p[i] for p in parts]) for i in range(3))
    bias = torch.stack([p[3] for p in parts])
    clean_k, clean_v = k.clone(), v.clone()
    for i, n in enumerate(n_valid):
        end = -(-n // 64) * 64
        k[i, :, end:] = float("nan")
        v[i, :, end:] = float("nan")
    nv = torch.tensor(n_valid, dtype=torch.int32, device="cuda")
    before = tree_attention.launches
    got = tree_attention(q, k, v, bias, nv)
    assert tree_attention.launches == before + 1
    assert bool(torch.isfinite(got.float()).all())
    for i, n in enumerate(n_valid):
        one = tree_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1], bias[i],
                             nv[i:i + 1])
        host = tree_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1], bias[i], n)
        want = tree_attention_plain(q[i:i + 1], clean_k[i:i + 1],
                                    clean_v[i:i + 1], bias[i],
                                    live_keys(s_max, n))
        torch.cuda.synchronize()
        assert torch.equal(got[i:i + 1], one), i
        assert torch.equal(one, host), i
        assert float((got[i:i + 1].float()
                      - want.float()).abs().max()) <= 2e-2, i
    plan = attention_plan(nkv, nq // nkv, t, s_max, lanes=b)
    assert plan.blocks % b == 0


def _tiny_batched_engine(batch_size=3):
    from flowspec_tpu_torch.runtime import BatchedSpecEngine
    eng = _tiny_cuda_engine()
    return BatchedSpecEngine(eng.params, eng.draft, eng.cfg,
                             batch_size=batch_size, adapt_tree=False)


def test_lane_graph_replay_equals_eager_lane_round_bits(cuda):
    """The gated lane loop's body over three lanes captured once and
    replayed gives the eager body's bits, replay after replay, with a lane
    stopped early by its budget (all but its scratch KV row, where a
    stopped lane's writes land in no fixed order); it launches what one
    lane's round
    launches; generate_batch_fused's streams equal generate_batch's."""
    from flowspec_tpu_torch.ops import counted_wrappers
    from flowspec_tpu_torch.runtime import graphs
    eng = _tiny_batched_engine()
    prompts = [list(range(3, 40)), list(range(50, 70)), list(range(7, 61))]
    state = eng._stack_states([eng._prefill_one(p, i)
                               for i, p in enumerate(prompts)], [0, 1, 2])
    b = len(prompts)
    loop = graphs.LaneLoop(
        out_buf=torch.zeros((b, 65), dtype=torch.int32, device="cuda"),
        n_out=torch.zeros((b,), dtype=torch.int32, device="cuda"),
        done=torch.zeros((b,), dtype=torch.bool, device="cuda"),
        rounds=torch.zeros((b,), dtype=torch.int32, device="cuda"),
        budget=torch.tensor([64, 2, 64], dtype=torch.int32, device="cuda"),
        eos_id=torch.full((), -1, dtype=torch.int32, device="cuda"),
        commit_cap=torch.full((), 200, dtype=torch.int32, device="cuda"))
    eager, eager_loop = graphs._clone(state), graphs._clone(loop)
    g = graphs.DecodeGraph(eng, graphs._lane_body, state, loop,
                           graphs._lane_readback)

    def same(x, y):
        # a stopped lane's writes all land on its last KV row, a scratch
        # row no length reaches (models/kv_cache.py): compare the others
        if x.dim() == 5:
            x, y = x[..., :-1, :], y[..., :-1, :]
        return torch.equal(x, y)
    one = graphs.DecodeGraph(
        eng, graphs._spec_body, eng._prefill_one(prompts[0], 0),
        graphs._loop_buffers(64, -1, "cuda"))
    assert g.launches == one.launches
    counters = counted_wrappers()
    for _ in range(4):
        before = {n: fn.launches for n, fn in counters.items()}
        g.replay()
        for n, fn in counters.items():
            assert fn.launches - before[n] == g.launches.get(n, 0), n
        eager = graphs._lane_body(eng, eager, eager_loop)
        torch.cuda.synchronize()
        for x, y in zip(graphs._fields(g.state), graphs._fields(eager)):
            assert same(x, y)
        for x, y in zip(graphs._fields(g.loop), graphs._fields(eager_loop)):
            assert torch.equal(x, y)
    assert int(g.loop.rounds[1]) < int(g.loop.rounds[0])
    outs, stats = eng.generate_batch(prompts, max_new_tokens=40,
                                     eos_token_id=-1)
    fused, fstats = eng.generate_batch_fused(prompts, max_new_tokens=40,
                                             eos_token_id=-1)
    assert fused == outs and fstats["rounds"] == stats["rounds"]


def test_serve_captures_once_per_lanes_and_queue_capacity(cuda):
    """A second serve of as many requests (the same queue capacity)
    replays the graph the first captured; warmup(n_requests) captures the
    graph a later call of that many requests replays; the streams of two
    calls are equal."""
    eng = _tiny_batched_engine(batch_size=2)
    prompts = [list(range(3 + i, 30 + 2 * i)) for i in range(5)]
    a, sa = eng.serve(prompts, max_new_tokens=[8, 3, 12, 5, 7],
                      eos_token_id=-1)
    graphs_after = dict(eng._graphs)
    b, sb = eng.serve(prompts, max_new_tokens=[8, 3, 12, 5, 7],
                      eos_token_id=-1)
    assert a == b and sa == sb
    assert eng._graphs == graphs_after
    prefix = list(range(100, 120))
    fresh = _tiny_batched_engine(batch_size=2)
    keys = fresh.warmup(n_requests=12, shared_prefix=prefix)
    warmed = dict(fresh._graphs)
    assert set(keys) <= set(warmed)
    fresh.serve([prefix + [5 + i, 6] for i in range(12)], max_new_tokens=4,
                eos_token_id=-1, shared_prefix=prefix)
    assert fresh._graphs == warmed


def _tiny_stream_engine(**flags):
    """The tiny int8 engine over 4 lanes with a 60-node tree, so that
    dynamic_tree's variants differ: 61 nodes for one busy lane, 48 for two
    or three, 32 for four."""
    import dataclasses
    from flowspec_tpu_torch.config import TreeConfig
    from flowspec_tpu_torch.runtime import BatchedSpecEngine
    eng = _tiny_cuda_engine()
    tc = TreeConfig(top_k=8, depth=4, total_tokens=60, node_cap=64,
                    leaf_cap=64, depth_cap=12)
    return BatchedSpecEngine(eng.params, eng.draft,
                             dataclasses.replace(eng.cfg, tree=tc),
                             batch_size=4, adapt_tree=False, **flags)


def _stream_workload(n=6):
    """Staggered arrivals and budgets: a lone request, a burst, a late
    one."""
    prompts = [list(range(3 + i, 30 + 3 * i)) for i in range(n)]
    budgets = [24, 6, 9, 4, 12, 8][:n]
    arrivals = [0.0, 0.6, 0.65, 0.7, 0.75, 2.0][:n]
    return prompts, budgets, arrivals


def _clock():
    """A fake clock that advances 0.05 a call."""
    state = {"t": 0.0}

    def clock():
        state["t"] += 0.05
        return state["t"]
    return clock


def test_tree_variants_share_one_width_buffers_and_copy_no_kv(cuda,
                                                             monkeypatch):
    """dynamic_tree's graphs of one width are captured over one set of
    static buffers (every state and loop tensor at the same address), and
    a serve that switches variants loads the request into them once: no
    dispatch copies lane state."""
    from flowspec_tpu_torch.runtime import graphs
    eng = _tiny_stream_engine(dynamic_tree=True)
    keys = eng.warmup(n_requests=4)
    assert [k[5].node_cap for k in keys] == [61, 48, 32]
    lanes = eng._serve_sets[keys[0][:5]]
    ptrs = [t.data_ptr() for t in graphs._fields(lanes.state)] + \
        [t.data_ptr() for t in graphs._fields(lanes.loop)]
    for k in keys:
        g = eng._graphs[k]
        assert [t.data_ptr() for t in graphs._fields(g.state)] + \
            [t.data_ptr() for t in graphs._fields(g.loop)] == ptrs
    loads = []
    real = graphs._load
    monkeypatch.setattr(graphs, "_load",
                        lambda dst, src: (loads.append(1), real(dst, src)))
    seen = []
    replay = graphs.ServeLanes.replay
    monkeypatch.setattr(graphs.ServeLanes, "replay", lambda self, e, tc: (
        seen.append(tc.node_cap), replay(self, e, tc))[1])
    prompts = [list(range(3 + i, 30 + 3 * i)) for i in range(4)]
    eng.serve(prompts, max_new_tokens=[30, 4, 8, 12], eos_token_id=-1,
              rounds_per_dispatch=2)
    assert {32, 48, 61} <= set(seen), seen
    assert len(loads) == 2            # the request's state and loop, once
    assert [t.data_ptr() for t in graphs._fields(lanes.state)] + \
        [t.data_ptr() for t in graphs._fields(lanes.loop)] == ptrs


def test_width_switch_moves_lanes_by_the_permutation(cuda):
    """_resize_lanes gives output lane j the state, KV rows and context of
    input lane perm[j], as the JAX package's gather does; a placeholder
    (keep False) takes perm[j]'s small fields, inactive, not its KV."""
    eng = _tiny_stream_engine(dynamic_batch=True)
    src = eng._serve_lanes(4, 8)
    st = src.state
    for j in range(4):
        st.base_cache.k[:, j].fill_(j + 1)
        st.draft_cache.v[:, j].fill_(10 * (j + 1))
    st.commit_len.copy_(torch.tensor([10, 20, 30, 40], device="cuda"))
    st.rng[:, 0].copy_(torch.tensor([1, 2, 3, 4], device="cuda"))
    src.loop.active.fill_(True)
    src.loop.em.copy_(torch.tensor([5, 6, 7, 8], device="cuda",
                                   dtype=torch.int32))
    two = eng._resize_lanes(src, 2, [3, 1], [True, True])
    assert two.key[3] == 2
    assert two.state.commit_len.tolist() == [40, 20]
    assert two.state.rng[:, 0].tolist() == [4, 2]
    assert two.loop.em.tolist() == [8, 6]
    assert two.loop.active.tolist() == [True, True]
    assert torch.equal(two.state.base_cache.k[:, 0], st.base_cache.k[:, 3])
    assert torch.equal(two.state.draft_cache.v[:, 1],
                       st.draft_cache.v[:, 1])
    four = eng._resize_lanes(two, 4, [0, 1, 0, 0],
                             [True, True, False, False])
    assert four is src
    assert four.state.commit_len.tolist() == [40, 20, 40, 40]
    assert four.loop.active.tolist() == [True, True, False, False]
    assert float(four.state.base_cache.k[:, 0].max()) == 4.0
    assert float(four.state.base_cache.k[:, 2].max()) == 3.0   # not copied


def test_serve_stream_graphs_equal_the_eager_body(cuda, monkeypatch):
    """serve_stream with the dynamic tree and width through captured
    graphs gives the tokens and statistics of the same serve body run
    eagerly on the same CUDA buffers (the same kernels: bf16, as the
    kernels take it; the f32 parity with the JAX package is on the CPU)."""
    from flowspec_tpu_torch.runtime import graphs
    eng = _tiny_stream_engine(dynamic_tree=True, dynamic_batch=True)
    prompts, budgets, arrivals = _stream_workload()
    kw = dict(max_new_tokens=budgets, eos_token_id=-1,
              rounds_per_dispatch=2)
    fused, fstats = eng.serve_stream(prompts, arrivals, clock=_clock(), **kw)
    assert fstats["min_width"] == 1 and fstats["width_switches"] >= 2
    assert len(eng._graphs) >= 3
    monkeypatch.setattr(graphs.ServeLanes, "graph",
                        lambda self, e, tc: None)
    eager, estats = eng.serve_stream(prompts, arrivals, clock=_clock(), **kw)
    assert fused == eager and fstats == estats


def test_serve_stream_after_warmup_captures_nothing(cuda):
    """warmup(n_requests) captures every (width, tree variant) graph a
    serve_stream of that many requests can pick: the stream captures
    nothing, and replays only graphs warmup named."""
    eng = _tiny_stream_engine(dynamic_tree=True, dynamic_batch=True)
    prompts, budgets, arrivals = _stream_workload()
    keys = eng.warmup(n_requests=len(prompts))
    assert [(k[3], k[5].node_cap) for k in keys] == [
        (1, 61), (2, 61), (2, 48), (4, 61), (4, 48), (4, 32)]
    warmed = dict(eng._graphs)
    _, stats = eng.serve_stream(prompts, arrivals, max_new_tokens=budgets,
                                eos_token_id=-1, rounds_per_dispatch=2,
                                clock=_clock(), preempt_factor=2.0)
    assert stats["width_switches"] >= 2
    assert eng._graphs == warmed


def test_capture_waits_for_a_prefix_build_and_keeps_its_tally(cuda):
    """A cold prefix with prefix_overlap builds in a thread while the
    first dispatches need captures (no warmup): serve_stream joins the
    build before a capture (a CUDA call from another thread, such as a
    collected graph's release, may break one), and each graph's launches a
    replay equal those of the same graph captured with no thread about."""
    eng = _tiny_stream_engine(dynamic_tree=True)
    prefix = list(range(100, 260))        # ten prefill chunks to build
    prompts = [prefix + [5 + i, 6, 7] for i in range(4)]
    kw = dict(max_new_tokens=[20, 6, 9, 12], eos_token_id=-1,
              rounds_per_dispatch=2)
    arrivals = [0.0, 0.0, 0.05, 0.1]
    _, stats = eng.serve_stream(prompts, arrivals, clock=_clock(),
                                shared_prefix=prefix, prefix_overlap=True,
                                **kw)
    assert stats["per_request"] == kw["max_new_tokens"]
    assert len(eng._prefix_templates) == 1
    quiet = _tiny_stream_engine(dynamic_tree=True)
    quiet.warmup(n_requests=4)
    assert eng._graphs.keys() <= quiet._graphs.keys()
    for k, g in eng._graphs.items():
        assert g.launches == quiet._graphs[k].launches, k


def test_capture_survives_a_collection_of_another_engines_graphs(cuda):
    """An engine dropped in a reference cycle keeps its CUDA graphs until
    the cyclic collector runs, which may be at any allocation; freeing a
    graph inside another capture aborts the process. With collections
    forced at nearly every allocation, a capture still completes (the
    collector is off while it runs) and the dropped engine is collected
    after it."""
    import gc
    import weakref
    old = _tiny_stream_engine()
    old.warmup(n_requests=4)
    assert old._graphs
    old.cycle = old
    gone = weakref.ref(old)
    del old
    eng = _tiny_stream_engine()
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        keys = eng.warmup(n_requests=4)
    finally:
        gc.set_threshold(*threshold)
    gc.collect()
    assert gone() is None
    prompts = [list(range(3 + i, 30 + 3 * i)) for i in range(4)]
    _, stats = eng.serve(prompts, max_new_tokens=6, eos_token_id=-1)
    assert stats["per_request"] == [6] * 4 and set(keys) <= set(eng._graphs)


def _moved(x, dev):
    """A params / state tree with every tensor moved to `dev`."""
    import dataclasses
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _moved(getattr(x, f.name), dev)
            for f in dataclasses.fields(x)})
    return x


def _tiny_pipe_engines(schedule, split=(1, 1, 0, 0)):
    """The tiny int8 pair of `_tiny_cuda_engine` as (card, CPU)
    PipelineEngines of `schedule` over four stages of `split` layers (two
    of them empty), and the CPU SpecEngine for AR streams and gaps."""
    import dataclasses
    from flowspec_tpu_torch.config import StageTopology, TreeConfig
    from flowspec_tpu_torch.parallel import PipelineEngine
    from flowspec_tpu_torch.runtime import SpecEngine
    spec = _tiny_cuda_engine()
    tc = TreeConfig(top_k=8, depth=4, total_tokens=24, expand_tokens=12,
                    expand_depth=2, none_expand_tokens=8, node_cap=48,
                    leaf_cap=48, depth_cap=12, chunk_len=6, chunk_cap=12)
    cfg = dataclasses.replace(spec.cfg, tree=tc,
                              topology=StageTopology(4, split))
    params, draft = spec.params, spec.draft
    cpu_params, cpu_draft = _moved(params, "cpu"), _moved(draft, "cpu")
    return (PipelineEngine(params, draft, cfg, schedule=schedule),
            PipelineEngine(cpu_params, cpu_draft, cfg, schedule=schedule,
                           device="cpu"),
            SpecEngine(cpu_params, cpu_draft, cfg, device="cpu"))


def _near_tie_or_equal(ref, prompt, got, want, gap=0.05):
    """`got` equals `want`, or they first differ where the base model's
    top-2 logit gap after want's prefix is below `gap` (a bf16 near-tie
    whose rounding differs between the card's kernels and the CPU's plain
    versions)."""
    if got == want:
        return
    i = next(k for k, (a, b) in enumerate(zip(got, want)) if a != b)
    _, logits = ref._prefill_chunks(ref.init_state(), want[:i])
    top = torch.topk(logits.float(), 2).values
    assert float(top[0] - top[1]) < gap, (i - len(prompt), got, want)


@pytest.mark.parametrize("schedule", ["ar", "serial", "naive", "pruned",
                                      "continuous", "pipedec"])
def test_pipeline_schedules_on_the_card_match_the_cpu(cuda, schedule):
    """Every schedule of a tiny bf16 (int8-weight) pipeline with two
    empty stages on the card against the same engine on the CPU, under the
    lossless rule; KV rows a multiple of 256; at most three flag reads a
    turn; generate_fused equals generate."""
    from flowspec_tpu_torch.ops import counted_wrappers
    eng, cpu, ref = _tiny_pipe_engines(schedule)
    state = eng.init_state()
    assert state.kv.max_len % 256 == 0 and state.draft_cache.max_len % 256 == 0
    assert state.kv.k.shape[0] == 2 and eng.layer_split == (1, 1, 0, 0)
    prompt = list(range(3, 40))
    counters = counted_wrappers()
    before = {n: fn.launches for n, fn in counters.items()}
    reads = eng.reads.count
    got, stats = eng.generate(prompt, max_new_tokens=24, eos_token_id=-1)
    assert eng.reads.count - reads <= 3 * stats["turns"]
    for n in ("int8_matmul", "tree_attention", "head_topk"):
        assert counters[n].launches > before[n], n
    want, _ = cpu.generate(prompt, max_new_tokens=24, eos_token_id=-1)
    _near_tie_or_equal(ref, prompt, got, want)
    fused, fstats = eng.generate_fused(prompt, max_new_tokens=24,
                                       eos_token_id=-1)
    assert fused == got and fstats["rounds"] == stats["rounds"]


def test_pipeline_resume_on_the_card(cuda):
    """resume_and_generate on the card equals a fresh run on the history
    (the lossless rule against the CPU's fresh run)."""
    eng, cpu, ref = _tiny_pipe_engines("continuous", split=(0, 2, 0, 0))
    prompt = list(range(5, 30))
    out, _, st = eng.generate(prompt, max_new_tokens=12, eos_token_id=-1,
                              return_state=True)
    extra = list(range(40, 47))
    got, _ = eng.resume_and_generate(st, out, extra, max_new_tokens=10,
                                     eos_token_id=-1)
    fresh, _ = eng.generate(out + extra, max_new_tokens=10, eos_token_id=-1)
    assert got == fresh
    want, _ = cpu.generate(out + extra, max_new_tokens=10, eos_token_id=-1)
    _near_tie_or_equal(ref, out + extra, got, want)


# ---- tensor parallelism (in-process ranks on the one card) -----------------

def _tiny_tp_engines(tp):
    """`_tiny_cuda_engine`'s int8 pair as (card TPEngine, CPU TPEngine, CPU
    SpecEngine for the gaps) over an in-process tp mesh."""
    from flowspec_tpu_torch.parallel import TPEngine, tp_mesh
    from flowspec_tpu_torch.runtime import SpecEngine
    spec = _tiny_cuda_engine()
    cpu_params, cpu_draft = _moved(spec.params, "cpu"), _moved(spec.draft,
                                                               "cpu")
    return (TPEngine(spec.params, spec.draft, spec.cfg, mesh=tp_mesh(tp)),
            TPEngine(cpu_params, cpu_draft, spec.cfg, mesh=tp_mesh(tp),
                     device="cpu"),
            SpecEngine(cpu_params, cpu_draft, spec.cfg, device="cpu"))


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_engine_on_the_card_matches_the_cpu(cuda, tp):
    """TP 2 / 4 of the tiny int8 pair on the card against the same engine
    on the CPU under the lossless rule; every rank's shards launch the
    int8, attention and head kernels; generate_fused equals generate."""
    from flowspec_tpu_torch.ops import counted_wrappers
    eng, cpu, ref = _tiny_tp_engines(tp)
    prompt = list(range(3, 40))
    counters = counted_wrappers()
    before = {n: fn.launches for n, fn in counters.items()}
    got, stats = eng.generate(prompt, max_new_tokens=24, eos_token_id=-1)
    for n in ("int8_matmul", "tree_attention", "head_topk"):
        assert counters[n].launches > before[n], n
    want, _ = cpu.generate(prompt, max_new_tokens=24, eos_token_id=-1)
    _near_tie_or_equal(ref, prompt, got, want)
    fused, fstats = eng.generate_fused(prompt, max_new_tokens=24,
                                       eos_token_id=-1)
    assert fused == got and fstats["rounds"] == stats["rounds"]


def test_tp_graph_replay_equals_eager_round_bits(cuda):
    """A TP round (tp 2: each rank's shards, the all-reduces in memory)
    captured once and replayed gives the eager body's state and loop
    carry, bit for bit, replay after replay; a replay counts each rank's
    launches."""
    from flowspec_tpu_torch.ops import counted_wrappers
    from flowspec_tpu_torch.runtime import graphs
    eng, _, _ = _tiny_tp_engines(2)
    state = eng.prefill(eng.init_state(0), list(range(3, 40)))
    loop = graphs._loop_buffers(64, -1, state.commit_len.device)
    eager, eager_loop = graphs._clone(state), graphs._clone(loop)
    g = graphs.DecodeGraph(eng, graphs._spec_body, state, loop)
    n_layers, passes = 2, eng.cfg.tree.depth + 1
    assert g.launches["tree_attention"] == 2 * (n_layers + passes)
    counters = counted_wrappers()
    for _ in range(3):
        before = {n: fn.launches for n, fn in counters.items()}
        g.replay()
        for n, fn in counters.items():
            assert fn.launches - before[n] == g.launches.get(n, 0), n
        eager = graphs._spec_body(eng, eager, eager_loop)
        torch.cuda.synchronize()
        for a, b in zip(graphs._fields(g.state), graphs._fields(eager)):
            assert torch.equal(a, b)
        for a, b in zip(graphs._fields(g.loop), graphs._fields(eager_loop)):
            assert torch.equal(a, b)


# the benchmark cells' products: Qwen2-7B's base (wo has wq's shape) at the
# verify, prefill, draft and AR widths and its draft's fc; Mixtral-8x7B's
# draft; Qwen2's ragged last prefill chunk of the 211-token prompt (M 19)
STREAM_K_SHAPES = (
    [(m, i, o) for m in (81, 64, 10, 1)
     for i, o in ((3584, 3584), (3584, 512), (3584, 3584), (3584, 18944),
                  (18944, 3584))]
    + [(m, 7168, 3584) for m in (10, 1)]
    + [(m, i, o) for m in (10, 1)
       for i, o in ((4096, 1024), (4096, 14336), (14336, 4096))]
    + [(19, i, o) for i, o in ((3584, 3584), (3584, 512), (3584, 18944),
                               (18944, 3584))])


@pytest.mark.parametrize("m,n_in,n_out", STREAM_K_SHAPES)
def test_stream_k_cell_shapes_match_plain_with_equal_bits(cuda, m, n_in,
                                                          n_out):
    """Every product shape of the benchmark cells through the stream-K
    kernel against plain, equal bits on two launches; the wrapper counts
    the plan's split tiles at each launch and the flags end zero."""
    from flowspec_tpu_torch.ops import quant_matmul as qm
    x, q, s = _int8(cuda, m, n_in, n_out)
    plan = matmul_plan(m, n_in, n_out, "int8")
    before = int8_matmul.launches, int8_matmul.fixup_tiles
    got, again = int8_matmul(x, q, s), int8_matmul(x, q, s)
    want = int8_matmul_plain(x, q, s)
    torch.cuda.synchronize()
    assert (int8_matmul.launches, int8_matmul.fixup_tiles) == (
        before[0] + 2, before[1] + 2 * plan.fixups)
    ok, err = _close(got, want)
    assert ok, (float(err), plan)
    assert torch.equal(got, again)
    assert int(qm._flags_on(x.device).abs().sum()) == 0


# one product of each cut with split tiles: Qwen2-7B's w_gate at M 81
# (stream-K: partials and flags in global memory) and its wq (split cut:
# each tile's eight segments added in one cluster's shared memory)
CUTS = [(81, 3584, 18944), (81, 3584, 3584)]


@pytest.mark.parametrize("m,n_in,n_out", CUTS)
def test_stream_k_graph_replays_leave_the_flags_as_found(cuda, m, n_in,
                                                         n_out):
    """A product with split tiles captured in a CUDA graph: three replays
    give the eager launch's bits, and each leaves the flags zero (no memset
    in the graph: the finishing blocks clear what they took)."""
    from flowspec_tpu_torch.ops import quant_matmul as qm
    x, q, s = _int8(cuda, m, n_in, n_out)
    assert matmul_plan(m, n_in, n_out, "int8").fixups > 0
    eager = int8_matmul(x, q, s)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        int8_matmul(x, q, s)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = int8_matmul(x, q, s)
    flags = qm._flags_on(x.device)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        assert int(flags.abs().sum()) == 0


@pytest.mark.parametrize("m,n_in,n_out", CUTS)
def test_stream_k_launches_one_kernel_of_the_int8_family(cuda, m, n_in,
                                                         n_out):
    """One profiled launch with split tiles: every device kernel it runs is
    of the benchmark's `int8_matmul` family (`benchmark.lib.trace.family`,
    read, not edited), none a `matmul_reduce` pass or `other`."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.lib.trace import family
    x, q, s = _int8(cuda, m, n_in, n_out)
    assert matmul_plan(m, n_in, n_out, "int8").fixups > 0
    int8_matmul(x, q, s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        int8_matmul(x, q, s)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names and {family(n) for n in names} == {"int8_matmul"}, names


@pytest.mark.parametrize("m,n_in,n_out", [
    (81, 4096, 2752), (1, 4096, 2752), (64, 4096, 5504), (81, 2752, 4096),
    (18, 5504, 4096), (10, 1024, 704), (10, 704, 1024), (9, 8192, 256)])
def test_int8_shard_widths_match_plain_with_equal_bits(cuda, m, n_in, n_out):
    """The int8 kernel at the 7B pair's tp 2 / 4 shard widths (Out 2752 and
    704: 64-column strips) against plain, equal bits on two launches."""
    x, q, s = _int8(cuda, m, n_in, n_out)
    plan = matmul_plan(m, n_in, n_out, "int8")
    assert plan.bn == (64 if n_out % 128 == 64 else 128)
    got = int8_matmul(x, q, s)
    assert torch.equal(got, int8_matmul(x, q, s))
    ok, err = _close(got, int8_matmul_plain(x, q, s))
    assert ok, float(err)


def test_galaxy_on_the_card_matches_plain_tp(cuda):
    """Galaxy TP at tp 2 on a tiny bf16 base (H 256, head dim 64) with a
    24-node tree (rows tp divides): the galaxy forward engages on every
    verify, and its stream equals plain TP's on the card under the
    lossless rule."""
    from flowspec_tpu_torch.config import (
        EngineConfig, ModelConfig, SamplingConfig, TreeConfig)
    from flowspec_tpu_torch.draft.eagle import init_eagle_params
    from flowspec_tpu_torch.entry import random_llama
    from flowspec_tpu_torch.parallel import TPEngine, tp_mesh
    from flowspec_tpu_torch.runtime import SpecEngine
    mc = ModelConfig(vocab_size=1024, hidden_size=256, intermediate_size=512,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=4)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    params = random_llama(mc, gen, "cuda")
    draft = init_eagle_params(gen, mc, embed=params.embed)
    cfg = EngineConfig(model=mc, tree=TreeConfig(
        top_k=8, depth=4, total_tokens=23, node_cap=48, leaf_cap=48,
        depth_cap=12), sampling=SamplingConfig(), max_seq_len=200,
        prefill_chunk=16)
    prompt = list(range(3, 40))
    plain = TPEngine(params, draft, cfg, mesh=tp_mesh(2))
    gal = TPEngine(params, draft, cfg, mesh=tp_mesh(2), galaxy=True)
    want, _ = plain.generate(prompt, max_new_tokens=24, eos_token_id=-1)
    got, stats = gal.generate(prompt, max_new_tokens=24, eos_token_id=-1)
    assert gal.forward_fn.engaged >= stats["rounds"]
    ref = SpecEngine(params, draft, cfg)
    _near_tie_or_equal(ref, prompt, got, want)


def test_dryrun_multichip_on_the_card(cuda):
    """`entry.dryrun_multichip(4)` on the card (bf16, head dim 64): every
    path against the AR stream under the lossless rule."""
    from flowspec_tpu_torch.entry import dryrun_multichip
    report = dryrun_multichip(4)
    assert report["device"].startswith("cuda")
    assert report["galaxy_tp4"]["engaged"] > 0


def _struct_bf16():
    """The struct tiny8 pair on the card in bf16 (head dim 64), through the
    port's struct loaders."""
    import dataclasses
    import os
    from flowspec_tpu_torch.eval.struct_base import (
        SCALES, load_base, load_draft, model_config)
    fix = os.path.join(os.path.dirname(__file__), "fixtures")
    mc = dataclasses.replace(model_config(SCALES["tiny8"]), dtype="bfloat16")
    base = load_base(os.path.join(fix, "struct_tiny8_base.npz"), mc)
    draft = load_draft(os.path.join(fix, "struct_tiny8_draft.npz"),
                       base.embed, torch.bfloat16)
    assert base.embed.is_cuda and draft.wq.is_cuda
    return mc, base, draft


def test_run_eval_on_the_card_matches_ar(cuda):
    """`run_eval` over 2 mt_bench questions x 2 turns on the card (bf16),
    fused and with the longest-common-prefix resume: every turn reaches its
    budget, the resume takes every turn 2, and every answer equals the AR
    stream under the lossless rule."""
    import os
    from flowspec_tpu_torch.config import (
        EngineConfig, SamplingConfig, TreeConfig)
    from flowspec_tpu_torch.eval.harness import load_questions, run_eval
    from flowspec_tpu_torch.eval.sweep import byte_tokenizer
    from flowspec_tpu_torch.runtime import SpecEngine
    mc, base, draft = _struct_bf16()
    cfg = EngineConfig(model=mc, tree=TreeConfig(
        total_tokens=48, depth=8, score_temperature=0.2, node_cap=96,
        leaf_cap=96, depth_cap=16), sampling=SamplingConfig(),
        max_seq_len=640)
    eng = SpecEngine(base, draft, cfg)
    qs = load_questions(os.path.join(os.path.dirname(__file__), "..",
                                     "data", "mt_bench", "question.jsonl"),
                        limit=2)
    tok, detok = byte_tokenizer(mc.vocab_size)
    for resume in (False, True):
        calls = []

        def gen(t, fn=eng.generate if resume else eng.generate_fused):
            out, stats = fn(t, max_new_tokens=12, eos_token_id=-1)
            calls.append((list(t), out))
            return out, stats
        res = run_eval(gen, tok, detok, qs, max_turns=2,
                       engine=eng if resume else None, resume=resume,
                       max_new_tokens=12)
        assert res.total_new_tokens == 48 and res.n_conv_turns == 4
        assert res.resume_hits == (2 if resume else 0)
        for prompt, out in calls:
            want, _ = eng.generate_ar(prompt, max_new_tokens=12,
                                      eos_token_id=-1)
            _near_tie_or_equal(eng, prompt, out, want)


def test_run_eval_serve_on_the_card(cuda):
    """`run_eval_serve` with max_turns=2 and the preamble prefilled once on
    a 2-lane engine on the card (bf16): every row reaches its budget, the
    turn-2 row's resumed + cold is its question count, and a store of 2
    evicts (cold > 0)."""
    import os
    from flowspec_tpu_torch.config import (
        EngineConfig, SamplingConfig, TreeConfig)
    from flowspec_tpu_torch.eval.harness import (
        load_questions, run_eval_serve)
    from flowspec_tpu_torch.eval.sweep import byte_tokenizer
    from flowspec_tpu_torch.runtime import BatchedSpecEngine
    mc, base, draft = _struct_bf16()
    cfg = EngineConfig(model=mc, tree=TreeConfig(
        total_tokens=48, depth=8, score_temperature=0.2, node_cap=96,
        leaf_cap=96, depth_cap=16), sampling=SamplingConfig(),
        max_seq_len=640)
    eng = BatchedSpecEngine(base, draft, cfg, batch_size=2)
    qs = load_questions(os.path.join(os.path.dirname(__file__), "..",
                                     "data", "mt_bench", "question.jsonl"),
                        limit=4)
    tok, detok = byte_tokenizer(mc.vocab_size)
    for cap in (8, 2):
        rows = run_eval_serve(eng, tok, qs, max_new_tokens=8,
                              prefix_cache=True, max_turns=2, store_cap=cap,
                              detokenize=detok)
        assert [r["new_tokens"] for r in rows] == [32, 32]
        assert "cold" not in rows[0] and rows[0]["resumed"] == 0
        assert rows[1]["resumed"] + rows[1]["cold"] == 4
        assert (rows[1]["cold"] > 0) == (cap == 2)


def test_profiler_cuda_memory_stats(cuda):
    """The profiler's memory readings on the card: the allocator's current
    and peak bytes and the card's memory; a section that allocates shows
    its delta and a new peak, without resetting the peak counter."""
    from flowspec_tpu_torch.utils.profiler import Profiler
    p = Profiler()
    st = Profiler.memory_stats()
    assert st["bytes_limit"] == torch.cuda.get_device_properties(
        0).total_memory
    assert st["bytes_in_use"] == torch.cuda.memory_allocated()
    peak0 = torch.cuda.max_memory_allocated()
    with p.memory_context("alloc"):
        x = torch.ones((64, 2 ** 20), dtype=torch.float32, device="cuda")
    s = p.summary()["alloc"]
    assert s["alloc_delta_mb"] == 256.0 and s["count"] == 1
    assert s["peak_mb"] >= 256.0
    assert s["peak_is_new"] == (torch.cuda.max_memory_allocated() > peak0)
    assert torch.cuda.max_memory_allocated() >= peak0
    with p.time_context("sync", sync_on=x):
        x.mul_(2)
    assert p.summary()["sync"]["count"] == 1
    del x


# ---- no gradient through a kernel --------------------------------------------

def _grad_operands(name):
    """(wrapper, operands) of one kernel at a small shape it takes, in
    bf16 (x / q the operand that will require a gradient)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((1, 16, 128), generator=gen, device="cuda").to(
        torch.bfloat16)
    if name == "tree_attention":
        q = torch.randn((1, 4, 16, 64), generator=gen, device="cuda").to(
            torch.bfloat16)
        kv = torch.randn((1, 4, 256, 64), generator=gen, device="cuda").to(
            torch.bfloat16)
        return tree_attention, (q, kv, kv, torch.zeros((16, 256),
                                                      device="cuda"), 16)
    if name == "head_topk":
        return head_topk, (x[0], Int8Tensor(
            q=torch.ones((128, 256), dtype=torch.int8, device="cuda"),
            scale=torch.ones((256,), device="cuda")), 4)
    if name == "int8_matmul":
        return int8_matmul, (x, torch.ones((128, 64), dtype=torch.int8,
                                           device="cuda"),
                             torch.ones((64,), device="cuda"))
    q4 = torch.full((64, 64), 0x99, dtype=torch.uint8, device="cuda")
    s4 = torch.ones((2, 64), device="cuda")
    if name == "int4_matmul_wide":
        return int4_matmul, (torch.cat([x] * 3, dim=1), q4, s4)   # M 48
    return {"nf4_matmul": nf4_matmul, "int4_matmul": int4_matmul}[name], \
        (x, q4, s4)


@pytest.mark.parametrize("name", ["tree_attention", "int8_matmul",
                                  "nf4_matmul", "int4_matmul",
                                  "int4_matmul_wide", "head_topk"])
def test_wrapper_refuses_an_operand_that_requires_grad(cuda, name):
    """A kernel's output is a tensor the wrapper allocated, outside
    autograd: under grad mode an operand that requires a gradient raises,
    naming the kernel, and launches nothing; without grad mode, or under
    `torch.no_grad()`, the same call launches as on every serving path."""
    fn, args = _grad_operands(name)
    wanted = args[0].detach().clone().requires_grad_()
    counters = (int8_matmul, nf4_matmul, int4_matmul, int4_matmul_smallm,
                tree_attention, head_topk)
    before = [c.launches for c in counters]
    with pytest.raises(RuntimeError, match=name.replace("_wide", "")
                       + ".*no backward"):
        fn(wanted, *args[1:])
    assert [c.launches for c in counters] == before
    with torch.no_grad():
        got = fn(wanted, *args[1:])
    want = fn(*args)
    torch.cuda.synchronize()
    got, want = (got[0], want[0]) if isinstance(got, tuple) else (got, want)
    assert torch.equal(got, want)
    assert sum(c.launches for c in counters) == sum(before) + 2


def test_training_on_the_card_reaches_every_field(cuda):
    """One step of a tiny base (bf16 compute, f32 masters) and of its
    thin draft on the card: every trainable field gets a finite nonzero
    gradient and no kernel launches (the differentiable forward takes the
    attention's plain version and plain products)."""
    from flowspec_tpu_torch.config import ModelConfig
    from flowspec_tpu_torch.draft.eagle import draft_view, init_eagle_params
    from flowspec_tpu_torch.models.llama import init_llama_params
    from flowspec_tpu_torch.train.distill import DraftTrainer, trainable_of
    from flowspec_tpu_torch.train.struct_base import f32_masters, leaves_of
    from flowspec_tpu_torch.train.losses import lm_loss
    from flowspec_tpu_torch.train.teacher import teacher_hiddens
    mc = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    base = init_llama_params(gen, mc, device="cuda")
    tokens = torch.randint(0, 512, (4, 40), generator=gen, device="cuda")
    counters = (int8_matmul, tree_attention, head_topk)
    before = [c.launches for c in counters]
    masters = f32_masters(base)
    ce, _ = lm_loss(masters, tokens, mc)
    ce.backward()
    draft0 = init_eagle_params(gen, mc, embed=base.embed,
                               dtype=torch.float32, width=128)
    tr = DraftTrainer(trainable_of(draft0), base.embed, base.lm_head.float(),
                      draft_view(draft0, mc), lr=1e-3, decay_steps=1,
                      alpha=0.02, hidden_w=0.5, ce_w=1.0)
    assert [c.launches for c in counters] == before
    hiddens = teacher_hiddens(base, tokens, mc, lanes=4)   # the kernel
    assert tree_attention.launches == before[1] + 2
    tr.step(tokens, hiddens)
    assert [c.launches for c in counters][::2] == before[::2]
    assert tree_attention.launches == before[1] + 2
    norms = [float(t.grad.norm()) for t in leaves_of(masters)]
    norms += list(tr.first_grad_norms.values())
    assert all(torch.isfinite(torch.tensor(n)) and n > 0 for n in norms)


# ---- DeepSeek-V3: the latent-attention kernel and a captured round ---------

MLA_S = 4096


@pytest.mark.parametrize("t", [64, 81, 96])
@pytest.mark.parametrize("n_valid", [1, 63, 65, 209, 1000, MLA_S])
def test_mla_attention_matches_plain_with_a_device_n_valid(cuda, t, n_valid):
    """The latent kernel at DeepSeek-V3's widths (128 heads, 576-wide rows,
    512 values) against its plain version, keys 1-4096 live of 4096, the
    live count read from the card; the host count gives the same bits. bf16
    outputs at one rounding (1e-2 relative + 2e-2: a peaked softmax gives
    outputs up to ~4, where one bf16 step is 0.031)."""
    from flowspec_tpu_torch.ops.mla_attention import (
        mla_attention, mla_attention_plain)
    gen = cuda
    q = torch.randn((1, 128, t, 576), generator=gen, device="cuda").to(
        torch.bfloat16)
    latent = torch.randn((1, MLA_S, 576), generator=gen, device="cuda").to(
        torch.bfloat16)
    bias = torch.where(torch.rand((t, MLA_S), generator=gen, device="cuda")
                       < 0.8, 0.0, -1e9)
    bias[:, n_valid:] = -1e9
    bias[:, n_valid - 1] = 0.0                   # every row sees a key
    scale = 192 ** -0.5 * 1.3689
    before = mla_attention.launches
    dev = mla_attention(q, latent, bias, torch.tensor(
        [n_valid], dtype=torch.int32, device="cuda"), scale=scale)
    host = mla_attention(q, latent, bias, n_valid, scale=scale)
    want = mla_attention_plain(q, latent, bias, n_valid, scale=scale)
    torch.cuda.synchronize()
    assert mla_attention.launches == before + 2
    assert torch.equal(dev, host)
    torch.testing.assert_close(dev.float(), want.float(), rtol=1e-2,
                               atol=2e-2)


def test_mla_attention_lanes_match_one_lane_launches(cuda):
    """Two lanes, each with its own (T, S) bias and live rows, in one
    launch: lane b's bits are those of a one-lane launch of lane b."""
    from flowspec_tpu_torch.ops.mla_attention import mla_attention
    gen = cuda
    t, s = 81, 1024
    q = torch.randn((2, 128, t, 576), generator=gen, device="cuda").to(
        torch.bfloat16)
    latent = torch.randn((2, s, 576), generator=gen, device="cuda").to(
        torch.bfloat16)
    n_valid = torch.tensor([300, 777], dtype=torch.int32, device="cuda")
    bias = torch.zeros((2, t, s), device="cuda")
    for b in range(2):
        bias[b, :, int(n_valid[b]):] = -1e9
    both = mla_attention(q, latent, bias, n_valid)
    for b in range(2):
        one = mla_attention(q[b:b + 1], latent[b:b + 1], bias[b],
                            n_valid[b:b + 1])
        assert torch.equal(both[b:b + 1], one)


TINY_DEEPSEEK = {
    "hidden_size": 256, "intermediate_size": 384, "moe_intermediate_size": 128,
    "num_hidden_layers": 3, "first_k_dense_replace": 1,
    "num_attention_heads": 4, "num_key_value_heads": 4, "q_lora_rank": 64,
    "kv_lora_rank": 512, "qk_nope_head_dim": 32, "qk_rope_head_dim": 64,
    "v_head_dim": 32, "n_routed_experts": 8,
    "published": {"n_routed_experts": 16},
    "expert_share": {"ep": 2, "rank": 1}, "n_group": 4, "topk_group": 2,
    "num_experts_per_tok": 4, "n_shared_experts": 1,
    "routed_scaling_factor": 2.5,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 1, "mscale_all_dim": 1,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "rms_norm_eps": 1e-6, "vocab_size": 1024,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "weights": {"precision": "bfloat16"}}


def _tiny_deepseek_engine():
    """A 3-layer bf16 DeepSeek (1 dense + 2 MoE layers, latent rows of
    512 + 64, 8 of 16 experts held, one shared) drawn by the benchmark's
    family, and an int8 draft of its width with 4 heads of 64."""
    import dataclasses
    from benchmark.families import deepseek_v3 as fam
    from benchmark.families.common import Draw
    from flowspec_tpu_torch.config import (
        EngineConfig, ModelConfig, SamplingConfig, TreeConfig)
    from flowspec_tpu_torch.draft.eagle import (
        SizedEagleParams, init_eagle_params, quantize_eagle_params)
    from flowspec_tpu_torch.runtime import SpecEngine
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    w = fam.draw(TINY_DEEPSEEK, Draw(gen, "cuda", torch.bfloat16))
    params, mc = fam.port_params(w), fam.model_config(TINY_DEEPSEEK)
    plain = ModelConfig(vocab_size=1024, hidden_size=256,
                        intermediate_size=384, num_attention_heads=4,
                        num_key_value_heads=4)
    d = quantize_eagle_params(init_eagle_params(
        gen, plain, embed=params.embed), "int8")
    draft = SizedEagleParams(**{f.name: getattr(d, f.name)
                                for f in dataclasses.fields(d)}, head_dim=64)
    tc = TreeConfig(top_k=8, depth=4, total_tokens=24, node_cap=48,
                    leaf_cap=48, depth_cap=12)
    cfg = EngineConfig(model=mc, tree=tc, sampling=SamplingConfig(),
                       max_seq_len=200, prefill_chunk=16)
    return SpecEngine(params, draft, cfg)


def test_deepseek_graph_replay_equals_eager_round_bits(cuda):
    """A DeepSeek round (latent cache, the MLA kernel, the group-limited
    router, the expert share through batched products) captures and
    replays with the eager round's bits; the graph
    launches the MLA kernel once a layer; fused streams equal eager ones,
    spec and AR."""
    from flowspec_tpu_torch.runtime import graphs
    eng = _tiny_deepseek_engine()
    prompt = list(range(3, 40))
    state = eng.prefill(eng.init_state(0), prompt)
    assert state.base_cache.v is None
    loop = graphs._loop_buffers(64, -1, state.commit_len.device)
    eager, eager_loop = graphs._clone(state), graphs._clone(loop)
    g = graphs.DecodeGraph(eng, graphs._spec_body, state, loop)
    assert g.launches["mla_attention"] == 3
    assert "int8_matmul" in g.launches and "head_topk" in g.launches
    for _ in range(3):
        g.replay()
        eager = graphs._spec_body(eng, eager, eager_loop)
        torch.cuda.synchronize()
        for a, b in zip(graphs._fields(g.state), graphs._fields(eager)):
            assert torch.equal(a, b)
        for a, b in zip(graphs._fields(g.loop), graphs._fields(eager_loop)):
            assert torch.equal(a, b)
    spec, stats = eng.generate(prompt, max_new_tokens=30, eos_token_id=-1)
    fused, fstats = eng.generate_fused(prompt, max_new_tokens=30,
                                       eos_token_id=-1)
    assert fused == spec and fstats["rounds"] == stats["rounds"]
    ar, _ = eng.generate_ar(prompt, max_new_tokens=16, eos_token_id=-1)
    ar_fused, _ = eng.generate_ar_fused(prompt, max_new_tokens=16,
                                        eos_token_id=-1)
    assert ar_fused == ar
