"""The port's pipeline units against the JAX package's, on the CPU.

Partition (`split_close_equal`, `partition_lengths`, `retrieve_cum_depths`,
`_queue_appended`), pruning (`compute_pruning_info`, `prune_tree`,
`kv_keep_positions`), `merge_trees` (the identical-tree no-op and the
capacity spill included) and `expand_tree` get the same inputs on both
sides and must give the same outputs. Uneven layer splits, (1, 1, 2, 2) and
(0, 2, 2, 2) (a stage of no layers), decode as JAX's engine does, and
`PipeState` checkpoints written by the JAX package with the (0, 2, 2, 2)
split (its padded slot layout) load in the port and resume token for
token, as do the port's own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowspec_tpu.config import (
    ModelConfig as JModelConfig, TreeConfig as JTreeConfig,
)
from flowspec_tpu.draft.beam import expand_tree as j_expand_tree
from flowspec_tpu.draft.beam import topk_generate as j_topk_generate
from flowspec_tpu.draft.eagle import draft_context_forward as j_draft_ctx
from flowspec_tpu.draft.eagle import init_eagle_params
from flowspec_tpu.models import checkpoint as jckpt
from flowspec_tpu.models.kv_cache import init_kv_cache as j_init_kv
from flowspec_tpu.models.llama import init_llama_params
from flowspec_tpu.parallel import PipelineEngine as JPipelineEngine
from flowspec_tpu.parallel.pipeline import _queue_appended as j_queue
from flowspec_tpu_torch import config as tcfg
from flowspec_tpu_torch.draft.beam import expand_tree, topk_generate
from flowspec_tpu_torch.draft.eagle import draft_context_forward
from flowspec_tpu_torch.models import checkpoint as ckpt
from flowspec_tpu_torch.models.kv_cache import init_kv_cache
from flowspec_tpu_torch.parallel import PipelineEngine
from flowspec_tpu_torch.parallel.pipeline import (
    _queue_appended, from_slots, slot_layers, to_slots,
)
from flowspec_tpu_torch.tree.merge import merge_trees
from flowspec_tpu_torch.tree.partition import (
    partition_lengths, rebucket_lengths, retrieve_cum_depths,
    split_close_equal,
)
from flowspec_tpu_torch.tree.prune import (
    compute_pruning_info, kv_keep_positions, prune_tree,
)
from flowspec_tpu_torch.runtime import SpecEngine
from flowspec_tpu_torch.tree.types import TokenTree
from tests.helpers import (
    j_cum_depths, j_kv_keep, j_merge_trees, j_partition, j_prune_tree,
    j_pruning_info, j_split, to_token_tree,
)
from tests.oracle import random_tree
from tests.test_torch_pipeline import TREE, configs, lossless, tiny_model
from tests.torch_bridge_util import port_eagle, port_llama


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tensors are tiny: the port's ops run on one thread, leaving
    the other cores to the test workers beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t_(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def port_tree(jt) -> TokenTree:
    return TokenTree(**{f.name: t_(getattr(jt, f.name))
                        for f in dataclasses.fields(TokenTree)})


def assert_tree_equal(got: TokenTree, want):
    """Every integer field equal; the f32 scores (cumulative draft log-probs
    the two packages compute apart) within 1e-5."""
    for f in dataclasses.fields(TokenTree):
        g, w = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
        if f.name == "scores":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f.name)


# ---- partition --------------------------------------------------------------

def test_split_close_equal_matches_jax():
    for total in range(1, 40):
        for n in range(1, 8):
            got = split_close_equal(torch.tensor(total), n)
            want = j_split(jnp.asarray(total), n)
            assert got.tolist() == np.asarray(want).tolist(), (total, n)


@pytest.mark.parametrize("stages", [2, 4])
def test_partition_lengths_matches_jax(stages):
    for n_tokens in (3, 20, 63, 65, 81, 100):
        for chunk in (6, 8, 16):
            lens, nch = partition_lengths(
                torch.tensor(n_tokens, dtype=torch.int32), stages, chunk, 16)
            jl, jn = j_partition(jnp.asarray(n_tokens), stages, chunk, 16)
            assert lens.tolist() == np.asarray(jl).tolist()
            assert int(nch) == int(jn)


def test_cum_depths_and_rebucket_match_jax():
    rng = np.random.default_rng(3)
    for n in (6, 17, 40, 63):
        t = random_tree(rng, n)
        jt = to_token_tree(t)
        lens = np.zeros(8, np.int32)
        lens[:4] = np.asarray(j_split(jnp.asarray(n), 4))
        got = retrieve_cum_depths(t_(jt.retrieve), t_(lens))
        want = j_cum_depths(jt.retrieve, jnp.asarray(lens))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        kept = np.sort(rng.choice(n, size=n // 2, replace=False))
        kept = np.concatenate([kept, -np.ones(64 - len(kept))]).astype(
            np.int32)
        from flowspec_tpu.tree.partition import rebucket_lengths as j_reb
        got = rebucket_lengths(t_(lens), t_(kept), n // 2)
        want = j_reb(jnp.asarray(lens), jnp.asarray(kept), n // 2)
        assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("cap", [-1, 5])
def test_queue_appended_matches_jax(cap):
    lens = np.zeros(8, np.int32)
    lens[:2] = 6
    for s_cap in (4, 8):
        for n_app in (0, 3, 13):
            for nch in (0, 2):
                i32 = lambda v: torch.tensor(v, dtype=torch.int32)
                got = _queue_appended(t_(lens), i32(nch), i32(n_app), cap,
                                      s_cap)
                want = j_queue(jnp.asarray(lens), jnp.asarray(nch, jnp.int32),
                               jnp.asarray(n_app, jnp.int32), cap, s_cap)
                assert got[0].tolist() == np.asarray(want[0]).tolist()
                assert int(got[1]) == int(want[1])
                assert bool(got[2]) == bool(want[2])


# ---- prune and merge --------------------------------------------------------

def _prune_case(rng, n, vocab):
    t = random_tree(rng, n, vocab=vocab)
    jt = to_token_tree(t)
    ri = t.retrieve()
    best = int(rng.integers(ri.shape[0]))
    accept = int(rng.integers(1, int((ri[best] >= 0).sum()) + 1))
    return jt, best, accept, int(rng.integers(vocab))


def test_prune_matches_jax():
    rng = np.random.default_rng(10)
    n_trunc = 0
    for _ in range(30):
        jt, best, accept, sampled = _prune_case(
            rng, int(rng.integers(3, 60)), 12)
        want = j_pruning_info(jt, jnp.asarray(best), jnp.asarray(accept),
                              jnp.asarray(sampled))
        tree = port_tree(jt)
        got = compute_pruning_info(tree, best, accept, sampled)
        for name, g in got._asdict().items():
            np.testing.assert_array_equal(g.numpy(),
                                          np.asarray(getattr(want, name)),
                                          err_msg=name)
        n_trunc += bool(got.truncate)
        assert_tree_equal(prune_tree(tree, got), j_prune_tree(jt, want))
    assert 3 < n_trunc < 27          # both branches exercised


def test_kv_keep_positions_matches_jax():
    rng = np.random.default_rng(11)
    for _ in range(20):
        jt, best, accept, sampled = _prune_case(rng, 30, 8)
        want_info = j_pruning_info(jt, jnp.asarray(best),
                                   jnp.asarray(accept), jnp.asarray(sampled))
        info = compute_pruning_info(port_tree(jt), best, accept, sampled)
        for kv_in_tree in (0, 17, 30):
            src, n_src = kv_keep_positions(info, torch.tensor(100),
                                           torch.tensor(kv_in_tree), 80)
            wsrc, wn = j_kv_keep(want_info, jnp.asarray(100),
                                 jnp.asarray(kv_in_tree), 80)
            assert int(n_src) == int(wn)
            assert src.tolist() == np.asarray(wsrc).tolist()


def _merge_both(t1, t2, **caps):
    j1, j2 = to_token_tree(t1, **caps), to_token_tree(t2, **caps)
    want = j_merge_trees(j1, j2)
    got = merge_trees(port_tree(j1), port_tree(j2))
    assert_tree_equal(got.tree, want.tree)
    assert int(got.n_appended) == int(want.n_appended)
    assert got.map2_to_merged.tolist() == \
        np.asarray(want.map2_to_merged).tolist()
    return got


def test_merge_matches_jax():
    rng = np.random.default_rng(12)
    for _ in range(25):
        t1 = random_tree(rng, int(rng.integers(2, 32)), vocab=10)
        t2 = random_tree(rng, int(rng.integers(2, 32)), vocab=10)
        t1.tokens[0] = t2.tokens[0] = 3
        _merge_both(t1, t2)


def test_merge_identical_trees_is_noop():
    t = random_tree(np.random.default_rng(13), 25, vocab=10)
    got = _merge_both(t, t)
    assert int(got.n_appended) == 0 and int(got.tree.n_nodes) == t.n


def test_merge_capacity_spill_matches_jax():
    rng = np.random.default_rng(14)
    for _ in range(4):
        t1 = random_tree(rng, 20, vocab=6)
        t2 = random_tree(rng, 30, vocab=6)
        t2.tokens[0] = t1.tokens[0]
        got = _merge_both(t1, t2, node_cap=32, leaf_cap=32)
        n = int(got.tree.n_nodes)
        assert n == 32
        par = got.tree.parents[:n].numpy()
        assert (par[1:] < np.arange(1, n)).all()


# ---- expand_tree ------------------------------------------------------------

def test_expand_tree_matches_jax_and_merges_new_nodes():
    """topk_generate then expand_tree on the same draft and context: the
    same trees as JAX's, a superset whose merge appends exactly the new
    nodes (`tests/test_draft_expand.py:20`)."""
    mc = JModelConfig.tiny(vocab_size=64, n_layers=1)
    mc = dataclasses.replace(mc, dtype="float32")
    tree = dict(top_k=6, depth=3, total_tokens=16, expand_tokens=12,
                expand_depth=2, node_cap=64, leaf_cap=48, depth_cap=12,
                chunk_len=8)
    jtc = JTreeConfig(**tree)
    tc = tcfg.TreeConfig(**tree)
    pmc = tcfg.ModelConfig(**dataclasses.asdict(mc))
    params = init_llama_params(jax.random.key(0), mc, dtype=jnp.float32)
    jd = init_eagle_params(jax.random.key(1), mc, embed=params.embed,
                           dtype=jnp.float32)
    d = port_eagle(jd)
    rows = 128 + (tc.depth + tc.expand_depth) * tc.top_k
    rng = np.random.default_rng(0)
    ctx_t = rng.integers(0, 64, 8).astype(np.int32)
    ctx_h = rng.normal(size=(1, 8, mc.hidden_size)).astype(np.float32)

    jcache = j_init_kv(1, 1, mc.num_key_value_heads, rows, mc.head_dim_,
                       jnp.float32)
    jout, jcache = j_draft_ctx(jd, jcache, jnp.asarray(ctx_t),
                               jnp.asarray(ctx_h), jnp.asarray(0),
                               jnp.asarray(8), mc)
    jroot = jnp.asarray(5, jnp.int32)

    @jax.jit     # one program: the eager scans compile op by op
    def j_trees(cache, root, hidden):
        t1, st, cache = j_topk_generate(jd, params.lm_head, cache, root,
                                        hidden, jtc, mc)
        t2, _, _ = j_expand_tree(jd, params.lm_head, cache, st, root, jtc,
                                 mc, extra_depth=2, expand_size=12)
        return t1, t2
    jt1, jt2 = j_trees(jcache, jroot, jout[0, 7])

    cache = init_kv_cache(1, 1, mc.num_key_value_heads, rows, mc.head_dim_,
                          torch.float32).with_length(0)
    out, cache = draft_context_forward(d, cache, t_(ctx_t), t_(ctx_h), 0, 8,
                                       pmc)
    head = t_(params.lm_head)
    root = torch.tensor(5, dtype=torch.int32)
    t1, st, cache = topk_generate(d, head, cache, root, out[0, 7], tc, pmc)
    t2, st2, cache = expand_tree(d, head, cache, st, root, tc, pmc,
                                 extra_depth=2, expand_size=12)
    assert_tree_equal(t1, jt1)
    assert_tree_equal(t2, jt2)
    assert st2.level == tc.depth + 2
    n1, n2 = int(t1.n_nodes), int(t2.n_nodes)
    assert n1 < n2 <= n1 + 12
    mr = merge_trees(t1, t2)
    assert int(mr.n_appended) == n2 - n1
    assert mr.tree.tokens[:n1].tolist() == t1.tokens[:n1].tolist()
    assert mr.tree.parents[:n1].tolist() == t1.parents[:n1].tolist()


# ---- PipeState checkpoints --------------------------------------------------

SPLIT = (0, 2, 2, 2)


def test_slot_layout_round_trip():
    x = torch.arange(6 * 3, dtype=torch.float32).reshape(6, 3)
    padded = to_slots(x, SPLIT)
    assert padded.shape == (8, 3) and slot_layers(SPLIT) == [2, 3, 4, 5, 6, 7]
    assert not padded[:2].any()
    assert torch.equal(from_slots(padded, SPLIT), x)
    assert slot_layers((1, 1, 2, 2)) == [0, 2, 4, 5, 6, 7]


def uneven(split):
    """tests/test_pipeline.py:199's setup (vocab 12, six layers) on the
    layer split `split`: ((JAX, port) continuous engines, the port's AR
    engine)."""
    mc = tiny_model(12, n_layers=6)
    jcfg, cfg = configs(mc, TREE, topology=(4, split))
    p = init_llama_params(jax.random.key(11), mc, dtype=jnp.float32)
    d = init_eagle_params(jax.random.key(111), mc, embed=p.embed,
                          dtype=jnp.float32)
    tp, td = port_llama(p), port_eagle(d)
    return ((JPipelineEngine(p, d, jcfg, schedule="continuous"),
             PipelineEngine(tp, td, cfg, schedule="continuous",
                            device="cpu")),
            SpecEngine(tp, td, cfg, device="cpu"))


@pytest.fixture(scope="module")
def uneven_pair():
    return uneven(SPLIT)


@pytest.mark.parametrize("split", [(1, 1, 2, 2), SPLIT])
def test_uneven_layer_split_matches_jax(uneven_pair, split):
    """Each stage holds its own layer count (JAX pads to p * max(split)
    identity layers instead); a stage of 0 layers passes its chunk on."""
    (jeng, eng), port_ar = uneven_pair if split == SPLIT else uneven(split)
    assert eng.layer_split == split
    assert [hi - lo for lo, hi in eng.stage_layers] == list(split)
    prompt = [int(t) for t in np.random.default_rng(3).integers(3, 11, 9)]
    lossless(jeng, eng, prompt, 20, port_ar)


def test_jax_pipe_state_resumes_in_the_port(tmp_path, uneven_pair):
    """A greedy PipeState saved by the JAX engine (uneven split, padded
    slots) loads in the port and resumes with the JAX engine's tokens and
    statistics."""
    jeng, eng = uneven_pair[0]
    assert eng.layer_split == SPLIT
    rng = np.random.default_rng(3)
    prompt = rng.integers(3, 11, 9).tolist()
    extra = rng.integers(3, 11, 6).tolist()
    out1, _, jst = jeng.generate(prompt, max_new_tokens=10, eos_token_id=-1,
                                 return_state=True)
    out1 = [int(t) for t in out1]
    jckpt.save_state(jst, str(tmp_path / "jax"))
    commit = int(jst.commit_len)
    want, wstats = jeng.resume_and_generate(jst, out1, extra,
                                            max_new_tokens=10,
                                            eos_token_id=-1)
    st = ckpt.load_state(str(tmp_path / "jax"), device="cpu",
                         layer_split=eng.layer_split)
    assert st.kv.k.shape[0] == 6 and st.rng.shape == (1, 2)
    assert int(st.commit_len) == commit
    got, stats = eng.resume_and_generate(st, out1, extra, max_new_tokens=10,
                                         eos_token_id=-1)
    assert got == [int(t) for t in want]
    assert stats == wstats


def test_port_pipe_state_round_trip(tmp_path, uneven_pair):
    """Port -> port: saved in the slot layout (zeros in the padded
    slots), loaded bit-equal, resumed equal to the uninterrupted state's
    resume; without the split a PipeState is refused."""
    _, eng = uneven_pair[0]
    rng = np.random.default_rng(4)
    prompt = rng.integers(3, 11, 8).tolist()
    extra = rng.integers(3, 11, 5).tolist()
    out1, _, st = eng.generate(prompt, max_new_tokens=8, eos_token_id=-1,
                               return_state=True)
    ckpt.save_state(st, str(tmp_path / "port"), layer_split=eng.layer_split)
    raw = ckpt.load_params(str(tmp_path / "port"), device="cpu",
                           layer_split=(8,))
    assert raw.kv.k.shape[0] == 8 and not raw.kv.k[:2].any()
    st2 = ckpt.load_state(str(tmp_path / "port"), device="cpu",
                          layer_split=eng.layer_split)
    for f in ("commit_len", "root_token", "pend_tok", "pend_hid", "pend_n",
              "rng"):
        assert torch.equal(getattr(st2, f), getattr(st, f)), f
    assert torch.equal(st2.kv.k, st.kv.k)
    assert torch.equal(st2.draft_cache.v, st.draft_cache.v)
    got = eng.resume_and_generate(st2, out1, extra, max_new_tokens=8,
                                  eos_token_id=-1)
    want = eng.resume_and_generate(st, out1, extra, max_new_tokens=8,
                                   eos_token_id=-1)
    assert got == want
    with pytest.raises(ValueError, match="layer_split"):
        ckpt.save_state(st, str(tmp_path / "x"))
