"""The traffic generator: one seed, one draw; two seeds, one set of sizes
in two orders with other token ids; the chat mix's lengths are those of
the question files, and its requests grow their KV buckets."""

import glob
import itertools
import json

import pytest

from benchmark.lib import spec, traffic
from benchmark.tests import tiny
from flowspec_tpu_torch.utils.chat import build_prompt


def take(mix, seed, n, vocab=1000):
    return list(itertools.islice(traffic.requests(mix, seed, vocab), n))


def plan(p, n, engine, depth_cap):
    """The KV buckets a request of p + n tokens runs in, as
    `SpecEngine._plan_buckets` plans them."""
    full = engine["max_seq_len"]
    out = []
    for s in sorted(set(engine["kv_buckets"]) | {full}):
        if s <= full and s >= p + depth_cap + 1:
            out.append(s)
            if s >= p + n + depth_cap + 1:
                break
    return out


def test_same_seed_same_requests():
    mix = spec.mix("chat")
    assert take(mix, 2**31 + 7, 12) == take(mix, 2**31 + 7, 12)


def test_other_seed_other_order_same_sizes():
    mix = spec.mix("chat")
    a, b = take(mix, 1, 16), take(mix, 2, 16)
    assert [r.prompt for r in a] != [r.prompt for r in b]
    for block in (0, 1):
        sizes = lambda rs: sorted((len(r.prompt), r.max_new) for r in rs
                                  if r.block == block)
        assert sizes(a) == sizes(b) == sorted(traffic.sizes(mix))


def test_sizes_follow_the_laws():
    mix = spec.mix("chat")
    pairs = traffic.sizes(mix)
    assert len(pairs) == mix["block"]
    vals = sorted(mix["prompt_tokens"])
    # stratified quantiles of the measured lengths
    assert sorted(p for p, _ in pairs) == [
        vals[int((k + 0.5) / len(pairs) * len(vals))]
        for k in range(len(pairs))]
    assert {n for _, n in pairs} == {128}
    depth_cap = spec.config("qwen2-7b-int8")["tree"]["depth_cap"]
    # every request fits the engine's KV
    assert max(p + n for p, n in pairs) + depth_cap + 1 <= (
        mix["engine"]["max_seq_len"])


def test_chat_lengths_are_the_question_files():
    """The first turn of every question of FlowSpec's six evaluation sets
    in the vicuna template, a token a byte."""
    lengths = []
    for path in sorted(glob.glob(str(spec.ROOT.parent / "data" / "*"
                                     / "question.jsonl"))):
        for line in open(path):
            q = json.loads(line)
            lengths.append(len(build_prompt([(q["turns"][0], None)],
                                            "vicuna").encode()))
    assert len(lengths) == 480
    assert sorted(lengths) == spec.mix("chat")["prompt_tokens"]


def test_token_ids_within_the_vocabulary():
    reqs = take(spec.mix("chat"), 3, 8, vocab=152064)
    toks = [t for r in reqs for t in r.prompt]
    assert 0 <= min(toks) and max(toks) < 152064


def test_window_requests_grow_their_buckets():
    """Requests of the window cross each bucket boundary that the mix's
    buckets have, so the growth is timed and checked."""
    depth_cap = spec.config("qwen2-7b-int8")["tree"]["depth_cap"]
    mix = spec.mix("chat")
    plans = [plan(p, n, mix["engine"], depth_cap)
             for p, n in traffic.sizes(mix)]
    steps = {tuple(pl[i:i + 2]) for pl in plans for i in range(len(pl) - 1)}
    assert steps == {(256, 512), (512, 1024)}
    assert sum(len(pl) > 1 for pl in plans) >= len(plans) // 2
    # the tiny cells' mix grows too, so the CPU tests' runs take the path
    tiny_mix = dict(mix, **tiny.MIX)
    assert any(len(plan(p, n, tiny_mix["engine"], depth_cap)) > 1
               for p, n in traffic.sizes(tiny_mix))


def test_warmup_serves_every_bucket_and_growth_the_window_meets():
    depth_cap = spec.config("qwen2-7b-int8")["tree"]["depth_cap"]
    for mix in (spec.mix("chat"), dict(spec.mix("chat"), **tiny.MIX)):
        warm = traffic.warmup(mix, depth_cap)
        assert set(warm) <= set(traffic.sizes(mix))

        def covered(pairs):
            pls = [plan(p, n, mix["engine"], depth_cap) for p, n in pairs]
            return ({b for pl in pls for b in pl},
                    {tuple(pl[i:i + 2]) for pl in pls
                     for i in range(len(pl) - 1)})
        assert covered(warm) == covered(traffic.sizes(mix))
    assert traffic.warmup(spec.mix("chat"), depth_cap) == [(239, 128),
                                                           (481, 128)]


@pytest.mark.parametrize("extra", [{"clients": 4}, {"loop": "open"},
                                   {"greedy": False}, {"eos_token_id": 2}])
def test_a_mix_setting_what_the_harness_does_not_run_is_refused(
        extra, tmp_path):
    mix = dict(spec.mix("chat"), **extra)
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "chat.json").write_text(json.dumps(mix))
    with pytest.raises(ValueError, match="does not act on"):
        spec.mix("chat", tmp_path)
    law = dict(spec.mix("chat"), new_tokens={"law": "lognormal",
                                             "median": 96, "sigma": 0.6})
    with pytest.raises(ValueError, match="list of lengths"):
        traffic.check_mix(law)
