"""The check sees a fault the cell can have: a run with the timed path
broken underneath comes out not correct, the same run unbroken correct.
A cell serves one request at a time on one card, so of the faults that
break a step, a batch or an exchange only these can occur: a round that
returns its state unchanged, a token altered where it is produced, and a
KV bucket's growth that loses the cache it moves."""

import pytest

from benchmark import run
from benchmark.tests import tiny
from flowspec_tpu_torch.runtime import engine, graphs


def broken_build(monkeypatch, break_engine):
    build = run.build

    def patched(*a, **kw):
        w, eng = build(*a, **kw)
        break_engine(eng)
        return w, eng
    monkeypatch.setattr(run, "build", patched)


def state_unchanged(eng):
    inner = eng._round

    def round_(state):
        _, accepted, n_acc = inner(state)
        return state, accepted, n_acc
    eng._round = round_


def token_altered(monkeypatch):
    inner = graphs.spec_decode_loop
    vocab = 512

    def loop(eng, state, eos_id, budget, commit_cap):
        toks, rounds, done, state = inner(eng, state, eos_id, budget,
                                          commit_cap)
        if toks:
            toks[len(toks) // 2] = (toks[len(toks) // 2] + 1) % vocab
        return toks, rounds, done, state
    monkeypatch.setattr(graphs, "spec_decode_loop", loop)


def kv_lost_in_growth(monkeypatch):
    inner = engine._grow_kv

    def grow(state, draft_rows, base_rows):
        out = inner(state, draft_rows, base_rows)
        out.base_cache.k.zero_()
        out.base_cache.v.zero_()
        return out
    monkeypatch.setattr(engine, "_grow_kv", grow)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
@pytest.mark.parametrize("fault", ["none", "state_unchanged",
                                   "token_altered", "kv_lost_in_growth"])
def test_a_broken_path_is_not_correct(cell, fault, tmp_path, monkeypatch):
    root, bench = tiny.make_root(tmp_path)
    if fault == "state_unchanged":
        broken_build(monkeypatch, state_unchanged)
    elif fault == "token_altered":
        token_altered(monkeypatch)
    elif fault == "kv_lost_in_growth":
        kv_lost_in_growth(monkeypatch)
    res = run.run_cell(cell, 2**31 + 3, 0.3, False, "cpu", root=root,
                       bench=bench)
    assert res["correct"] is (fault == "none"), res["check"]
