"""Benchmark / evaluation harness (ref eval/run_pipe_eval.py)."""

from flowspec_tpu_torch.eval.harness import (
    EvalResult, load_questions, run_eval, run_eval_serve,
)

__all__ = ["EvalResult", "run_eval", "run_eval_serve", "load_questions"]
