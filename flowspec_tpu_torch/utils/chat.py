"""Chat prompt templates: vicuna / llama-2-chat / llama-3.

The port's copy of `flowspec_tpu/utils/chat.py` (plain Python; the port
imports nothing of the JAX package): every template gives the JAX
package's string. Reference: run_pipe.py:57-108 builds prompts with
fastchat conversation templates for "vicuna", "llama-2-chat" and a
hand-rolled llama-3 format. Multi-turn: pass the full list of (user,
assistant) exchanges; the last user turn has assistant=None.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

VICUNA_SYSTEM = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's "
    "questions.")

LLAMA2_SYSTEM = (
    "You are a helpful, respectful and honest assistant. Always answer as "
    "helpfully as possible, while being safe. Your answers should not "
    "include any harmful, unethical, racist, sexist, toxic, dangerous, or "
    "illegal content. Please ensure that your responses are socially "
    "unbiased and positive in nature.\n\nIf a question does not make any "
    "sense, or is not factually coherent, explain why instead of answering "
    "something not correct. If you don't know the answer to a question, "
    "please don't share false information.")


def build_prompt(turns: List[Tuple[str, Optional[str]]],
                 template: str = "vicuna",
                 system: Optional[str] = None) -> str:
    """turns: [(user, assistant_or_None), ...]; returns the prompt string up
    to (and including) the assistant generation cue for the final turn."""
    if template == "vicuna":
        sys_ = system if system is not None else VICUNA_SYSTEM
        out = sys_ + " "
        for user, asst in turns:
            out += f"USER: {user} ASSISTANT:"
            if asst is not None:
                out += f" {asst}</s>"
        return out
    if template in ("llama2", "llama-2-chat"):
        sys_ = system if system is not None else LLAMA2_SYSTEM
        out = ""
        for i, (user, asst) in enumerate(turns):
            content = (f"<<SYS>>\n{sys_}\n<</SYS>>\n\n{user}"
                       if i == 0 else user)
            out += f"[INST] {content} [/INST]"
            if asst is not None:
                out += f" {asst} "
        return out
    if template in ("llama3", "llama-3"):
        sys_ = system if system is not None else \
            "You are a helpful assistant."
        out = ("<|begin_of_text|><|start_header_id|>system<|end_header_id|>"
               f"\n\n{sys_}<|eot_id|>")
        for user, asst in turns:
            out += (f"<|start_header_id|>user<|end_header_id|>\n\n{user}"
                    "<|eot_id|><|start_header_id|>assistant<|end_header_id|>"
                    "\n\n")
            if asst is not None:
                out += f"{asst}<|eot_id|>"
        return out
    raise ValueError(f"unknown template {template!r}")
