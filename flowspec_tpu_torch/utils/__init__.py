"""Tools & observability: profiler, chat templates."""

from flowspec_tpu_torch.utils.chat import build_prompt
from flowspec_tpu_torch.utils.profiler import Profiler, prof

__all__ = ["Profiler", "prof", "build_prompt"]
