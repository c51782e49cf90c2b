from flowspec_tpu_torch.runtime.batched import (
    BatchedSpecEngine, ConversationStore, adapt_tree_for_batch,
)
from flowspec_tpu_torch.runtime.engine import SpecEngine

__all__ = ["SpecEngine", "BatchedSpecEngine", "ConversationStore",
           "adapt_tree_for_batch"]
