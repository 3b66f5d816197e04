from .hex_layout import HexLayout
from .model import StructuredModel, structured_rollout_diff
from .sharded import ShardedStructuredModel

__all__ = [
    "HexLayout",
    "StructuredModel",
    "ShardedStructuredModel",
    "structured_rollout_diff",
]
