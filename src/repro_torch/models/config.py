"""Model configuration: the dense-family subset of the reference's ModelConfig.

Same field names and defaults as ``repro.models.config.ModelConfig`` for the
fields the dense decode path reads, so a configuration crosses over field by
field.  Only tp = 1 is ported: the padded head and kv-slot counts are those
of one device.
"""
from __future__ import annotations

import dataclasses
from typing import Literal


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense"]
    num_layers: int
    d_model: int
    num_heads: int  # query heads
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qk_norm: bool = False
    rope_theta: float = 1e6
    norm: Literal["rmsnorm"] = "rmsnorm"
    act: Literal["silu"] = "silu"
    gated_mlp: bool = True
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    vocab_pad_multiple: int = 256

    @property
    def padded_vocab(self) -> int:
        return _ceil_to(self.vocab_size, self.vocab_pad_multiple)

    def padded_heads(self, tp: int = 1) -> int:
        _require_tp1(tp)
        return self.num_heads

    def kv_store(self, tp: int = 1) -> int:
        """Stored kv-head slots (tp = 1: the kv heads themselves)."""
        _require_tp1(tp)
        return self.num_kv_heads


def _require_tp1(tp: int) -> None:
    if tp != 1:
        raise NotImplementedError(
            f"tensor parallelism (tp={tp}) is not ported yet; only tp=1 runs"
        )
