"""Serving step helpers shared by the decode loops."""
from __future__ import annotations

import torch


def greedy_sample(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """First maximal index over the real vocab (``jnp.argmax``'s tie rule), int32."""
    return torch.argmax(logits[..., :vocab_size], dim=-1).to(torch.int32)
