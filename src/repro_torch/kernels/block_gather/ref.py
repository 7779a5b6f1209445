"""Plain PyTorch version of the block-migration copy kernel.

``repro.kernels.block_gather.ref.block_gather_ref``'s function, in place
over a leading layer axis: ``hot[:, dst[k]] = cap[:, src[k]]`` for lanes with
0 <= src < NB and 0 <= dst < HOT (src = -1 marks a skip lane); other hot
rows keep their contents.
"""
from __future__ import annotations

import torch


def block_gather_ref_(pairs, src: torch.Tensor, dst: torch.Tensor) -> None:
    """`pairs`: (cap [L, NB, ...], hot [L, HOT, ...]) pool pairs, updated in place."""
    for cap, hot in pairs:
        ok = (src >= 0) & (src < cap.shape[1]) & (dst >= 0) & (dst < hot.shape[1])
        hot[:, dst[ok].long()] = cap[:, src[ok].long()]
