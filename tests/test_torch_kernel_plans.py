"""The host-side plans of the two attention kernels, pinned on the CPU:
how the decode attention splits its KV blocks across CTAs
(`rainbow_attention.ops.kv_splits`), and which forward kernel the flash
attention launches for each dtype (`flash_attention.ops.flash_route`).
Nothing launches; the kernels themselves are held to their plain versions
on the card (tests/test_torch_gpu.py)."""
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rainbow_attention import ops as attn_ops

# (nblk, block): the serving shape, a partial last split, fewer blocks than
# one split, one block per split, sixteen, a block that does not divide 64,
# single-token blocks
SPLIT_CASES = {
    "serve-20x16": (20, 16),
    "partial-21x16": (21, 16),
    "one-split-3x16": (3, 16),
    "block64-5x64": (5, 64),
    "block4-40x4": (40, 4),
    "block48-7x48": (7, 48),
    "block5-30x5": (30, 5),
    "block1-130x1": (130, 1),
}


def _readable(split: int, per: int, nblk: int, block: int, length: int) -> int:
    """Readable positions of a split, as the split kernel counts them."""
    j0 = split * per
    return min(length - j0 * block, min(per, nblk - j0) * block)


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_kv_splits_cover_every_block_once_at_block_boundaries(case):
    nblk, block = SPLIT_CASES[case]
    nsplit, per = attn_ops.kv_splits(nblk, block)
    assert per >= 1
    assert per * block <= max(attn_ops.SPLIT_POSITIONS, block)  # fits a split
    spans = [list(range(s * per, min(nblk, (s + 1) * per))) for s in range(nsplit)]
    assert all(spans), "no split is empty by plan"
    assert [j for span in spans for j in span] == list(range(nblk))


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_kv_splits_read_each_position_once_whatever_the_length(case):
    nblk, block = SPLIT_CASES[case]
    nsplit, per = attn_ops.kv_splits(nblk, block)
    for length in range(nblk * block + 2):
        # the plan is a function of (nblk, block) alone
        assert attn_ops.kv_splits(nblk, block) == (nsplit, per)
        read = []
        for s in range(nsplit):
            n = _readable(s, per, nblk, block, length)
            read += range(s * per * block, s * per * block + max(n, 0))
        assert read == list(range(min(length, nblk * block)))


@pytest.mark.parametrize("hd", flash_ops.HEAD_DIMS)
def test_flash_route_bf16_takes_the_tensor_cores(hd):
    assert flash_ops.flash_route(torch.bfloat16, hd) == "mma"


@pytest.mark.parametrize("hd", flash_ops.HEAD_DIMS)
def test_flash_route_float32_takes_the_cuda_cores(hd):
    assert flash_ops.flash_route(torch.float32, hd) == "simt"


@pytest.mark.parametrize("dtype, hd", [(torch.float16, 128), (torch.bfloat16, 24),
                                       (torch.float32, 256)])
def test_flash_route_refuses_what_no_kernel_takes(dtype, hd):
    with pytest.raises(ValueError, match="flash_attention"):
        flash_ops.flash_route(dtype, hd)
