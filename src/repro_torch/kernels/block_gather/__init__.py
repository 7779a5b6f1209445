"""Block-migration copy: CUDA kernel (csrc/block_gather.cu) + plain version."""
