"""Paged decode attention: CUDA kernel (csrc/rainbow_attention.cu) + plain version."""
