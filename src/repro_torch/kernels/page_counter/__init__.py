"""The fused observe counter: CUDA kernel (csrc/page_counter.cu) + plain version."""
