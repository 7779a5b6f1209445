"""Rainbow core: counting, migration, bitmap, remap and split TLBs on tensors."""
