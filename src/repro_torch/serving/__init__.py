"""Layer-B serving: decode over the Rainbow-paged KV cache."""
