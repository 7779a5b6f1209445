"""Layer-B KV cache management: the Rainbow-paged cache (kvcache)."""
