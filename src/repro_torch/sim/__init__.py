"""Layer-A simulator: configuration, traces, the per-access walk and the runner."""
