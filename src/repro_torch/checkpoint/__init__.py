from repro_torch.checkpoint.store import CheckpointManager, latest_step, restore_state, save_state
