from repro_torch.train.step import TrainStepConfig, build_train_step, init_train_state
