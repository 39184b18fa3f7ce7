"""Training on one device: the optimizer, the train step, synthetic data,
checkpoints and the checkpoint-restart loop."""
