"""Training: train state and optimizer, the train step, checkpoints."""
