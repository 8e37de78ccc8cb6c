"""Training: targets-to-loss, optimizer, train step and checkpoints."""
