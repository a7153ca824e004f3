"""Training: schedules, checkpoints, the LM trainer and its fit loop."""
