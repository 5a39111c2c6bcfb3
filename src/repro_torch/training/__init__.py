"""Training: AdamW, data, npz checkpoints and the train loop."""
