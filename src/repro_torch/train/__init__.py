"""The train step and the training loop."""
