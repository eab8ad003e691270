"""Transformer layers and stack in PyTorch (the attention-backbone block kinds)."""
