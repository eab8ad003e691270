"""Transformer layers and stack in PyTorch (dense attention backbones)."""
