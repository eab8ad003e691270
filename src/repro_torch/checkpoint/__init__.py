"""Checkpointing of the port: leaf-per-file saves with an NB-tree manifest,
and the LSN-keyed engine snapshots of the durability layer."""
from .checkpointer import CheckpointError, Checkpointer, EngineCheckpointer

__all__ = ["CheckpointError", "Checkpointer", "EngineCheckpointer"]
