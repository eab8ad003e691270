"""Paged-KV serving over the NB-tree page index."""
