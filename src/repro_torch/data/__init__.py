"""The training data pipeline (numpy over the host NB-tree)."""
