"""Observability for the port: the bounded log-bucket latency histogram."""
from .metrics import BUCKET_EDGES_S, LogBucketHistogram

__all__ = ["BUCKET_EDGES_S", "LogBucketHistogram"]
