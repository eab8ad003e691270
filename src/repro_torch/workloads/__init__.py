"""Deterministic mixed workloads for the port: the generator (named mixes,
uniform/zipfian/hotspot keys) and the closed-loop driver.

``driver`` is not re-exported here, so ``python -m
repro_torch.workloads.driver`` runs without runpy's double-import warning.
"""
from .generator import MIXES, Workload, WorkloadSpec, make_workload

__all__ = ["MIXES", "Workload", "WorkloadSpec", "make_workload"]
