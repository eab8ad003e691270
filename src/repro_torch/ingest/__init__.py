"""Open-loop ingestion frontend of the port (DESIGN.md §7).

The serving layer between workload generation and the storage engines:
seeded arrival processes (:mod:`.arrivals`), a bounded-queue group-commit
frontend with admission control on a deterministic simulated clock
(:mod:`.frontend`), and per-kind SLO accounting with stall attribution
(:mod:`.slo`): copies of the JAX package's ``ingest`` modules, over the
port's engines.
"""
from .arrivals import (ARRIVALS, ArrivalProcess, ArrivalTrace,
                       DiurnalArrivals, MMPPArrivals, PoissonArrivals,
                       make_arrivals, make_trace, multiplex)
from .frontend import (DurabilityConfig, FrontendConfig, IngestFrontend,
                       run_open_loop)
from .slo import STALL_FACTOR, SLOTracker

__all__ = [
    "ARRIVALS", "ArrivalProcess", "ArrivalTrace", "DiurnalArrivals",
    "MMPPArrivals", "PoissonArrivals", "make_arrivals", "make_trace",
    "multiplex",
    "DurabilityConfig", "FrontendConfig", "IngestFrontend", "run_open_loop",
    "STALL_FACTOR", "SLOTracker",
]
