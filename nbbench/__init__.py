"""Benchmark of the NB-tree key/value store of ``repro_torch`` on an H100.

``run.py`` runs one cell of ``BENCHMARK.json``; ``harness`` drives it;
``traffic`` makes its ops from the seed; ``reference`` is the plain
last-writer-wins map its answers are held to; ``kernel_work`` and
``devtrace`` turn launches and the profiler's trace into roofline shares
and idle time; ``metrics/`` holds one reader a metric; ``control.py`` runs
the reference, with a guarantee broken, in the program's place.
"""
