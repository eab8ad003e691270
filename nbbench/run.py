"""Run one cell of the NB-tree benchmark once and print its result line.

    python3 nbbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cells' cards.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``: each number compared with the reference, beside its limit.  The
same numbers close standard error.  Without a card, without the program
(``src/repro_torch``), or with JAX or the JAX package loaded, it prints no
result and exits with a code other than 0.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def card_limits() -> str:
    """The card's name, power limit and SM clock, as nvidia-smi reads them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from nbbench.harness import Run, forbidden_loaded
    from nbbench.spec import Cell

    chips = Cell(args.workload, ROOT).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no result: the cell needs {chips} CUDA device(s); "
            f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
            f"device_count() = {torch.cuda.device_count()}")
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        log(f"no result: the program (src/repro_torch) is not in {ROOT}")
        return 2
    run = Run(args.workload, args.seed, args.seconds, bool(args.trace),
              root=ROOT, device="cuda", t_start=T_START, log=log)
    out = run.run()
    log("card: " + card_limits())
    found = forbidden_loaded()
    if found:
        log(f"no result: forbidden modules loaded: {found}")
        return 3
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
