"""The control: the plain reference in the program's place, with one of the
configuration's guarantees broken, run through the whole harness.

The configurations state exact reads of 32-bit values.  The control keeps
the same last-writer-wins map but stores each value in 16 bits, the next
narrower integer: the step that would tempt a later change to halve the
value table.  Its runs must come out not correct, in every cell, which
shows that the check can fail.  The benchmark's own runs never run it.

    python3 nbbench/control.py --workload <cell> --seeds 1 2 3 --seconds 5

runs the cell once a seed, at the cell's own sizes, and prints each run's
compared numbers, one JSON line a seed.
"""
import sys
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WRITE, READ, SCAN = 0, 2, 3


class NarrowValueStore:
    """A sorted key/value map that answers as the engine does, with values
    kept as int16 (the broken guarantee)."""

    name = "control-int16-values"

    def __init__(self):
        self.keys = np.zeros(0, np.uint64)
        self.vals = np.zeros(0, np.int16)

    def _write(self, keys, vals) -> None:
        uk, first = np.unique(keys[::-1], return_index=True)  # last one wins
        uv = vals[::-1][first].astype(np.int16)
        pos = np.searchsorted(self.keys, uk)
        hit = pos < len(self.keys)
        hit[hit] = self.keys[pos[hit]] == uk[hit]
        self.vals[pos[hit]] = uv[hit]
        self.keys = np.insert(self.keys, pos[~hit], uk[~hit])
        self.vals = np.insert(self.vals, pos[~hit], uv[~hit])

    def apply(self, batch):
        kinds = np.asarray(batch.kinds)
        keys = np.asarray(batch.keys, np.uint64)
        n = len(kinds)
        found = np.zeros(n, bool)
        values = np.full(n, -1, np.int64)
        hits: list = [None] * n
        w = kinds == WRITE
        if w.any():
            self._write(keys[w], np.asarray(batch.vals)[w])
        r = np.flatnonzero(kinds == READ)
        if len(r) and len(self.keys):
            pos = np.searchsorted(self.keys, keys[r])
            pos = pos.clip(max=len(self.keys) - 1)
            found[r] = self.keys[pos] == keys[r]
            values[r] = np.where(found[r], self.vals[pos].astype(np.int64), -1)
        for i in np.flatnonzero(kinds == SCAN):
            a = np.searchsorted(self.keys, keys[i], "left")
            b = np.searchsorted(self.keys, np.uint64(batch.his[i]), "right")
            hits[i] = (self.keys[a:b], self.vals[a:b].astype(np.int64))
        return types.SimpleNamespace(found=found, values=values,
                                     range_hits=hits,
                                     range_truncated=np.zeros(n, bool))

    def maintain(self, budget: int = 1) -> int:
        return 0

    def drain(self) -> None:
        pass

    def dump_live(self) -> tuple:
        return self.keys.copy(), self.vals.astype(np.int64)


def main(argv=None) -> int:
    import argparse
    import json

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from nbbench.harness import Run

    p = argparse.ArgumentParser(description="the control, seed by seed")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for seed in args.seeds:
        out = Run(args.workload, seed, args.seconds, False, root=ROOT,
                  device=args.device,
                  engine_factory=lambda cfg, dev: NarrowValueStore()).run()
        print(json.dumps({"control": NarrowValueStore.name,
                          "workload": args.workload, "seed": seed,
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
