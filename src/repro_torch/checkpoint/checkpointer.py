"""Async, restartable checkpointing with an NB-tree manifest (the port's
copy of ``repro/checkpoint/checkpointer.py``).

Layout (one directory per run):
  step_<N>/<flat.param.path>.npy       one file per leaf
  manifest.npz + manifest.json          NB-tree-indexed leaf manifest

The manifest is a *paper-native* application: checkpoint writes are
insertion-intensive (every step inserts (step, leaf) -> file records,
incremental checkpoints insert only changed leaves) and restores are point
queries/range scans — so the manifest is a host-tier NB-tree
(core/refimpl.NBTree, zero-I/O-cost instance) serialized alongside the data.

A tree is a nested ``dict``/``list``/``tuple`` of tensors or numpy arrays,
or an ``nn.Module`` (its ``state_dict``).  Leaves are named by their dotted
path with dict keys in sorted order, as the JAX package names a pytree's,
so for a nested dict of arrays either package restores the other's
checkpoint.  bf16 leaves are saved as float32 (lossless) and cast back on
restore; ``restore`` puts each leaf on the device of its ``like`` leaf.

Sharded state (``distributed/sharding.py``): the caller gathers each
DTensor to its full tensor (``sharding.full_state``) and one rank saves.
``restore`` gives a leaf whose ``like`` is a DTensor back as a DTensor
placed like it, and ``restore(..., placements=)`` places leaves on
another mesh (``distributed/fault_tolerance.py::elastic_resize``): every
rank reads the full arrays and keeps its own pieces.

Async: ``save(..., blocking=False)`` snapshots to host *and mutates the
manifest* synchronously, then writes files on a daemon thread; ``wait()``
joins, and every reader (``restore``/``latest_step``) waits first, so the
background writer never races a reader.

Atomicity protocol (crash-safe at every point; the crash matrix in
``tests/test_torch_durability.py`` kills inside it):

1. leaves land in ``.tmp_step_<N>/``, each file fsynced, then the dir;
2. the manifest (which proves exactly which leaves step N owns) is written
   to temp names, fsynced, and atomically renamed into place;
3. the step dir is renamed ``.tmp_step_<N>`` -> ``step_<N>`` *after* the
   manifest fsync, and the parent dir is fsynced.

A crash between 2 and 3 leaves a ``.tmp_step_<N>`` the manifest fully
proves: ``__init__`` *rolls it forward* (finishes the rename).  A crash
before 2 leaves an unprovable temp dir: ``__init__`` deletes it.  Either
way ``latest_step()`` — which answers from the manifest, not a directory
listing — only ever names steps that can actually be restored.

``EngineCheckpointer`` keys snapshots by *commit LSN* instead of train
step: the durability layer (``wal``, DESIGN.md §9) checkpoints a
storage engine's live table through it and truncates the WAL past the
snapshot LSN.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time as _time
import zlib

import numpy as np
import torch

from ..core.cost_model import CostModel, Device
from ..core.refimpl import NBTree
from ..wal.faults import CrashPoint, FaultInjector, reach as _reach

_NULL_DEVICE = Device("null", page_bytes=4096, seek_s=0.0, read_bw=1e18, write_bw=1e18)

#: leaf index occupies the low bits of a manifest key; step the high bits.
_LEAF_BITS = 20


class CheckpointError(RuntimeError):
    """A restore/validation failure (never a bare ``assert`` — those vanish
    under ``python -O`` and turn a corrupt restore into silent bad state)."""


def _flatten(tree) -> dict:
    """``{dotted path: leaf}``: dict keys sorted, sequences by index."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    out = {}

    def rec(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(node[k], (*path, str(k)))
        elif isinstance(node, (list, tuple)):
            for i, c in enumerate(node):
                rec(c, (*path, str(i)))
        else:
            out[".".join(path)] = node

    rec(tree, ())
    return out


def _unflatten(like, host: dict, placements=None, device=None):
    """``like``'s structure with each leaf taken from ``host`` by path,
    cast to the leaf's dtype and put on its device (an ``nn.Module`` gives
    its ``state_dict`` layout); a DTensor ``like`` leaf, or one named in
    ``placements`` (``{path: (mesh, placements)}``), comes back as a
    DTensor on that mesh; a ``like`` leaf on ``meta`` goes to ``device``."""
    from torch.distributed.tensor import DTensor

    from ..distributed.sharding import shard_tensor

    if isinstance(like, torch.nn.Module):
        like = like.state_dict()
    placements = placements or {}

    def rec(node, path):
        if isinstance(node, dict):
            return type(node)((k, rec(v, (*path, str(k))))
                              for k, v in node.items())
        if isinstance(node, (list, tuple)):
            return type(node)(rec(c, (*path, str(i)))
                              for i, c in enumerate(node))
        name = ".".join(path)
        arr = host[name]
        if isinstance(node, torch.Tensor):
            place = placements.get(name)
            if place is None and isinstance(node, DTensor):
                place = (node.device_mesh, node.placements)
            if place is not None:
                mesh, places = place
                full = torch.from_numpy(arr).to(
                    device=torch.device(mesh.device_type), dtype=node.dtype)
                return shard_tensor(full, mesh, places)
            dev = device if node.device.type == "meta" else node.device
            return torch.from_numpy(arr).to(device=dev, dtype=node.dtype)
        return arr.astype(np.asarray(node).dtype, copy=False)

    return rec(like, ())


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host numpy array; bf16 (no numpy dtype) as float32."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _key_of(step: int, leaf_idx: int) -> int:
    return (step << _LEAF_BITS) | leaf_idx


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    _fsync_file(path)       # on POSIX a directory fd fsyncs its entries


class Checkpointer:
    def __init__(self, directory: str, *,
                 injector: FaultInjector | None = None, tracer=None):
        self.dir = directory
        self.injector = injector
        # optional obs tracer: wall-clock "checkpoint" spans around
        # each synchronous save (async saves span the snapshot phase only);
        # the sim-clock frontend charges its own spans and passes None.
        self.tracer = tracer
        self._t_origin = _time.perf_counter()
        os.makedirs(directory, exist_ok=True)
        # zero-cost NB-tree (manifest ops are host metadata, not disk sim).
        self.manifest = NBTree(f=4, sigma=1024, cost=CostModel(_NULL_DEVICE),
                               use_bloom=False)
        self.leaf_names: list[str] = []
        self._leaf_idx: dict[str, int] = {}     # O(1) path -> index
        self.known_steps: set[int] = set()      # steps the manifest proves
        #: per-step payload checksums: {step: {leaf_path: crc32}} — WAL
        #: records always had CRCs; these give checkpoint payload files the
        #: same bit-rot detection (verified on restore, audited by scrub()).
        self._crcs: dict[int, dict[str, int]] = {}
        self._thread: threading.Thread | None = None
        self._load_manifest()
        self._cleanup_tmp()

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree, *, blocking: bool = True) -> None:
        t_span0 = _time.perf_counter()
        self.wait()
        flat = _flatten(tree)
        host = {p: _to_host(l) for p, l in flat.items()}  # device->host snap

        # manifest mutation happens HERE, in the synchronous snapshot phase:
        # the daemon thread only writes files, so restore()/latest_step()
        # never observe a half-mutated manifest (they also wait() first).
        for path in host:
            if path not in self._leaf_idx:
                self._leaf_idx[path] = len(self.leaf_names)
                self.leaf_names.append(path)
            self.manifest.insert(_key_of(step, self._leaf_idx[path]), step)
        self.known_steps.add(step)
        mkeys, mvals = self._manifest_arrays()
        names = list(self.leaf_names)

        def write():
            self._write(step, host, mkeys, mvals, names)

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        if self.tracer is not None:
            self.tracer.complete("checkpoint", "save",
                                 t_span0 - self._t_origin,
                                 _time.perf_counter() - t_span0,
                                 step=int(step), leaves=len(host),
                                 blocking=bool(blocking))

    def _write(self, step: int, host: dict, mkeys, mvals, names) -> None:
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        crcs = {}
        for path, arr in host.items():
            fp = os.path.join(tmp, path + ".npy")
            np.save(fp, arr)
            _fsync_file(fp)
            with open(fp, "rb") as f:
                crcs[path] = zlib.crc32(f.read())
        _fsync_dir(tmp)
        _reach(self.injector, CrashPoint.MID_CHECKPOINT)
        self._crcs[step] = crcs
        self._write_manifest_files(step, mkeys, mvals, names)
        _reach(self.injector, CrashPoint.BEFORE_CHECKPOINT_RENAME)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)               # rename AFTER the manifest fsync
        _fsync_dir(self.dir)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -------------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        """Newest step the manifest proves *and* whose data dir exists."""
        self.wait()
        steps = [s for s in self.known_steps
                 if os.path.isdir(os.path.join(self.dir, f"step_{s}"))]
        if not steps:
            # manifest-less legacy layout: fall back to a directory listing.
            steps = [int(d.split("_")[1]) for d in os.listdir(self.dir)
                     if d.startswith("step_") and d.split("_")[1].isdigit()]
        return max(steps) if steps else None

    def restore(self, step: int, like, placements=None, device=None):
        """Rebuild the tree of ``like`` (shapes, dtypes, devices) from the
        step's files.  ``placements`` (``{leaf path: (mesh, placements)}``)
        and DTensor ``like`` leaves place leaves on a mesh, and ``device``
        takes the leaves whose ``like`` is on ``meta`` (``_unflatten``).

        Raises :class:`CheckpointError` on any validation failure (missing
        manifest record, missing file, shape mismatch) — real exceptions,
        not ``assert``, so ``python -O`` cannot silence a corrupt restore.
        """
        self.wait()
        d = os.path.join(self.dir, f"step_{step}")
        flat = _flatten(like)
        host = {}
        for path, leaf in flat.items():
            # manifest point query proves the leaf belongs to this step.
            idx = self._leaf_idx.get(path)
            if idx is None or self.manifest.get(_key_of(step, idx)) is None:
                raise CheckpointError(
                    f"manifest missing {path!r} @ step {step}")
            fp = os.path.join(d, path + ".npy")
            if not os.path.exists(fp):
                raise CheckpointError(f"leaf file missing: {fp}")
            self._verify_leaf(step, path, fp)
            arr = np.load(fp)
            if arr.shape != tuple(leaf.shape):
                raise CheckpointError(
                    f"shape mismatch for {path!r} @ step {step}: "
                    f"saved {arr.shape}, expected {tuple(leaf.shape)}")
            host[path] = arr

        return _unflatten(like, host, placements, device)

    # ------------------------------------------------------------ integrity
    def _verify_leaf(self, step: int, path: str, fp: str) -> None:
        """Check ``fp`` against the manifest's recorded CRC32.

        Raises :class:`CheckpointError` naming the offending file on a
        mismatch.  Steps saved before checksums existed have no recorded
        CRC and pass unverified.
        """
        recorded = self._crcs.get(step, {}).get(path)
        if recorded is None:
            return
        with open(fp, "rb") as f:
            actual = zlib.crc32(f.read())
        if actual != recorded:
            raise CheckpointError(
                f"checksum mismatch in {fp} @ step {step}: "
                f"recorded {recorded:#010x}, found {actual:#010x}")

    def scrub(self) -> dict:
        """Verify every payload file of every provable step.

        Returns a JSON-ready audit: per step, the files checked and the
        list of corrupt/missing ones (empty = clean).  Never raises — a
        scrub is an audit, not a restore; callers decide what to do with
        a dirty step (typically: rely on restore's fallback to the
        previous provable step).
        """
        self.wait()
        out = {"steps": {}, "clean": True}
        for step in sorted(self.known_steps):
            d = os.path.join(self.dir, f"step_{step}")
            if not os.path.isdir(d):
                continue
            bad, checked = [], 0
            for path in self._step_leaves(step):
                fp = os.path.join(d, path + ".npy")
                checked += 1
                try:
                    if not os.path.exists(fp):
                        raise CheckpointError(f"leaf file missing: {fp}")
                    self._verify_leaf(step, path, fp)
                except CheckpointError as e:
                    bad.append(str(e))
            out["steps"][str(step)] = {"files": checked, "bad": bad}
            if bad:
                out["clean"] = False
        return out

    # ------------------------------------------------------------- manifest
    def _manifest_arrays(self):
        keys, vals = [], []
        stack = [self.manifest.root]
        while stack:
            n = stack.pop()
            keys.extend(int(k) for k in n.run.live_keys)
            vals.extend(int(v) for v in n.run.live_vals)
            stack.extend(n.children)
        keys.extend(int(k) for k in self.manifest._buf.keys())
        vals.extend(int(v) for v in self.manifest._buf.values())
        return (np.asarray(keys, np.uint64), np.asarray(vals, np.int64))

    def _write_manifest_files(self, step, mkeys, mvals, names) -> None:
        """Atomically replace manifest.npz/.json, fsyncing each."""
        npz, jsn = (os.path.join(self.dir, "manifest.npz"),
                    os.path.join(self.dir, "manifest.json"))
        np.savez(npz + ".tmp.npz", keys=mkeys, vals=mvals)
        # np.savez appends .npz when missing — our temp name keeps it.
        _fsync_file(npz + ".tmp.npz")
        os.replace(npz + ".tmp.npz", npz)
        with open(jsn + ".tmp", "w") as f:
            json.dump({"leaf_names": names, "last_step": step,
                       "crc": {str(s): m
                               for s, m in sorted(self._crcs.items())}}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(jsn + ".tmp", jsn)
        _fsync_dir(self.dir)

    def _load_manifest(self) -> None:
        j = os.path.join(self.dir, "manifest.json")
        z = os.path.join(self.dir, "manifest.npz")
        if not (os.path.exists(j) and os.path.exists(z)):
            return
        with open(j) as f:
            meta = json.load(f)
        self.leaf_names = list(meta["leaf_names"])
        self._leaf_idx = {p: i for i, p in enumerate(self.leaf_names)}
        # pre-CRC manifests simply have no "crc" block: their files load
        # unverified (legacy), new saves start recording checksums.
        self._crcs = {int(s): {p: int(c) for p, c in m.items()}
                      for s, m in meta.get("crc", {}).items()}
        data = np.load(z)
        for k, v in zip(data["keys"], data["vals"]):
            self.manifest.insert(k, v)
            self.known_steps.add(int(k) >> _LEAF_BITS)
        self.manifest.drain()

    # -------------------------------------------------------------- cleanup
    def _step_leaves(self, step: int) -> list[str]:
        """Leaf names the manifest records for ``step`` (range scan)."""
        lo, hi = _key_of(step, 0), _key_of(step + 1, 0) - 1
        rk, _ = self.manifest.range_query(lo, hi)
        return [self.leaf_names[int(k) & ((1 << _LEAF_BITS) - 1)]
                for k in rk]

    def _cleanup_tmp(self) -> None:
        """Resolve stale ``.tmp_step_*`` dirs left by a crash mid-save.

        A temp dir the manifest fully proves (crash after manifest fsync,
        before rename) is rolled *forward*; anything else is deleted.
        """
        for d in os.listdir(self.dir):
            if not d.startswith(".tmp_step_"):
                continue
            tmp = os.path.join(self.dir, d)
            suffix = d[len(".tmp_step_"):]
            step = int(suffix) if suffix.isdigit() else None
            final = (os.path.join(self.dir, f"step_{step}")
                     if step is not None else None)
            provable = (
                step in self.known_steps and not os.path.exists(final)
                and all(os.path.exists(os.path.join(tmp, n + ".npy"))
                        for n in self._step_leaves(step)))
            if provable:
                os.rename(tmp, final)       # roll forward
            else:
                shutil.rmtree(tmp)          # unprovable half-write
        _fsync_dir(self.dir)


class EngineCheckpointer(Checkpointer):
    """Engine-table snapshots keyed by commit LSN (DESIGN.md §9).

    A snapshot is the engine's *logical* live table
    (:meth:`~repro_torch.core.engine_api.StorageEngine.dump_live`) as two
    array leaves under step ``lsn``; recovery bulk-inserts it into a fresh
    engine and replays the WAL tail (``wal.recovery``).  Inherits the full
    atomicity protocol, so a crash mid-checkpoint can never strand a
    snapshot recovery would half-trust.
    """

    def save_snapshot(self, lsn: int, keys, vals, *,
                      blocking: bool = True) -> None:
        keys = np.ascontiguousarray(keys, np.uint64)
        vals = np.ascontiguousarray(vals, np.int64)
        if keys.shape != vals.shape:
            raise CheckpointError("snapshot keys/vals must be parallel")
        self.save(int(lsn), {"keys": keys, "vals": vals}, blocking=blocking)

    def _load_snapshot(self, lsn: int):
        d = os.path.join(self.dir, f"step_{lsn}")
        out = []
        for name in ("keys", "vals"):
            idx = self._leaf_idx.get(name)
            if idx is None or self.manifest.get(_key_of(lsn, idx)) is None:
                raise CheckpointError(
                    f"snapshot manifest missing {name!r} @ lsn {lsn}")
            fp = os.path.join(d, name + ".npy")
            if not os.path.exists(fp):
                raise CheckpointError(f"snapshot leaf missing: {fp}")
            self._verify_leaf(lsn, name, fp)
            out.append(np.load(fp))
        keys, vals = out
        if keys.shape != vals.shape:
            raise CheckpointError(
                f"snapshot @ lsn {lsn} has mismatched leaves: "
                f"{keys.shape} vs {vals.shape}")
        return int(lsn), keys, vals

    def load_latest_snapshot(self):
        """``(lsn, keys, vals)`` of the newest *valid* snapshot, or None.

        A snapshot that fails validation (bit-rot caught by the CRC, a
        missing leaf) is skipped and the previous provable step is tried —
        replaying a longer WAL tail from an older good snapshot beats
        trusting a corrupt newer one.  Raises the newest step's
        :class:`CheckpointError` only when corruption left *no* loadable
        snapshot at all (silently returning None there would amputate the
        pre-corruption history the caller believes is checkpointed).
        """
        self.wait()
        steps = sorted((s for s in self.known_steps
                        if os.path.isdir(os.path.join(self.dir,
                                                      f"step_{s}"))),
                       reverse=True)
        if not steps:
            return None
        first_err: CheckpointError | None = None
        for lsn in steps:
            try:
                return self._load_snapshot(lsn)
            except CheckpointError as e:
                if first_err is None:
                    first_err = e
        raise first_err
