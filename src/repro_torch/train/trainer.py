"""Training loop: data pipeline -> train step -> checkpoint/restart/FT hooks.

The port of ``repro/train/trainer.py``.  ``Trainer`` draws a model from
``seed`` on its device (``cuda`` unless the caller passes ``device``),
turns its gradients on, and runs ``train/train_step.py``'s step over
batches of numpy arrays, which it moves to the device.  Each step's
history entry is ``{"step", "loss", "sec", "grad_norm"}``; ``sec`` is
the host clock around the step, which ends when its loss reaches the
host (that read waits for the whole step on the device).

With ``ckpt_dir`` it saves ``{"params", "opt": {"m", "v", "count"}}``
through ``checkpoint/checkpointer.py`` (bf16 leaves as fp32, lossless)
and, at construction, restores the latest step there and resumes from
it.  The residual of ``grad_compression`` is not saved, as in the
reference.  With a mesh, every rank draws the same weights from
``seed`` on its own device, which the caller picks
(``torch.cuda.set_device``), and keeps its pieces of them: parameters,
``m``, ``v`` and the residual are DTensors placed by
``distributed/sharding.py::param_specs`` (the train step's sharded
layout).  A checkpoint of sharded state gathers each DTensor to full, leaf
by leaf; rank 0 writes it while the other ranks wait at a barrier, and a
restore gives every rank its own pieces back.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from ..checkpoint.checkpointer import Checkpointer
from ..device import resolve_device
from ..distributed import sharding
from ..distributed.fault_tolerance import HeartbeatMonitor, StragglerDetector
from ..models.transformer import init_params
from ..optim import adamw, compression
from .train_step import make_train_step


class Trainer:
    def __init__(self, cfg, *, device=None, mesh=None, opt_cfg=None,
                 ckpt_dir=None, num_microbatches: int = 1, seed: int = 0,
                 grad_compression: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.opt_cfg = opt_cfg or adamw.AdamWConfig()
        self.rank = dist.get_rank() if mesh is not None else 0
        self.ckpt_dir = ckpt_dir
        self.ckpt = self._open_ckpt() if ckpt_dir else None
        self.step_fn = make_train_step(cfg, self.opt_cfg,
                                       num_microbatches=num_microbatches,
                                       grad_compression=grad_compression,
                                       mesh=mesh)
        self.model = init_params(cfg, seed=seed, device=self.device)
        if mesh is not None:
            sharding.shard_model(self.model, mesh)
        self.model.requires_grad_(True)
        self.params = dict(self.model.named_parameters())
        self.opt_state = adamw.init(self.params)
        if grad_compression:
            self.opt_state["error"] = compression.init_error(self.params)
        self.step = 0
        self.host = self.rank
        self.monitor = HeartbeatMonitor([self.host])
        self.straggler = StragglerDetector([self.host])

        if self.ckpt is not None:
            last = self.ckpt.latest_step()
            if last is not None:
                self.restore(last)

    # ------------------------------------------------------------------ loop
    def run(self, batches, num_steps: int, *, ckpt_every: int = 0,
            log_every: int = 10) -> list[dict]:
        history = []
        it = iter(batches)
        for _ in range(num_steps):
            batch = {k: torch.as_tensor(v).to(self.device)
                     for k, v in next(it).items()}
            t0 = time.perf_counter()
            metrics = self.step_fn(self.model, self.opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.step += 1
            self.straggler.record(self.host, dt)
            self.monitor.beat(self.host, self.step)
            history.append({"step": self.step, "loss": loss, "sec": dt,
                            "grad_norm": float(metrics["grad_norm"])})
            if log_every and self.step % log_every == 0:
                print(f"step {self.step}: loss={loss:.4f} "
                      f"({dt:.2f}s/step)", flush=True)
            if ckpt_every and self.ckpt and self.step % ckpt_every == 0:
                self.save()
        return history

    # ------------------------------------------------------------ checkpoint
    def _state(self) -> dict:
        return {"params": self.params,
                "opt": {k: self.opt_state[k] for k in ("m", "v", "count")}}

    def _open_ckpt(self) -> Checkpointer:
        """The checkpointer; with a mesh, rank 0 opens it (and clears a
        crashed save's leftovers) before the others read its manifest."""
        if self.mesh is None:
            return Checkpointer(self.ckpt_dir)
        ckpt = Checkpointer(self.ckpt_dir) if self.rank == 0 else None
        dist.barrier()
        return ckpt or Checkpointer(self.ckpt_dir)

    def save(self, blocking: bool = True) -> None:
        if self.ckpt is None:
            raise ValueError("this Trainer has no ckpt_dir")
        if self.mesh is None:
            self.ckpt.save(self.step, self._state(), blocking=blocking)
            return
        full = sharding.full_state(self._state(), keep=self.rank == 0)
        if self.rank == 0:
            self.ckpt.save(self.step, full, blocking=True)
        del full
        dist.barrier()

    def restore(self, step: int) -> None:
        if self.mesh is not None and self.rank != 0:
            self.ckpt = Checkpointer(self.ckpt_dir)   # rank 0's manifest
        state = self.ckpt.restore(step, self._state())
        with torch.no_grad():
            for name, p in self.params.items():
                p.copy_(state["params"][name])
        self.opt_state.update(state["opt"])
        self.step = step
        print(f"restored checkpoint @ step {step}", flush=True)
