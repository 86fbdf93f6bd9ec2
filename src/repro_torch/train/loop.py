"""Trainer (the torch counterpart of ``repro/train/loop.py``): the
orchestration loop — data prefetch, the train step, periodic checkpoint,
heartbeat, straggler watchdog, crash-resume.

The step runs eagerly on the model's device and updates the state in
place (the reference jits it with its state donated); its time is the
``train.step`` span, fenced on the loss.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, PrefetchingLoader
from repro_torch.models import Model
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import span
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import Heartbeat, StragglerWatchdog, retry

from .step import TrainState, make_train_step

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    microbatches: int = 1
    log_every: int = 10
    seed: int = 0


class Trainer:
    def __init__(self, model: Model, opt_cfg: AdamWConfig, data_cfg: DataConfig,
                 tcfg: TrainerConfig, step_transform: Optional[Callable] = None):
        self.model = model
        self.tcfg = tcfg
        self.data_cfg = data_cfg
        init_fn, step_fn = make_train_step(model, opt_cfg, tcfg.microbatches)
        self._init_fn = init_fn
        self._step_fn = step_transform(step_fn) if step_transform else step_fn
        self.ckpt = CheckpointManager(tcfg.ckpt_dir) if tcfg.ckpt_dir else None
        self.watchdog = StragglerWatchdog()
        self.heartbeat = (Heartbeat(tcfg.ckpt_dir + "/heartbeat.json")
                          if tcfg.ckpt_dir else None)

    def init_or_restore(self) -> tuple[int, TrainState]:
        gen = torch.Generator(device=self.model.device)
        gen.manual_seed(self.tcfg.seed)
        state = self._init_fn(gen)
        if self.ckpt and self.ckpt.latest_step() is not None:
            step, state = retry(lambda: self.ckpt.restore(state))
            log.info("restored checkpoint at step %d", step)
            return step, state
        return 0, state

    def run(self, metrics_sink: Optional[list] = None) -> TrainState:
        start, state = self.init_or_restore()
        loader = PrefetchingLoader(self.data_cfg, self.model.cfg, start_step=start)
        try:
            for step, batch in loader:
                if step >= self.tcfg.steps:
                    break
                with span("train.step", step=step) as sp:
                    state, metrics = self._step_fn(state, batch)
                    sp.fence(metrics["loss"])  # async launches: time to result
                dt = sp.elapsed
                self.watchdog.observe(step, dt)
                if obs_metrics.metrics_enabled():
                    obs_metrics.observe("train.step_seconds", dt)
                    obs_metrics.gauge("train.loss", float(metrics["loss"]))
                if self.heartbeat:
                    self.heartbeat.beat(step)
                if metrics_sink is not None:
                    metrics_sink.append({k: float(v) for k, v in metrics.items()}
                                        | {"step": step, "dt": dt})
                if step % self.tcfg.log_every == 0:
                    log.info("step %d loss %.4f (%.3fs)", step, float(metrics["loss"]), dt)
                if self.ckpt and (step + 1) % self.tcfg.ckpt_every == 0:
                    retry(lambda: self.ckpt.save(step + 1, state))
            if self.ckpt:
                self.ckpt.save(self.tcfg.steps, state, blocking=True)
            return state
        finally:
            loader.close()
