"""Training loop with monitoring, eval, and checkpoint/resume.

Counterpart of ``plantcaduceus_tpu.train.loop`` on one device: steps-based
loop, periodic eval + perplexity, periodic checkpoints with autoresume, and
a SpeedMonitor-style throughput/step-time tracker with optional wandb
logging. Each logged line carries ``elapsed_s``, the seconds since the loop
started, read after the step's metrics reached the host.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from plantcaduceus_tpu_torch.train.checkpoint import CheckpointManager
from plantcaduceus_tpu_torch.train.step import TrainState

log = logging.getLogger(__name__)


class SpeedMonitor:
    """Rolling window step-time / throughput tracker."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list = []

    def tick(self) -> None:
        self.times.append(time.time())
        if len(self.times) > self.window + 1:
            self.times.pop(0)

    def stats(self, tokens_per_step: int) -> dict:
        if len(self.times) < 2:
            return {}
        dt = (self.times[-1] - self.times[0]) / (len(self.times) - 1)
        return {"step_time_s": dt, "tokens_per_sec": tokens_per_step / dt}


def run_training(
    state: TrainState,
    train_step: Callable,
    eval_step: Callable,
    train_iter: Iterator[dict],
    eval_batches: Optional[Callable[[], Iterable[dict]]],
    max_steps: int,
    log_every: int = 50,
    eval_every: int = 1000,
    eval_max_batches: int = 20,
    ckpt: Optional[CheckpointManager] = None,
    wandb_run=None,
    tokens_per_step: int = 0,
) -> TrainState:
    """Run to max_steps (resuming from state.step). Returns the final state."""
    start_step = int(state.step)
    monitor = SpeedMonitor()
    t0 = time.perf_counter()

    for step in range(start_step, max_steps):
        batch = next(train_iter)
        if step == start_step:
            # The first step builds the kernels and allocates the activations;
            # running out of device memory there means the configuration does
            # not fit: name the levers.
            try:
                state, metrics_dev = train_step(state, batch)
            except torch.cuda.OutOfMemoryError as e:
                raise RuntimeError(
                    "first training step ran out of device memory — the "
                    "configuration does not fit the card. Levers: lower "
                    "--batch-size and scale with --grad-accum (same effective "
                    f"batch, less memory); keep remat on. Original error: {e}") from e
        else:
            state, metrics_dev = train_step(state, batch)
        monitor.tick()

        if (step + 1) % log_every == 0:
            m = {k: float(v) for k, v in metrics_dev.items()}
            m.update(monitor.stats(tokens_per_step))
            m["elapsed_s"] = time.perf_counter() - t0
            log.info("step %d/%d loss=%.4f acc=%.4f %s", step + 1, max_steps,
                     m["loss"], m["accuracy"],
                     " ".join(f"{k}={v:.6g}" for k, v in m.items()
                              if k not in ("loss", "accuracy")))
            if wandb_run is not None:
                wandb_run.log({"train/" + k: v for k, v in m.items()}, step=step + 1)

        if eval_every and eval_batches is not None and (step + 1) % eval_every == 0:
            ev = evaluate(state, eval_step, eval_batches(), eval_max_batches)
            log.info("eval @ %d: loss=%.4f ppl=%.2f acc=%.4f", step + 1,
                     ev["loss"], ev["perplexity"], ev["accuracy"])
            if wandb_run is not None:
                wandb_run.log({"eval/" + k: v for k, v in ev.items()}, step=step + 1)

        if ckpt is not None:
            ckpt.save(step + 1, state)

    if ckpt is not None:
        if ckpt.latest_step() != max_steps:
            ckpt.save(max_steps, state, force=True)
        ckpt.wait()
    return state


def evaluate(state: TrainState, eval_step: Callable, batches: Iterable[dict],
             max_batches: Optional[int] = None) -> dict:
    losses, accs = [], []
    for i, batch in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        m = eval_step(state, batch)
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
    loss = float(np.mean(losses)) if losses else float("nan")
    try:
        ppl = math.exp(loss)
    except OverflowError:
        ppl = float("inf")
    return {"loss": loss, "perplexity": ppl,
            "accuracy": float(np.mean(accs)) if accs else float("nan")}
