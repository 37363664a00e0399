"""Checkpoint save/resume with ``torch.save`` / ``torch.load``.

Counterpart of ``plantcaduceus_tpu.train.checkpoint`` with the same API
(``CheckpointManager.save/latest_step/restore/wait``, ``save_config``,
``export_params``). Orbax's role goes to one file per step,
``<dir>/<step>/state.pt``, holding the model's state dict, the optimizer
state and the step, read back with ``torch.load(weights_only=True)``. The
final export is an HF checkpoint directory (``compat.hf_export``) that the
port's and the JAX package's loaders read.

Over several ranks every rank calls :meth:`CheckpointManager.save` and
rank 0 alone writes. Under fsdp, tensor or pipe the file is still the
one-process format: the full weights and moments are gathered from the
ranks' blocks, slices and stages (a collective, hence every rank), and on
resume each rank takes its part. A run saved under ``--fsdp N`` (or
``--tensor``, ``--pipe``) therefore resumes under the same layout exactly,
and in one process or under another layout too.
"""

from __future__ import annotations

import logging
import os
import shutil
from pathlib import Path
from typing import Optional

import torch

from plantcaduceus_tpu_torch.compat.hf_export import export_hf_dir
from plantcaduceus_tpu_torch.compat.params import to_jax_params
from plantcaduceus_tpu_torch.models.caduceus import Caduceus
from plantcaduceus_tpu_torch.models.config import CaduceusConfig
from plantcaduceus_tpu_torch.parallel.mesh import world
from plantcaduceus_tpu_torch.train.step import TrainState

log = logging.getLogger(__name__)

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory, save_interval_steps: int = 1000, max_to_keep: int = 20):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self._interval = save_interval_steps
        self._max_to_keep = max_to_keep

    def _steps(self):
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / STATE_FILE).is_file())

    def save(self, step: int, state: TrainState, force: bool = False) -> bool:
        """Save at multiples of ``save_interval_steps`` (any step with
        ``force``); keeps the newest ``max_to_keep``. Written by rank 0 to a
        temporary file and renamed, so a crash never leaves half a
        checkpoint. Returns whether the step was due, on every rank."""
        if not force and (not self._interval or step % self._interval != 0):
            return False
        model, opt_state = state.model.state_dict(), state.opt_state
        if state.layout is not None:   # every rank: the parts are gathered
            weights, opt_state = state.layout.full_state(opt_state)
            model = {k: weights.get(k, v) for k, v in model.items()}
        if world()[0] != 0:
            return True
        d = self.directory / str(step)
        d.mkdir(parents=True, exist_ok=True)
        tmp = d / (STATE_FILE + ".tmp")
        torch.save({"step": int(state.step), "model": model, "opt_state": opt_state}, tmp)
        os.replace(tmp, d / STATE_FILE)
        for old in (self._steps()[:-self._max_to_keep] if self._max_to_keep else ()):
            shutil.rmtree(self.directory / str(old), ignore_errors=True)
        return True

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, state_template: TrainState, step: Optional[int] = None) -> TrainState:
        """Load a checkpoint into the template's model (in place, on its
        device; under a layout into this rank's part) and return the state."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        device = next(state_template.model.parameters()).device
        saved = torch.load(self.directory / str(step) / STATE_FILE, map_location=device,
                           weights_only=True)
        layout, opt_state = state_template.layout, saved["opt_state"]
        if layout is not None:
            opt_state = layout.load_state(saved["model"], opt_state)
        else:
            state_template.model.load_state_dict(saved["model"])
        log.info("Restored checkpoint at step %d from %s", step, self.directory)
        return TrainState(state_template.model, opt_state, int(saved["step"]),
                          state_template.fsdp, state_template.shards)

    def wait(self):
        """Saves are synchronous; nothing to wait for."""


def save_config(directory, cfg: CaduceusConfig) -> None:
    Path(directory).mkdir(parents=True, exist_ok=True)
    cfg.save(Path(directory) / "config.json")


def export_params(directory, model: Caduceus, cfg: CaduceusConfig) -> None:
    """Standalone weight export for the inference CLIs: an HF checkpoint
    directory (config.json + pytorch_model.bin)."""
    export_hf_dir(Path(directory).absolute(), to_jax_params(model), cfg)


def export_final(directory, state: TrainState, cfg: CaduceusConfig) -> bool:
    """:func:`export_params` of the state's weights, written by rank 0;
    under a layout every rank calls it (the weights are gathered first;
    under tensor or pipe the model keeps its full weights after). Returns
    whether this rank wrote."""
    if state.shards is not None:
        state.shards.full_model()
    elif state.fsdp is not None:
        state.fsdp.gather()
    if world()[0] != 0:
        return False
    export_params(directory, state.model, cfg)
    return True
