"""Batched inference engine, on one device or over a data × seq mesh.

Counterpart of ``plantcaduceus_tpu.engine.runner``: fixed batch shapes
(ragged tails padded with ``pad_token_id``), forwards under
``torch.inference_mode``, outputs upcast to float32 before extraction, and
a two-batch-deep queue so the card computes the next batches while the host
copies the oldest result back.

Over a mesh (``parallel.mesh``; every rank passes the same ids) each
batch's ``batch_size`` rows are split over the batch axes (``data ×
fsdp``, which must divide it: ``batch_size`` is global, as JAX's), so
rank k runs the k-th block of ``batch_size / n`` rows of each batch. With
``seq`` above 1 each window's length is split over ``seq`` too
(context-parallel scoring of long windows). The raw outputs are gathered
over ``seq`` before extraction and the extracted rows over the batch axes,
so every rank ends with the full result. This row split is the one way the
port spreads inference over ranks: every entry point that runs over a
mesh goes through it. A rank's forwards take the rows, in the same blocks
and padded alike, that one process takes at a ``batch_size`` of
``batch_size / n``, so their results equal that process's bit for bit.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from plantcaduceus_tpu_torch.models.caduceus import Caduceus
from plantcaduceus_tpu_torch.models.config import CaduceusConfig
from plantcaduceus_tpu_torch.ops.cuda_ssd import check_kernel_shapes
from plantcaduceus_tpu_torch.parallel import collectives
from plantcaduceus_tpu_torch.parallel.mesh import Mesh, shard_length, shard_rows
from plantcaduceus_tpu_torch.utils.device import resolve_device


class InferenceRunner:
    """Owns the model on its device; yields numpy results."""

    def __init__(self, model: Caduceus, cfg: CaduceusConfig,
                 dtype=torch.bfloat16, batch_size: int = 128, device="cuda",
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.dtype = dtype
        self.batch_size = batch_size
        self.mesh = mesh
        if mesh is not None:
            n = mesh.shape["data"] * mesh.shape["fsdp"]
            if batch_size % n:
                raise ValueError(f"batch_size {batch_size} must divide over the "
                                 f"{n}-way batch axes")
        self.sp = mesh.axis("seq") if mesh is not None and mesh.shape["seq"] > 1 else None
        self.device = resolve_device(device)
        if self.device.type == "cuda" and cfg.ssm_variant == "mamba2":
            # K5's shapes, checked before the model moves (L at each launch)
            check_kernel_shapes(f"{cfg.d_model}-wide Mamba-2 model", None, cfg.n_heads,
                                cfg.head_dim, cfg.n_groups, cfg.d_state, cfg.chunk_size)
        self.model = model.to(self.device).eval()

    # -- batching ----------------------------------------------------------

    def _pad(self, ids: np.ndarray) -> tuple[np.ndarray, int]:
        n = ids.shape[0]
        if n == self.batch_size:
            return ids, n
        pad = np.full((self.batch_size - n,) + ids.shape[1:], self.cfg.pad_token_id,
                      ids.dtype)
        return np.concatenate([ids, pad], axis=0), n

    def _iter_batches(self, ids: np.ndarray) -> Iterator[tuple[np.ndarray, int]]:
        for i in range(0, ids.shape[0], self.batch_size):
            yield self._pad(ids[i:i + self.batch_size])

    def _forward(self, chunk: np.ndarray, extract, want_hidden: bool) -> torch.Tensor:
        """One padded batch: this rank's block of its rows through the
        model, the raw outputs gathered over ``seq``, extracted, and the
        extracted rows gathered over the batch axes."""
        mesh = self.mesh
        if mesh is not None:
            chunk = chunk[shard_rows(chunk.shape[0], mesh)]
        if self.sp is not None:
            chunk = chunk[:, shard_length(chunk.shape[1], mesh)]
        dev = torch.from_numpy(chunk.astype(np.int64)).to(self.device)
        out = self.model(dev, dtype=self.dtype, output_hidden_states=want_hidden, sp=self.sp)
        res = {"logits": out["logits"].float()}
        if want_hidden:
            res["hidden_states"] = out["hidden_states"].float()
        if self.sp is not None:  # [S, rows, Lloc, ...] -> [rows, L, ...]
            res = {k: torch.cat(list(collectives.all_gather(v, self.sp)), dim=1)
                   for k, v in res.items()}
        got = extract(res)
        if mesh is not None:
            got = collectives.all_gather_tiled(got, mesh.axis("data", "fsdp"))
        return got

    def run(self, ids: np.ndarray,
            extract: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
            want_hidden: bool = False, progress: bool = True) -> np.ndarray:
        """Run the forward over all rows of ``ids`` ([N, L] ints). ``extract``
        reduces each batch's fp32 outputs on the device. Over a mesh every
        rank passes the same ``ids`` and gets the whole result."""
        batches = list(self._iter_batches(ids))
        it = batches
        if progress and (self.mesh is None or self.mesh.rank == 0):
            try:
                from tqdm import tqdm

                it = tqdm(batches, desc="forward", unit="batch")
            except ImportError:
                pass
        results, pending = [], []
        with torch.inference_mode():
            for chunk, n in it:
                pending.append((self._forward(chunk, extract, want_hidden), n))
                if len(pending) > 2:
                    got, m = pending.pop(0)
                    results.append(got[:m].cpu().numpy())
            for got, m in pending:
                results.append(got[:m].cpu().numpy())
        return np.concatenate(results, axis=0)

    # -- workload-specific extractors --------------------------------------

    def masked_probs(self, ids: np.ndarray, nucleotide_ids, position: int,
                     progress: bool = True) -> np.ndarray:
        """Softmax over the 4 nucleotide logits at ``position`` for
        pre-masked inputs: the zero-shot scoring contract. [N, 4] float32."""
        nuc = torch.tensor(list(nucleotide_ids), device=self.device)

        def extract(out):
            return torch.softmax(out["logits"][:, position, :][:, nuc], dim=-1)

        return self.run(ids, extract, progress=progress)

    def multi_masked_probs(self, ids: np.ndarray, nucleotide_ids, positions,
                           progress: bool = True) -> np.ndarray:
        """Probs at several masked positions, flattened row-major:
        [N * len(positions), 4]."""
        nuc = torch.tensor(list(nucleotide_ids), device=self.device)
        pos = torch.tensor(list(positions), device=self.device)

        def extract(out):
            return torch.softmax(out["logits"][:, pos, :][..., nuc], dim=-1)

        probs = self.run(ids, extract, progress=progress)          # [N, P, 4]
        return probs.reshape(-1, probs.shape[-1])

    def positionwise_probs(self, ids: np.ndarray, nucleotide_ids,
                           progress: bool = True) -> np.ndarray:
        """Unmasked per-position probs over A,C,G,T: [N, L, 4]."""
        nuc = torch.tensor(list(nucleotide_ids), device=self.device)

        def extract(out):
            return torch.softmax(out["logits"][..., nuc], dim=-1)

        return self.run(ids, extract, progress=progress)

    def center_embeddings(self, ids: np.ndarray, position: int,
                          rc_average: bool = True, progress: bool = True) -> np.ndarray:
        """Final-layer embedding at ``position``; RC-averaged by splitting the
        channels in half, reversing the second half, and taking the mean."""

        def extract(out):
            emb = out["hidden_states"][:, position, :]
            if not rc_average:
                return emb
            d = emb.shape[-1] // 2
            return (emb[:, :d] + emb[:, d:].flip(-1)) * 0.5

        return self.run(ids, extract, want_hidden=True, progress=progress)
