"""HF-style model card emission + hub publishing analogue.

Counterpart of ``plantcaduceus_tpu.compat.model_card``. The reference's HF
Trainer run ends with ``trainer.push_to_hub(**kwargs)`` or
``trainer.create_model_card(**kwargs)`` (kwargs: finetuned_from / tasks /
dataset tags). This module reproduces that surface for the port's exported
checkpoints, with the JAX package's text except the lines that name the
framework (library, tags, title, the provenance sentence, the usage
command), which name this package:

* ``write_model_card`` — always available offline: writes a README.md with
  the HF YAML metadata block (tags/datasets/metrics) plus a config and
  training-provenance table into the export directory.
* ``push_to_hub`` — uploads the directory via huggingface_hub when the
  wheel and network exist; without them it raises one clear, actionable
  error instead of failing deep inside an HTTP stack.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

from plantcaduceus_tpu_torch.models.config import CaduceusConfig


def write_model_card(
    directory,
    cfg: CaduceusConfig,
    *,
    finetuned_from: Optional[str] = None,
    tasks: str = "fill-mask",
    dataset: Optional[str] = None,
    metrics: Optional[Dict[str, float]] = None,
    extra: Optional[Dict[str, str]] = None,
    n_params: Optional[int] = None,
) -> Path:
    """Write an HF-style README.md model card into ``directory``.

    Mirrors the metadata HF Trainer's create_model_card emits for the
    reference pre-train run: pipeline tag, base model, dataset tags, and
    final metrics — so a checkpoint exported here carries the same
    provenance a reference-trained one would.
    """
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)

    meta_lines = ["---", "library_name: plantcaduceus_tpu_torch",
                  f"pipeline_tag: {tasks}", "tags:", "- plantcaduceus",
                  "- caduceus", "- dna", "- cuda", "- pytorch"]
    if finetuned_from:
        meta_lines.append(f"base_model: {finetuned_from}")
    if dataset:
        meta_lines += ["datasets:", f"- {dataset}"]
    if metrics:
        meta_lines += ["model-index:", "- name: plantcaduceus-tpu-torch",
                       "  results:", "  - task:",
                       f"      type: {tasks}", "    metrics:"]
        for k, v in metrics.items():
            meta_lines += [f"    - type: {k}", f"      value: {v}"]
    meta_lines.append("---")

    rows = [
        ("d_model", cfg.d_model), ("n_layer", cfg.n_layer),
        ("vocab_size", cfg.vocab_size), ("d_state", cfg.d_state),
        ("d_conv", cfg.d_conv), ("expand", cfg.expand),
        ("rcps (RC equivariance)", cfg.rcps),
        ("bidirectional", cfg.bidirectional),
    ]
    if n_params:
        rows.append(("parameters", f"{n_params:,}"))
    body = ["", "# PlantCaduceus (PyTorch/CUDA)", "",
            "Masked-language genomic model trained with the "
            "plantcaduceus_tpu_torch framework (PyTorch/CUDA on GPU).", "",
            "| config | value |", "|---|---|"]
    body += [f"| {k} | {v} |" for k, v in rows]
    if finetuned_from:
        body += ["", f"Fine-tuned from `{finetuned_from}`."]
    if dataset:
        body += ["", f"Trained on `{dataset}`."]
    if metrics:
        body += ["", "## Final metrics", "",
                 "| metric | value |", "|---|---|"]
        body += [f"| {k} | {v} |" for k, v in metrics.items()]
    for k, v in (extra or {}).items():
        body += ["", f"## {k}", "", str(v)]
    body += ["", "## Usage", "", "```bash",
             "python -m plantcaduceus_tpu_torch.cli.zero_shot_score \\",
             f"  -input-table snps.tsv -model {directory.name} "
             "-output scores.tsv", "```", ""]

    card = directory / "README.md"
    card.write_text("\n".join(meta_lines + body))
    return card


def push_to_hub(directory, repo_id: str, *, private: bool = True,
                token: Optional[str] = None) -> str:
    """Upload an exported checkpoint dir to the HF hub.

    Requires the ``huggingface_hub`` wheel and network egress; without
    either the failure is a single clear error (the reference's
    trainer.push_to_hub would die inside requests). The model card written
    by write_model_card rides along as README.md.
    """
    directory = Path(directory)
    if not directory.is_dir():
        raise FileNotFoundError(f"export dir {directory} does not exist")
    offline_msg = (
        "push_to_hub needs the huggingface_hub package and network egress. "
        "The checkpoint directory is complete and self-contained "
        f"({directory}); upload it from a connected machine with "
        f"`huggingface-cli upload {repo_id} {directory}`.")
    try:
        from huggingface_hub import HfApi  # type: ignore
    except ImportError as e:
        raise RuntimeError(offline_msg) from e
    try:
        api = HfApi(token=token)
        api.create_repo(repo_id, private=private, exist_ok=True)
        info = api.upload_folder(folder_path=str(directory),
                                 repo_id=repo_id)
    except Exception as e:  # no egress: one clear actionable error
        raise RuntimeError(f"hub upload failed ({e}). {offline_msg}") from e
    return str(info)


def _final_metrics_from_log(metrics: Optional[Dict[str, float]]):
    """Normalise a metrics dict for card emission (drop non-scalars)."""
    if not metrics:
        return None
    out = {}
    for k, v in metrics.items():
        try:
            out[k] = round(float(v), 6)
        except (TypeError, ValueError):
            continue
    return out or None
