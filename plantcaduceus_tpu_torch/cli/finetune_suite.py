"""CLI: fine-tuning job suite — run a manifest of fine-tune jobs, aggregate.

Counterpart of ``plantcaduceus_tpu.cli.finetune_suite`` (the capability of
the reference's GLUE fine-tuning harness: one job per task, each building
its own trainer, plus an aggregation layer): a JSON manifest declares the
jobs (any mix of classification / regression / multi-label, LoRA or full
fine-tune); each job runs through the port's ``cli.lora_fine_tune train``
then ``evaluate``; the suite writes one ``suite_metrics.json`` and prints a
summary table. The same manifests run in both packages; a ``device`` entry
(``"device": "cpu"``) reaches both subcommands.

Manifest format:

    {
      "defaults": {"model-name": "l20", "max-steps": 200,
                   "train-batch-size": 8},
      "jobs": [
        {"name": "TIS",
         "train_dir": "tis_train.npz", "valid_dir": "tis_valid.npz",
         "eval_dir": "tis_test.npz",              // optional, default valid
         "task_type": "classification",            // optional
         "overrides": {"learning-rate": 5e-4}}     // per-job flag overrides
      ]
    }

``defaults``/``overrides`` keys are ``lora_fine_tune`` flags without the
leading ``--``. Use ``--only a,b`` to run a subset and ``--skip-train`` to
re-aggregate metrics from existing checkpoints.

Several ranks (``python -m torch.distributed.run --nproc-per-node N -m
plantcaduceus_tpu_torch.cli.finetune_suite ...``) run every job over the
data axis (``cli.lora_fine_tune``); rank 0 alone writes and prints.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

from plantcaduceus_tpu_torch.cli import lora_fine_tune
from plantcaduceus_tpu_torch.parallel.mesh import world
from plantcaduceus_tpu_torch.utils.platform import maybe_force_platform

log = logging.getLogger(__name__)


def _flags(d: dict) -> list:
    out = []
    for k, v in d.items():
        key = "--" + str(k).lstrip("-")
        if isinstance(v, bool):
            if v:
                out.append(key)
        else:
            out += [key, str(v)]
    return out


def run_suite(manifest: dict, output_dir: Path, only=None,
              skip_train: bool = False) -> dict:
    defaults = manifest.get("defaults", {})
    results = {}
    for job in manifest["jobs"]:
        name = job["name"]
        if only and name not in only:
            continue
        job_dir = output_dir / name
        job_dir.mkdir(parents=True, exist_ok=True)
        task_flags = dict(defaults)
        if "task_type" in job:
            task_flags["task-type"] = job["task_type"]
        task_flags.update(job.get("overrides", {}))

        if not skip_train:
            log.info("=== job %s: train ===", name)
            lora_fine_tune.main(
                ["train", "--train-dir", job["train_dir"],
                 "--valid-dir", job["valid_dir"],
                 "--output-dir", str(job_dir)] + _flags(task_flags))

        metrics_path = job_dir / "metrics.json"
        eval_flags = {k: v for k, v in task_flags.items()
                      if k in ("model-name", "task-type", "num-labels",
                               "bf16", "no-bf16", "seed", "batch-size", "device")}
        log.info("=== job %s: evaluate ===", name)
        lora_fine_tune.main(
            ["evaluate", "--checkpoint-dir", str(job_dir / "final"),
             "--data-dir", job.get("eval_dir", job["valid_dir"]),
             "--metrics-json", str(metrics_path)] + _flags(eval_flags))
        if world()[0] == 0:   # rank 0 wrote it
            results[name] = json.loads(metrics_path.read_text())

    if world()[0] == 0:
        (output_dir / "suite_metrics.json").write_text(
            json.dumps(results, indent=1))
    return results


def _print_table(results: dict) -> None:
    cols = sorted({k for m in results.values() for k in m})
    widths = [max(len("job"), *(len(n) for n in results))] + [
        max(len(c), 9) for c in cols]
    head = ["job".ljust(widths[0])] + [c.rjust(w)
                                       for c, w in zip(cols, widths[1:])]
    print("  ".join(head))
    for name, m in results.items():
        row = [name.ljust(widths[0])]
        for c, w in zip(cols, widths[1:]):
            row.append((f"{m[c]:.4f}" if c in m else "-").rjust(w))
        print("  ".join(row))


def main(argv=None):
    maybe_force_platform()
    logging.basicConfig(force=True, level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("manifest", help="suite manifest JSON")
    p.add_argument("--output-dir", default="/tmp/pcad-suite")
    p.add_argument("--only", default=None,
                   help="comma-separated job names to run")
    p.add_argument("--skip-train", action="store_true",
                   help="aggregate/evaluate existing checkpoints only")
    args = p.parse_args(argv)

    manifest = json.loads(Path(args.manifest).read_text())
    only = set(args.only.split(",")) if args.only else None
    results = run_suite(manifest, Path(args.output_dir), only,
                        args.skip_train)
    if world()[0] == 0:
        _print_table(results)


if __name__ == "__main__":
    main()
