"""CLI: LoRA and full fine-tuning on the GPU (the JAX CLI's subcommands and flags).

Subcommands:

  tokenize  — TSV -> fixed-length token ids (``.npz``, or gzip ``.parquet``
              with list columns)
  train     — LoRA adapters (r=8, alpha=32, dropout .1, the Mamba
              projections) + task head, or every weight with
              ``--full-finetune``; classification | regression | multi_label
  evaluate  — metrics on a tokenized file
  predict   — probabilities/values CSV
  display   — adapter/base parameter inventory and trainability

Data files: the path's suffix decides the format. ``.npz`` holds
``input_ids`` (int32 [n, L]) and ``label`` or ``labels`` (numpy);
``.parquet`` holds them as columns, ``input_ids`` and ``labels`` as lists,
read and written by the port's ``io.parquet`` (the JAX CLI's zstd files
read too; the port writes gzip). ``tokenize --data-dir`` reads TSVs through
``io.tables`` (``.gz/.bz2/.xz/.zip`` too); hub datasets are refused.
Checkpoints: ``<output-dir>/checkpoint-N`` (resumable with
``--resume-from``) and ``final/`` (the adapter export); ``evaluate`` and
``predict`` also take PEFT adapter dirs (with ``--model-name``). Runs on
CUDA unless ``--device cpu`` is given; raises when CUDA is asked for and
absent.

Several ranks (``python -m torch.distributed.run --nproc-per-node N -m
plantcaduceus_tpu_torch.cli.lora_fine_tune train ...``) fine-tune over a
data axis, as JAX's ``make_mesh()``: each step's global batch
(``--train-batch-size`` × ``--grad-accum`` rows) splits over the ranks,
and ``evaluate``/``predict`` split each batch's rows (batch sizes must
divide by the ranks). Rank 0 alone writes and prints. Dropout masks are
drawn per rank from the one seed over its own rows, as JAX draws them
(``train/lora.py``).

Examples:
  python -m plantcaduceus_tpu_torch.cli.lora_fine_tune tokenize \\
      --data-dir data.tsv --output-path data.npz --sequence-length 512
  python -m plantcaduceus_tpu_torch.cli.lora_fine_tune train \\
      --train-dir train.npz --valid-dir valid.npz \\
      --model-name <hf dir|preset> --output-dir /tmp/ft --max-steps 500
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
import sys
from pathlib import Path

import numpy as np
import torch

from plantcaduceus_tpu_torch.parallel import mesh as meshlib
from plantcaduceus_tpu_torch.utils.platform import default_device, maybe_force_platform

log = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# tokenize
# ---------------------------------------------------------------------------


def _column(values):
    """A TSV column as pandas infers it: int64, else float64, else text."""
    for kind in (int, float):
        try:
            return np.array([kind(v) for v in values])
        except ValueError:
            pass
    return np.array(values, dtype=object)


def cmd_tokenize(args):
    from plantcaduceus_tpu_torch.io.tables import open_table
    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu_torch.utils.model_loading import load_tokenizer_only

    tok = load_tokenizer_only(args.model_name) if args.model_name else DnaTokenizer()
    if args.hf_dataset:
        sys.exit("--hf-dataset needs the datasets package and the network, which the "
                 "PyTorch port does not use; export the split to a TSV and pass --data-dir")
    if not args.data_dir:
        sys.exit("provide --data-dir or --hf-dataset")
    with open_table(args.data_dir) as f:
        reader = csv.reader(f, delimiter="\t")
        header = [c.lower() for c in next(reader)]
        rows = list(reader)
    cols = {c: [r[i] for r in rows] for i, c in enumerate(header)}
    seq_col = args.seq_column.lower()
    label_col = args.label_column.lower()

    L = args.sequence_length
    seqs = cols[seq_col]
    lengths = np.array([len(s) for s in seqs])
    if (lengths != L).any():
        # reference behavior: pad/truncate to max_length then error if unequal
        raise ValueError(f"All sequences must be of length {L}; found lengths "
                         f"{sorted(np.unique(lengths))[:5]}")
    ids = tok.encode_batch(seqs)
    out = {"input_ids": ids}
    if label_col in cols:
        if args.task_type == "multi_label":
            out["labels"] = np.array([[int(c) for c in v] for v in cols[label_col]])
        else:
            out["label"] = _column(cols[label_col])
    output = args.output_path or str(Path(args.data_dir).with_suffix(".parquet"))
    if not _rank0():
        return
    _save_data(output, out)
    log.info("Wrote %d tokenized rows to %s", len(ids), output)


def _save_data(path, data):
    if str(path).endswith(".npz"):
        np.savez(path, **data)
        return
    from plantcaduceus_tpu_torch.io.parquet import write_parquet

    write_parquet(path, {k: data[k] for k in ("input_ids", "labels", "label") if k in data})


# ---------------------------------------------------------------------------
# shared model/data loading for train/evaluate/predict
# ---------------------------------------------------------------------------


def _load_data(path):
    """(ids int32 [n, L], labels or None) from a ``.npz`` or ``.parquet``."""
    if str(path).endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            ids = z["input_ids"].astype(np.int32)
            labels = None
            if "labels" in z:
                labels = z["labels"].astype(np.float32)
            elif "label" in z:
                labels = z["label"]
        return ids, labels
    from plantcaduceus_tpu_torch.io.parquet import read_parquet

    cols = read_parquet(path)

    def rows(name):
        if any(v is None for v in cols[name]):
            raise ValueError(f"{path}: column {name!r} holds a null list")
        return np.stack(cols[name])

    ids = rows("input_ids").astype(np.int32)
    labels = None
    if "labels" in cols:
        labels = rows("labels").astype(np.float32)
    elif "label" in cols:  # text labels come as a list: an object array, as pandas gives
        labels = cols["label"]
        labels = labels if isinstance(labels, np.ndarray) else np.array(labels, dtype=object)
    return ids, labels


def _batch_at(ids, labels, batch_size, step, seed=0, shuffle=True):
    """Training batch for a global step as a PURE function of (seed, step):
    global row g = step*batch_size + j indexes the concatenation of
    per-epoch permutations, so (a) no tail rows are ever dropped at epoch
    boundaries (the reference's HF Trainer keeps them via drop_last=False) —
    the tail simply shares a batch with the next epoch's head — and (b)
    resume from a checkpoint replays the exact uninterrupted stream."""
    n = ids.shape[0]

    def order(epoch):
        if not shuffle:
            return np.arange(n)
        return np.random.default_rng([seed, epoch]).permutation(n)

    g0 = step * batch_size
    e0, e1 = g0 // n, (g0 + batch_size - 1) // n
    orders = {e: order(e) for e in range(e0, e1 + 1)}
    idx = np.array([orders[g // n][g % n] for g in range(g0, g0 + batch_size)])
    batch = {"input_ids": ids[idx]}
    if labels is not None:
        batch["labels"] = labels[idx]
    return batch


def _rank0() -> bool:
    return meshlib.world()[0] == 0


def _build(args, task_type, num_labels):
    from plantcaduceus_tpu_torch.train import lora as lora_lib
    from plantcaduceus_tpu_torch.train.optimizer import make_optimizer
    from plantcaduceus_tpu_torch.utils.device import resolve_device
    from plantcaduceus_tpu_torch.utils.model_loading import load_model_and_tokenizer

    resolve_device(args.device)  # before any work: no silent CPU run
    device = meshlib.initialize_distributed(args.device)  # this rank's device
    mesh = meshlib.cli_mesh()
    model, cfg, tok = load_model_and_tokenizer(args.model_name)
    cfg_l = lora_lib.LoraConfig(r=args.lora_r, alpha=args.lora_alpha, dropout=args.lora_dropout)
    if num_labels is None:
        num_labels = {"classification": 2, "regression": 1}.get(task_type)
    # No params: every tensor decays, as optax without a mask (the JAX CLI).
    optimizer = make_optimizer(
        learning_rate=args.learning_rate, schedule="linear", warmup_steps=args.warmup_steps,
        total_steps=args.max_steps, weight_decay=args.weight_decay, grad_clip=1.0)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    grad_accum = getattr(args, "grad_accum", 1)
    if getattr(args, "full_finetune", False):
        train_step, infer_fn = lora_lib.make_full_finetune_step(
            cfg, optimizer, model, task_type=task_type, dtype=dtype, grad_accum=grad_accum,
            device=device, mesh=mesh)
    else:
        train_step, infer_fn = lora_lib.make_lora_train_step(
            cfg, cfg_l, optimizer, model, task_type=task_type, dtype=dtype,
            grad_accum=grad_accum, device=device, mesh=mesh)
    return model, cfg, tok, cfg_l, optimizer, train_step, infer_fn, num_labels, device


def _predict_all(infer_fn, state, model, ids, batch_size):
    out = []
    n = ids.shape[0]
    for i in range(0, n, batch_size):
        chunk = ids[i: i + batch_size]
        k = chunk.shape[0]
        if k < batch_size:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], batch_size - k, axis=0)])
        logits = infer_fn(state, model, {"input_ids": chunk}).float().cpu().numpy()
        out.append(logits[:k])
    return np.concatenate(out, axis=0)


def cmd_train(args):
    from plantcaduceus_tpu_torch.downstream import metrics as M
    from plantcaduceus_tpu_torch.models import heads as heads_lib
    from plantcaduceus_tpu_torch.models.caduceus import fold_in
    from plantcaduceus_tpu_torch.train import lora as lora_lib

    task_type = args.task_type
    ids_tr, y_tr = _load_data(args.train_dir)
    ids_ev, y_ev = _load_data(args.valid_dir)
    if args.eval_num_samples:
        ids_ev, y_ev = ids_ev[: args.eval_num_samples], y_ev[: args.eval_num_samples]

    num_labels = args.num_labels
    if task_type == "multi_label":
        if num_labels is None:
            num_labels = y_tr.shape[1]
    (model, cfg, tok, cfg_l, optimizer, train_step, infer_fn, num_labels,
     device) = _build(args, task_type, num_labels)

    if args.resume_from:
        state, cfg_l_saved, task_saved, _ = lora_lib.load_train_state(args.resume_from, device)
        if task_saved != task_type:
            sys.exit(f"checkpoint task_type {task_saved!r} != requested {task_type!r}")
        meta = json.loads((Path(args.resume_from) / "adapter_config.json").read_text())
        saved_full = meta.get("full_finetune", False)
        if saved_full != bool(args.full_finetune):
            sys.exit(f"checkpoint was saved with full_finetune={saved_full} "
                     f"but --full-finetune={bool(args.full_finetune)} was "
                     "requested — pass the matching mode to resume")
        if not saved_full and (cfg_l_saved.r, cfg_l_saved.alpha, cfg_l_saved.dropout,
                               tuple(cfg_l_saved.targets)) != (
                                   cfg_l.r, cfg_l.alpha, cfg_l.dropout, tuple(cfg_l.targets)):
            sys.exit(
                "checkpoint LoRA config "
                f"(r={cfg_l_saved.r}, alpha={cfg_l_saved.alpha}, "
                f"dropout={cfg_l_saved.dropout}, "
                f"targets={list(cfg_l_saved.targets)}) does not match the "
                f"CLI configuration (r={cfg_l.r}, alpha={cfg_l.alpha}, "
                f"dropout={cfg_l.dropout}, targets={list(cfg_l.targets)}) "
                "— resume with the original hyperparameters")
        if saved_full:
            state = lora_lib.init_full_state(model, state.head, optimizer, params=state.adapters,
                                             step=state.step, opt_state=state.opt_state)
        log.info("Resumed training from %s at step %d", args.resume_from, state.step)
    elif args.full_finetune:
        head = heads_lib.init_head(torch.Generator().manual_seed(args.seed + 9), cfg, num_labels)
        state = lora_lib.init_full_state(model, head, optimizer)
    else:
        state = lora_lib.init_lora_state(args.seed, model, cfg, cfg_l, num_labels, optimizer,
                                         device=device)

    # One optimizer step consumes train_batch_size * grad_accum rows.
    step_rows = args.train_batch_size * args.grad_accum
    rng = args.seed + 1
    start_step = int(state.step)
    for step in range(start_step, args.max_steps):
        batch = _batch_at(ids_tr, y_tr, step_rows, step, seed=args.seed)
        # Dropout seed keyed by step (not a sequential draw): a resumed run
        # draws the exact masks an uninterrupted one would.
        state, metrics = train_step(state, model, batch, fold_in(rng, step))
        loss = float(metrics["loss"])
        if (step + 1) % args.logging_steps == 0:
            log.info("step %d/%d loss=%.4f", step + 1, args.max_steps, loss)
        if (step + 1) % args.eval_steps == 0 or step + 1 == args.max_steps:
            logits = _predict_all(infer_fn, state, model, ids_ev, args.eval_batch_size)
            m = _task_metrics(task_type, logits, y_ev, M)
            log.info("eval @ %d: %s", step + 1, {k: round(v, 4) for k, v in m.items()})
        if (step + 1) % args.save_steps == 0 or step + 1 == args.max_steps:
            _save_state(args, Path(args.output_dir) / f"checkpoint-{step+1}", state, cfg_l,
                        task_type, resumable=True)
    _save_state(args, Path(args.output_dir) / "final", state, cfg_l, task_type)
    meshlib.barrier()   # on disk before any rank goes on (a suite evaluates it next)
    log.info("Saved adapter to %s/final", args.output_dir)


def _save_state(args, path, state, cfg_l, task_type, resumable=False):
    from plantcaduceus_tpu_torch.train import lora as lora_lib

    if not _rank0():
        return
    if args.full_finetune:
        cfg_l = lora_lib.LoraConfig(r=0, alpha=0.0, dropout=0.0, targets=())
    if resumable:  # checkpoint-N: adapter + optimizer/step for --resume-from
        lora_lib.save_train_state(path, state, cfg_l, task_type, args.model_name)
    else:          # final export: adapter only (evaluate/predict format)
        lora_lib.save_adapter(path, state, cfg_l, task_type, args.model_name)
    if args.full_finetune:
        meta_path = Path(path) / "adapter_config.json"
        meta = json.loads(meta_path.read_text())
        meta["full_finetune"] = True
        meta_path.write_text(json.dumps(meta, indent=2))


def _task_metrics(task_type, logits, labels, M):
    if task_type == "classification":
        return M.classification_metrics(logits, labels.astype(int))
    if task_type == "regression":
        return M.regression_metrics(logits[:, 0], labels)
    return M.multilabel_metrics(logits, labels)


def _load_for_eval(args):
    from plantcaduceus_tpu_torch.compat import peft_adapter
    from plantcaduceus_tpu_torch.train import lora as lora_lib

    ns = argparse.Namespace(**vars(args))
    if peft_adapter.is_peft_adapter_dir(args.checkpoint_dir):
        # Released PEFT-format adapter dirs map onto the adapter tree through
        # the strict importer; their base_model_name_or_path is a hub id.
        from plantcaduceus_tpu_torch.utils.model_loading import load_model_and_tokenizer

        if not args.model_name:
            raise SystemExit("--model-name is required with a PEFT adapter "
                             "dir (its base_model_name_or_path is a hub id, "
                             "not a local path)")
        _, cfg_probe, _ = load_model_and_tokenizer(args.model_name)
        adapters, head, cfg_l, task_type, _ = peft_adapter.import_peft_adapter(
            args.checkpoint_dir, cfg_probe)
        if head is None:
            raise SystemExit("PEFT adapter carries no classification head "
                             "(modules_to_save) — cannot evaluate/predict")
        ns.full_finetune = False
        ns.lora_r, ns.lora_alpha, ns.lora_dropout = cfg_l.r, cfg_l.alpha, cfg_l.dropout
    else:
        adapters, head, cfg_l, task_type, base = lora_lib.load_adapter(args.checkpoint_dir)
        meta = json.loads((Path(args.checkpoint_dir) / "adapter_config.json").read_text())
        ns.model_name = args.model_name or base
        ns.full_finetune = meta.get("full_finetune", False)
        if not ns.full_finetune:
            ns.lora_r, ns.lora_alpha, ns.lora_dropout = cfg_l.r, cfg_l.alpha, cfg_l.dropout
    num_labels = head["b"].shape[0]
    (model, cfg, tok, _, optimizer, train_step, infer_fn, _,
     device) = _build(ns, task_type, num_labels)
    if ns.full_finetune:
        state = lora_lib.init_full_state(model, head, optimizer, params=adapters)
    else:
        state = lora_lib.LoraTrainState(lora_lib.trainable_copy(adapters, device),
                                        lora_lib.trainable_copy(head, device), None, 0)
    return state, model, infer_fn, task_type


def cmd_evaluate(args):
    from plantcaduceus_tpu_torch.downstream import metrics as M

    state, model, infer_fn, task_type = _load_for_eval(args)
    ids, labels = _load_data(args.data_dir)
    logits = _predict_all(infer_fn, state, model, ids, args.batch_size)
    m = _task_metrics(task_type, logits, labels, M)
    if not _rank0():
        return
    log.info("Results: %s", m)
    print("\n".join(f"{k}\t{v:.6f}" for k, v in m.items()))
    if getattr(args, "metrics_json", None):
        Path(args.metrics_json).write_text(
            json.dumps({k: float(v) for k, v in m.items()}, indent=1))


def cmd_predict(args):
    from plantcaduceus_tpu_torch.downstream.metrics import sigmoid, softmax

    state, model, infer_fn, task_type = _load_for_eval(args)
    ids, _ = _load_data(args.data_dir)
    logits = _predict_all(infer_fn, state, model, ids, args.batch_size)
    if not _rank0():
        return
    if task_type == "classification":
        header, values = ["probability_positive"], softmax(logits, 1)[:, 1:2]
    elif task_type == "regression":
        header, values = ["predicted_value"], logits[:, :1]
    else:
        values = sigmoid(logits)
        header = [f"class_{i}" for i in range(values.shape[1])]
    # pandas' to_csv layout: a header row, no index, each value's shortest repr
    with open(args.output_file, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows([[str(v) for v in row] for row in values])
    log.info("Predictions saved to %s", args.output_file)


def _jax_leaves(tree, prefix=""):
    """(JAX keystr, tensor) pairs in ``jax.tree_util``'s order (sorted keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_leaves(tree[k], f"{prefix}['{k}']")
    else:
        yield prefix, tree


def cmd_display(args):
    from plantcaduceus_tpu_torch.compat.params import to_jax_params
    from plantcaduceus_tpu_torch.train import lora as lora_lib
    from plantcaduceus_tpu_torch.utils.model_loading import load_model_and_tokenizer

    model, cfg, _ = load_model_and_tokenizer(args.model_name)
    cfg_l = lora_lib.LoraConfig(r=args.lora_r, alpha=args.lora_alpha, dropout=args.lora_dropout)
    adapters = lora_lib.init_lora(torch.Generator().manual_seed(0), model, cfg_l)
    rows = [(path, False, tuple(leaf.shape), int(leaf.size))
            for path, leaf in _jax_leaves(to_jax_params(model))]
    rows += [("lora" + path, True, tuple(leaf.shape), leaf.numel())
             for path, leaf in _jax_leaves(adapters)]
    if not _rank0():
        return
    total = sum(r[3] for r in rows)
    trainable = sum(r[3] for r in rows if r[1])
    w = max(len(r[0]) for r in rows) + 2
    print(f"{'Name':<{w}} {'Trainable':<10} {'Shape':<24} Size")
    for name, tr, shape, size in rows:
        print(f"{name:<{w}} {str(tr):<10} {str(shape):<24} {size}")
    print(f"\ntrainable params: {trainable} | all params: {total} "
          f"| trainable%: {100*trainable/total:.4f}")


# ---------------------------------------------------------------------------


def main(argv=None):
    maybe_force_platform()
    logging.basicConfig(force=True, level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    tkn = sub.add_parser("tokenize")
    tkn.add_argument("--data-dir", default=None)
    tkn.add_argument("--output-path", default=None,
                     help=".npz or .parquet; default: --data-dir as .parquet")
    tkn.add_argument("--model-name", default=None)
    tkn.add_argument("--sequence-length", type=int, default=8192)
    tkn.add_argument("--task-type", default="classification")
    tkn.add_argument("--hf-dataset", default=None, help="refused by the port (needs the network)")
    tkn.add_argument("--hf-config", default=None)
    tkn.add_argument("--hf-split", default="train")
    tkn.add_argument("--seq-column", default="sequence")
    tkn.add_argument("--label-column", default="label")
    tkn.set_defaults(fn=cmd_tokenize)

    def common(sp):
        sp.add_argument("--model-name", default=None)
        sp.add_argument("--task-type", default="classification",
                        choices=["classification", "regression", "multi_label"])
        sp.add_argument("--num-labels", type=int, default=None)
        sp.add_argument("--full-finetune", action="store_true",
                        help="train all backbone params (FULL strategy) "
                             "instead of LoRA adapters")
        sp.add_argument("--lora-r", type=int, default=8)
        sp.add_argument("--lora-alpha", type=float, default=32)
        sp.add_argument("--lora-dropout", type=float, default=0.1)
        sp.add_argument("--learning-rate", type=float, default=1e-3)
        sp.add_argument("--warmup-steps", type=int, default=50)
        sp.add_argument("--max-steps", type=int, default=500)
        sp.add_argument("--weight-decay", type=float, default=0.01)
        sp.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True)
        sp.add_argument("--seed", type=int, default=42)
        sp.add_argument("--device", default=default_device(),
                        help="cuda (default; PCAD_PLATFORM=cpu makes it cpu) or cpu")

    tr = sub.add_parser("train")
    common(tr)
    tr.add_argument("--train-dir", required=True)
    tr.add_argument("--valid-dir", required=True)
    tr.add_argument("--output-dir", default="/tmp/pcv2-ft")
    tr.add_argument("--train-batch-size", type=int, default=8)
    tr.add_argument("--grad-accum", type=int, default=64,
                    help="gradient-accumulation microbatches per optimizer "
                         "step (reference gradient_accumulation_steps default: 64)")
    tr.add_argument("--resume-from", default=None,
                    help="checkpoint-N dir from a previous run: restores "
                         "adapters + head + optimizer state + step and "
                         "replays the exact data/dropout stream "
                         "(reference resume_from_checkpoint)")
    tr.add_argument("--eval-batch-size", type=int, default=8)
    tr.add_argument("--eval-num-samples", type=int, default=0)
    tr.add_argument("--eval-steps", type=int, default=25)
    tr.add_argument("--save-steps", type=int, default=100)
    tr.add_argument("--logging-steps", type=int, default=10)
    tr.set_defaults(fn=cmd_train)

    ev = sub.add_parser("evaluate")
    common(ev)
    ev.add_argument("--checkpoint-dir", required=True)
    ev.add_argument("--data-dir", required=True)
    ev.add_argument("--batch-size", type=int, default=8)
    ev.add_argument("--metrics-json", default=None,
                    help="also write the metrics dict to this JSON path")
    ev.set_defaults(fn=cmd_evaluate)

    pr = sub.add_parser("predict")
    common(pr)
    pr.add_argument("--checkpoint-dir", required=True)
    pr.add_argument("--data-dir", required=True)
    pr.add_argument("--batch-size", type=int, default=8)
    pr.add_argument("--output-file", default="/tmp/predictions.csv")
    pr.set_defaults(fn=cmd_predict)

    dp = sub.add_parser("display")
    common(dp)
    dp.set_defaults(fn=cmd_display)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
