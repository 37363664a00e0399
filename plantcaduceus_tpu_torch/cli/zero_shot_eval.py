"""CLI: PlantCAD2 zero-shot evaluation suite (src/zero-shot-eval.py), on the GPU.

Counterpart of ``plantcaduceus_tpu.cli.zero_shot_eval``, with its
subcommands, flags and outputs, plus ``--device``:
evo_cons | motif_acc | sv_effect | core_noncore.

``--repo-id`` is a local TSV (header row, tab-separated; ``.gz``, ``.bz2``,
``.xz`` or ``.zip`` by its suffix, as pandas reads them) or a local
``.parquet`` table (the port's reader, ``io/parquet``: zstd, gzip, snappy
or uncompressed; a codec or column it does not read exits with its
message). Refused, with a message: a
hub dataset id (no network). Logit caching via --save-logits /
--logits-path and metrics via --metrics-json, in the JAX CLI's layouts
(TSV).

Several ranks (``python -m torch.distributed.run --nproc-per-node N -m
plantcaduceus_tpu_torch.cli.zero_shot_eval ...``) score over a data × seq
mesh, ``--seq S`` sharding each window's length over S ranks; every rank
gets every probability, and rank 0 alone prints and writes.

Example:
  python -m plantcaduceus_tpu_torch.cli.zero_shot_eval evo_cons \\
      --repo-id data.tsv --model <ckpt|preset> --token-idx 4095

Runs on CUDA unless ``--device cpu`` is given, and fails when CUDA is asked
for and absent.
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
from pathlib import Path
from typing import Dict, List

import numpy as np

from plantcaduceus_tpu_torch.io.parquet import read_parquet
from plantcaduceus_tpu_torch.io.tables import open_table
from plantcaduceus_tpu_torch.utils.platform import default_device, maybe_force_platform

log = logging.getLogger(__name__)


class Frame:
    """A TSV's header and rows, each row a dict of its cells as text."""

    def __init__(self, columns: List[str], rows: List[Dict[str, str]]):
        self.columns, self.rows = columns, rows

    def __len__(self) -> int:
        return len(self.rows)

    def col(self, name: str) -> List[str]:
        return [r[name] for r in self.rows]

    def ints(self, name: str) -> np.ndarray:
        """A column of integer labels (written as 1 or as 1.0)."""
        return np.array([int(float(v)) for v in self.col(name)], dtype=np.int64)


def read_tsv(path) -> Frame:
    with open_table(path) as fh:
        reader = csv.DictReader(fh, delimiter="\t")
        rows = list(reader)
        return Frame(list(reader.fieldnames or []), rows)


def write_tsv(path, columns: List[str], rows) -> None:
    """Header and rows, tab-separated, no index: pandas ``to_csv(sep="\\t",
    index=False)``'s layout. Numbers are written as numpy prints them (the
    shortest text that reads back to the same value, as pandas does).
    Compressed as the path's suffix says, as pandas does."""
    with open_table(path, "w") as fh:
        w = csv.writer(fh, delimiter="\t", lineterminator="\n")
        w.writerow(columns)
        for r in rows:
            w.writerow([str(v) for v in r])


def _cell(v) -> str:
    """A parquet value as the text a TSV cell would hold."""
    if v is None:
        return ""
    if isinstance(v, (int, np.integer)) and not isinstance(v, (bool, np.bool_)):
        return str(int(v))
    return str(v)


def read_parquet_frame(path) -> Frame:
    cols = read_parquet(path)
    names = list(cols)
    text = {c: [_cell(v) for v in cols[c]] for c in names}
    n = len(text[names[0]]) if names else 0
    return Frame(names, [{c: text[c][i] for c in names} for i in range(n)])


def _load_frame(repo_id: str, task, split) -> Frame:
    p = Path(repo_id)
    if not p.is_file():
        raise SystemExit(f"{repo_id}: not a local TSV or parquet file; the PyTorch port "
                         "reads local tables only (hub datasets need the network)")
    if p.suffix == ".parquet":
        try:
            return read_parquet_frame(p)
        except ValueError as e:  # a codec or column the port's reader refuses
            raise SystemExit(str(e)) from e
    return read_tsv(p)


def _writes() -> bool:
    """Whether this process prints and writes the outputs: rank 0."""
    from plantcaduceus_tpu_torch.parallel.mesh import world

    return world()[0] == 0


def _runner(args):
    import torch

    from plantcaduceus_tpu_torch.engine.runner import InferenceRunner
    from plantcaduceus_tpu_torch.io.tokenizer import nucleotide_ids
    from plantcaduceus_tpu_torch.parallel import mesh as meshlib
    from plantcaduceus_tpu_torch.utils.device import resolve_device
    from plantcaduceus_tpu_torch.utils.model_loading import load_model_and_tokenizer

    resolve_device(args.device)  # before the model: no silent CPU run
    device = meshlib.initialize_distributed(args.device)
    mesh = meshlib.cli_mesh(args.seq)
    model, cfg, tok = load_model_and_tokenizer(args.model)
    runner = InferenceRunner(model, cfg, dtype=torch.bfloat16, batch_size=args.batch_size,
                             device=device, mesh=mesh)
    return runner, tok, nucleotide_ids(tok)


def _masked_probs(args, sequences, positions):
    if args.logits_path:
        cached = read_tsv(args.logits_path)
        return np.array([[float(r[c]) for c in cached.columns] for r in cached.rows])
    runner, tok, nuc_ids = _runner(args)
    ids = tok.encode_batch([str(s) for s in sequences])
    ids[:, list(positions)] = tok.mask_token_id
    probs = runner.multi_masked_probs(ids, nuc_ids, positions,
                                      progress=not args.no_progress)
    if args.save_logits and _writes():
        write_tsv(args.save_logits, list("ACGT"), probs)
        log.info("Saved logits TSV to %s", args.save_logits)
    return probs


def _emit(metrics: dict, args):
    if not _writes():
        return
    for k, v in metrics.items():
        print(f"{k}\t{v:.6f}")
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(metrics, f, indent=2)


def cmd_evo_cons(args):
    from plantcaduceus_tpu_torch.engine import eval_tasks as T

    df = _load_frame(args.repo_id, args.task, args.split)
    seqs = df.col(args.seq_column)
    probs = _masked_probs(args, seqs, [args.token_idx])
    assert probs.shape[0] == len(df), \
        f"Row mismatch: probs={probs.shape[0]} examples={len(df)}"
    scores = T.refprob_scores(seqs, probs, args.token_idx)
    m = T.auroc_auprc(df.ints("label"), scores)
    m["token_idx"] = args.token_idx
    _emit({"AUROC": m["auroc"], "AUPRC": m["auprc"]}, args)
    if args.metrics_json and _writes():
        with open(args.metrics_json, "w") as f:
            json.dump(m, f, indent=2)


def _motif_probs(args, df):
    from plantcaduceus_tpu_torch.engine import eval_tasks as T

    positions = [int(x) for x in args.mask_idx.split(",")]
    assert len(positions) == args.motif_len, "mask_idx count must equal motif_len"
    seqs = df.col(args.seq_column)
    probs = _masked_probs(args, seqs, positions)
    expected = len(df) * len(positions)
    assert probs.shape[0] == expected, \
        f"Row mismatch: probs={probs.shape[0]} expected={expected}"
    return probs, T.true_tokens_from_seq(seqs, positions)


def cmd_motif_acc(args):
    from plantcaduceus_tpu_torch.engine import eval_tasks as T

    probs, true_tokens = _motif_probs(args, _load_frame(args.repo_id, args.task, args.split))
    _emit({"token_accuracy": T.token_accuracy(probs, true_tokens),
           "motif_accuracy": T.motif_accuracy(probs, true_tokens, args.motif_len)}, args)


def cmd_core_noncore(args):
    from plantcaduceus_tpu_torch.engine import eval_tasks as T

    df = _load_frame(args.repo_id, args.task, args.split)
    probs, true_tokens = _motif_probs(args, df)
    scores = T.avg_trueprob_scores(probs, true_tokens, args.motif_len)
    m = T.auroc_auprc(df.ints(args.label_column), scores)
    _emit({"AUROC": m["auroc"], "AUPRC": m["auprc"]}, args)


def cmd_sv_effect(args):
    from plantcaduceus_tpu_torch.engine import eval_tasks as T

    df = _load_frame(args.repo_id, args.task, args.split)
    required = ["RefSeq", "MutSeq", "left", "right", "label"]
    missing = [c for c in required if c not in df.columns]
    if missing:
        raise KeyError(f"Missing required columns: {missing}")

    runner, tok, nuc_ids = _runner(args)
    ref_probs = runner.positionwise_probs(tok.encode_batch(df.col("RefSeq")), nuc_ids,
                                          progress=not args.no_progress)
    mut_probs = runner.positionwise_probs(tok.encode_batch(df.col("MutSeq")), nuc_ids,
                                          progress=not args.no_progress)
    if args.save_ref_logits and _writes():
        np.savez_compressed(args.save_ref_logits, logits=ref_probs)
    if args.save_mut_logits and _writes():
        np.savez_compressed(args.save_mut_logits, logits=mut_probs)

    scores = T.sv_llr_boundary(df.rows, ref_probs, mut_probs, args.flanking)
    _emit({"AUPRC": T.average_precision(df.ints("label"), scores)}, args)
    if args.output and _writes():
        cols = [c for c in df.columns if c not in ("Left5_Positions", "Right5_Positions")]
        write_tsv(args.output, cols + ["score"],
                  ([r[c] for c in cols] + [s] for r, s in zip(df.rows, scores)))


def main(argv=None):
    maybe_force_platform()
    logging.basicConfig(force=True, level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--repo-id", required=True, help="a local TSV or .parquet table")
        sp.add_argument("--task", default=None)
        sp.add_argument("--split", default="valid")
        sp.add_argument("--model", default="pc2-small")
        sp.add_argument("--batch-size", type=int, default=128)
        sp.add_argument("--seq-column", default="sequence")
        sp.add_argument("--save-logits", default=None)
        sp.add_argument("--logits-path", default=None)
        sp.add_argument("--metrics-json", default=None)
        sp.add_argument("--seq", type=int, default=1,
                        help="context-parallel mesh shards over the window length "
                             "(ranks of torch.distributed.run)")
        sp.add_argument("--device", default=default_device(),
                        help="cuda (default; PCAD_PLATFORM=cpu makes it cpu) or cpu")
        sp.add_argument("--no-progress", action="store_true")

    ec = sub.add_parser("evo_cons")
    common(ec)
    ec.add_argument("--token-idx", type=int, default=255)
    ec.set_defaults(fn=cmd_evo_cons)

    ma = sub.add_parser("motif_acc")
    common(ma)
    ma.add_argument("--mask-idx", default="255,256,257")
    ma.add_argument("--motif-len", type=int, default=3)
    ma.set_defaults(fn=cmd_motif_acc)

    cn = sub.add_parser("core_noncore")
    common(cn)
    cn.add_argument("--mask-idx", default="255,256,257")
    cn.add_argument("--motif-len", type=int, default=3)
    cn.add_argument("--label-column", default="label")
    cn.set_defaults(fn=cmd_core_noncore)

    sv = sub.add_parser("sv_effect")
    common(sv)
    sv.add_argument("--flanking", type=int, default=5)
    sv.add_argument("--output", default=None)
    sv.add_argument("--save-ref-logits", default=None)
    sv.add_argument("--save-mut-logits", default=None)
    sv.set_defaults(fn=cmd_sv_effect)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
