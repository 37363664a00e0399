"""CLI: XGBoost classifier over Caduceus embeddings, on the GPU
(the reference's src/train_XGBoost.py).

Counterpart of ``plantcaduceus_tpu.cli.train_xgboost``, with its flags,
file names and caches, plus ``-device``. The card extracts RC-averaged
centre-token embeddings in bf16 (hidden_states[-1][:, tokenIdx, :] split
channel-wise, the second half channel-reversed, averaged;
src/train_XGBoost.py:104-113); the boosted trees are host work. Embeddings
are cached as .npz named like the reference's, so reruns skip the forward
(:213-221): ``train_valid_embeddings.npz``, ``{prefix}_embeddings.npz`` and,
with ``-save_memory``, ``{prefix}_chunk_{i}_embeddings.npz`` (:175-190).
The model is ``seed_{seed}_XGBoost.json`` (a pickle under the sklearn
backend, as in the JAX package); predictions and metrics go to
``seed_{seed}_valid_predictions.npz``, ``seed_{seed}_{prefix}_predictions.npz``
and ``seed_{seed}_{prefix}_metrics.{txt,png}``, with ``prefix`` the input's
file name up to its first dot.

The fit needs xgboost or sklearn, which the GPU hosts lack: there a fit
caches the embeddings and then raises sklearn's ImportError, as the JAX
package does; rerun it where sklearn is installed (``-device cpu`` is
enough, the cache is read) and bring the model back for ``-test_only``.
Labels must be integers (pandas' integer column); others are refused.

Usage:
  python -m plantcaduceus_tpu_torch.cli.train_xgboost -train t.tsv -valid v.tsv \\
      [-test x.tsv] -model <ckpt|preset> -output outdir
  python -m plantcaduceus_tpu_torch.cli.train_xgboost -test x.tsv -test_only \\
      -model <ckpt> -output outdir [-save_memory -chunk_size 100000]

Runs on CUDA unless ``-device cpu`` is given, and fails when CUDA is asked
for and absent. Several ranks (``python -m torch.distributed.run
--nproc-per-node N -m plantcaduceus_tpu_torch.cli.train_xgboost ...``)
split each embedding batch's rows over a data axis, as JAX's runner spans
every device; the embeddings equal one process's, and rank 0 alone writes
the caches and outputs and fits. Every rank embeds the train, valid and
test sets before rank 0 fits, so no rank waits in a collective while the
fit runs.
"""

from __future__ import annotations

import argparse
import logging
import os
import re

import numpy as np

from plantcaduceus_tpu_torch.parallel import mesh as meshlib
from plantcaduceus_tpu_torch.utils.platform import default_device, maybe_force_platform

log = logging.getLogger(__name__)

_INT = re.compile(r"\s*[+-]?\d+\s*")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-train", dest="train")
    p.add_argument("-valid", dest="valid")
    p.add_argument("-test", dest="test")
    p.add_argument("-model", dest="model", required=True)
    p.add_argument("-output", dest="output", required=True)
    p.add_argument("-batchSize", dest="batch_size", type=int, default=128,
                   help="rows of each forward, split over the ranks of the data axis")
    p.add_argument("-tokenIdx", dest="token_idx", type=int, default=255)
    p.add_argument("-test_only", action="store_true", dest="test_only")
    p.add_argument("-save_memory", action="store_true", dest="save_memory")
    p.add_argument("-chunk_size", dest="chunk_size", type=int, default=100000)
    p.add_argument("-seed", dest="seed", type=int, default=42)
    p.add_argument("-device", dest="device", default=default_device(),
                   help="cuda (default; PCAD_PLATFORM=cpu makes it cpu) or cpu")
    p.add_argument("-no-progress", action="store_true", dest="no_progress")
    return p.parse_args(argv)


def load_data(filepath):
    """(sequences, integer labels) of a TSV with those columns."""
    from plantcaduceus_tpu_torch.engine.zero_shot import read_table

    log.info("Loading data from %s", filepath)
    rows = read_table(filepath).rows
    labels = []
    for i, r in enumerate(rows):
        if r["label"] is None or not _INT.fullmatch(r["label"]):
            raise ValueError(f"{filepath}: label {r['label']!r} of data row {i + 1} is not an "
                             "integer; the PyTorch port takes integer class labels only")
        labels.append(int(r["label"]))
    return [r["sequences"] for r in rows], labels


def make_embedder(args):
    import torch

    from plantcaduceus_tpu_torch.engine.runner import InferenceRunner
    from plantcaduceus_tpu_torch.utils.device import resolve_device
    from plantcaduceus_tpu_torch.utils.model_loading import load_model_and_tokenizer

    resolve_device(args.device)  # before the model: no silent CPU run
    device = meshlib.initialize_distributed(args.device)  # this rank's device
    model, cfg, tok = load_model_and_tokenizer(args.model)
    runner = InferenceRunner(model, cfg, dtype=torch.bfloat16,
                             batch_size=args.batch_size, device=device,
                             mesh=meshlib.cli_mesh())

    def embed(sequences):
        ids = tok.encode_batch(sequences)
        return runner.center_embeddings(ids, args.token_idx,
                                        progress=not args.no_progress)

    return embed


def train_xgb(train_emb, train_labels, valid_emb, valid_labels, seed):
    from plantcaduceus_tpu_torch.downstream.gbm import GbmClassifier

    log.info("Training gradient-boosted classifier")
    model = GbmClassifier(n_estimators=1000, max_depth=6,
                          learning_rate=0.1, random_state=seed)
    model.fit(train_emb, train_labels,
              eval_set=[(valid_emb, valid_labels)])
    return model


def plot_and_save_metrics(scores, labels, output_dir, prefix, seed):
    from plantcaduceus_tpu_torch.downstream.metrics import binary_curve_metrics

    m = binary_curve_metrics(np.asarray(scores), np.asarray(labels))
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axs = plt.subplots(1, 2, figsize=(12, 6))
        axs[0].plot(m["fpr"], m["tpr"], label=f"AUC = {m['roc_auc']:.2f}",
                    linewidth=2)
        axs[0].set_title("ROC Curve")
        axs[0].set_xlabel("False Positive Rate")
        axs[0].set_ylabel("True Positive Rate")
        axs[0].legend(loc="lower right")
        axs[1].plot(m["recall"], m["precision"],
                    label=f"PRAUC = {m['prauc']:.2f}", linewidth=2)
        axs[1].set_title("Precision-Recall Curve")
        axs[1].set_xlabel("Recall")
        axs[1].set_ylabel("Precision")
        axs[1].legend(loc="lower left")
        plt.tight_layout()
        plt.savefig(os.path.join(output_dir,
                                 f"seed_{seed}_{prefix}_metrics.png"))
        plt.close(fig)
    except Exception as e:  # no matplotlib, headless or plot issues: go on
        log.warning("plotting failed: %s", e)
    with open(os.path.join(output_dir, f"seed_{seed}_{prefix}_metrics.txt"),
              "w") as f:
        f.write(f"ROC AUC: {m['roc_auc']:.2f}\n")
        f.write(f"PRAUC: {m['prauc']:.2f}\n")
    log.info("%s: ROC AUC %.4f PRAUC %.4f", prefix, m["roc_auc"], m["prauc"])


def _cached(cache, embed, **sequences):
    """The cached embeddings of each keyword's sequences, or their
    embeddings, cached by rank 0. Every rank decides from the disk before
    any rank embeds, and rank 0 writes only after the embedding's
    collectives: the ranks agree."""
    if os.path.exists(cache):
        log.info("Found pre-computed embeddings %s", cache)
        z = np.load(cache)
        return tuple(z[k] for k in sequences)
    emb = {k: embed(v) for k, v in sequences.items()}
    if meshlib.world()[0] == 0:
        np.savez_compressed(cache, **emb)
    return tuple(emb.values())


def embed_test(args, embed, prefix, test_sequences):
    """Embed the test set into its caches (in chunks with -save_memory),
    on every rank."""
    if args.save_memory:
        log.info("Chunked scoring with chunk size %d", args.chunk_size)
        for i in range(0, len(test_sequences), args.chunk_size):
            cache = os.path.join(args.output, f"{prefix}_chunk_{i}_embeddings.npz")
            _cached(cache, embed, test=test_sequences[i : i + args.chunk_size])
        return
    _cached(os.path.join(args.output, f"{prefix}_embeddings.npz"), embed, test=test_sequences)


def score_test(args, xgb_model, prefix, n_test):
    """The test predictions from the caches ``embed_test`` wrote (rank 0)."""
    if args.save_memory:
        return np.concatenate([
            xgb_model.predict_proba(np.load(os.path.join(
                args.output, f"{prefix}_chunk_{i}_embeddings.npz"))["test"])[:, 1]
            for i in range(0, n_test, args.chunk_size)])
    emb = np.load(os.path.join(args.output, f"{prefix}_embeddings.npz"))["test"]
    return xgb_model.predict_proba(emb)[:, 1]


def main(argv=None):
    maybe_force_platform()
    from plantcaduceus_tpu_torch.downstream.gbm import GbmClassifier

    logging.basicConfig(force=True, level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s",
                        datefmt="%Y-%m-%d %H:%M:%S")
    args = parse_args(argv)
    os.makedirs(args.output, exist_ok=True)
    model_path = os.path.join(args.output, f"seed_{args.seed}_XGBoost.json")
    embed = make_embedder(args)
    rank0 = meshlib.world()[0] == 0

    if not args.test_only:
        train_seqs, train_labels = load_data(args.train)
        valid_seqs, valid_labels = load_data(args.valid)
        train_emb, valid_emb = _cached(
            os.path.join(args.output, "train_valid_embeddings.npz"), embed,
            train=train_seqs, valid=valid_seqs)
    if args.test:
        test_seqs, test_labels = load_data(args.test)
        test_prefix = os.path.basename(args.test).split(".")[0]
        embed_test(args, embed, test_prefix, test_seqs)
    if not rank0:   # every embedding is done: only rank 0 fits and writes
        return

    if not args.test_only:
        if os.path.exists(model_path):
            log.info("Found pre-trained XGBoost model %s", model_path)
            model = GbmClassifier.load(model_path)
        else:
            model = train_xgb(train_emb, train_labels, valid_emb,
                              valid_labels, args.seed)
            model.save(model_path)
            valid_pred = model.predict_proba(valid_emb)[:, 1]
            np.savez_compressed(
                os.path.join(args.output,
                             f"seed_{args.seed}_valid_predictions.npz"),
                predictions=valid_pred)
            prefix = os.path.basename(args.valid).split(".")[0]
            plot_and_save_metrics(valid_pred, valid_labels, args.output,
                                  prefix, args.seed)

    if args.test:
        model = GbmClassifier.load(model_path)
        preds = score_test(args, model, test_prefix, len(test_seqs))
        np.savez_compressed(
            os.path.join(args.output,
                         f"seed_{args.seed}_{test_prefix}_predictions.npz"),
            predictions=preds)
        plot_and_save_metrics(preds, test_labels, args.output, test_prefix,
                              args.seed)
    elif args.test_only:
        log.error("Please provide the test data")


if __name__ == "__main__":
    main()
