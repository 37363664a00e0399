"""CLI: predict with a pre-trained XGBoost classifier over embeddings, on
the GPU (the reference's src/predict_XGBoost.py).

Counterpart of ``plantcaduceus_tpu.cli.predict_xgboost``, with its flags,
plus ``-device``. Loads a classifier (an XGBoost JSON file, e.g. the
released classifiers/PlantCaduceus_l{20..32}/{TIS,TTS,Donor,Acceptor}_XGBoost.json,
through the numpy evaluator when the xgboost wheel is absent, or a pickled
sklearn model), extracts RC-averaged centre embeddings of the input TSV's
``sequences`` column in bf16, and writes a ``label\\tprediction`` TSV:
``label`` holds each input cell as read (0 without a ``label`` column),
``prediction`` the positive class's probability as pandas prints a
float64. Tables may be ``.gz``, ``.bz2``, ``.xz`` or ``.zip`` by suffix.

Runs on CUDA unless ``-device cpu`` is given, and fails when CUDA is asked
for and absent. Several ranks (``python -m torch.distributed.run
--nproc-per-node N -m plantcaduceus_tpu_torch.cli.predict_xgboost ...``)
split each batch's rows over a data axis, as JAX's runner spans every
device; the embeddings equal one process's, and rank 0 alone writes.
"""

from __future__ import annotations

import argparse
import csv
import logging

from plantcaduceus_tpu_torch.parallel import mesh as meshlib
from plantcaduceus_tpu_torch.utils.platform import default_device, maybe_force_platform

log = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-input", dest="input", required=True,
                   help="TSV with a 'sequences' column (and optional 'label')")
    p.add_argument("-model", dest="model", required=True,
                   help="Caduceus checkpoint dir or preset")
    p.add_argument("-classifier", dest="classifier", required=True,
                   help="XGBoost classifier JSON")
    p.add_argument("-output", dest="output", required=True)
    p.add_argument("-batchSize", dest="batch_size", type=int, default=128,
                   help="rows of each forward, split over the ranks of the data axis")
    p.add_argument("-tokenIdx", dest="token_idx", type=int, default=255)
    p.add_argument("-device", dest="device", default=default_device(),
                   help="cuda (default; PCAD_PLATFORM=cpu makes it cpu) or cpu")
    p.add_argument("-no-progress", action="store_true", dest="no_progress")
    return p.parse_args(argv)


def main(argv=None):
    maybe_force_platform()
    import torch

    from plantcaduceus_tpu_torch.downstream.gbm import GbmClassifier
    from plantcaduceus_tpu_torch.engine.runner import InferenceRunner
    from plantcaduceus_tpu_torch.engine.zero_shot import read_table
    from plantcaduceus_tpu_torch.io.tables import open_table
    from plantcaduceus_tpu_torch.utils.device import resolve_device
    from plantcaduceus_tpu_torch.utils.model_loading import load_model_and_tokenizer

    logging.basicConfig(force=True, level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s",
                        datefmt="%Y-%m-%d %H:%M:%S")
    args = parse_args(argv)
    resolve_device(args.device)  # before any work: no silent CPU run
    device = meshlib.initialize_distributed(args.device)  # this rank's device
    mesh = meshlib.cli_mesh()

    table = read_table(args.input)
    model, cfg, tok = load_model_and_tokenizer(args.model)
    runner = InferenceRunner(model, cfg, dtype=torch.bfloat16,
                             batch_size=args.batch_size, device=device, mesh=mesh)
    ids = tok.encode_batch([r["sequences"] for r in table.rows])
    emb = runner.center_embeddings(ids, args.token_idx, progress=not args.no_progress)
    if meshlib.world()[0] != 0:
        return

    clf = GbmClassifier.load(args.classifier)
    preds = clf.predict_proba(emb)[:, 1]

    labels = ([r["label"] for r in table.rows] if "label" in table.columns
              else [0] * len(table.rows))
    with open_table(args.output, "w") as fh:
        w = csv.writer(fh, delimiter="\t", lineterminator="\n")
        w.writerow(["label", "prediction"])
        w.writerows([label, repr(float(p))] for label, p in zip(labels, preds))
    log.info("Wrote %d predictions to %s", len(preds), args.output)


if __name__ == "__main__":
    main()
