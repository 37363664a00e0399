"""CLI: persistent scoring server on the GPU (serving mode).

Counterpart of ``plantcaduceus_tpu.cli.serve``, with its flags, plus
``-device``. Builds the model once and then serves variant scores /
masked-nucleotide probabilities / RC-averaged embeddings over a JSON HTTP
API, with cross-request micro-batching (engine/server.py).

Several ranks serve one model as JAX serves over a mesh: ``python -m
torch.distributed.run --standalone --nproc-per-node S -m
plantcaduceus_tpu_torch.cli.serve -model l20 -seq S`` shards each window's
length over S ranks (context parallelism; ``-seq 1`` with several ranks
splits each batch's rows over them instead). The ranks may share one card.
Rank 0 alone binds the port and coalesces; it announces every forward to
the others (``engine.server.follow``). SIGTERM (or Ctrl-C) to rank 0 stops
the server and releases the other ranks, so every rank exits 0. A forward
that fails on a rank for another cause than its input (out of memory, say)
ends the server: that rank exits non-zero and ``torch.distributed.run``
stops the others. ``-batchSize`` is the rows of one forward over every
rank, split over the ranks of the data axis, as in JAX.

Usage:
    python -m plantcaduceus_tpu_torch.cli.serve -model l20 [-port 8142] \\
        [-batchSize 128] [-maxWaitMs 5] [-warmup]

API (see engine/server.py for schemas):
    GET  /healthz
    POST /score         {"items": [{"sequence","ref","alt"}, ...]}
    POST /masked_probs  {"sequences": [...], "pos": 255?}
    POST /embed         {"sequences": [...]}

Runs on CUDA unless ``-device cpu`` is given, and fails when CUDA is asked
for and absent.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys

from plantcaduceus_tpu_torch.parallel import mesh as meshlib
from plantcaduceus_tpu_torch.utils.platform import default_device, maybe_force_platform


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-model", dest="model", required=True,
                   help="HF checkpoint dir or preset (l20/l24/l28/l32)")
    p.add_argument("-host", dest="host", default="127.0.0.1")
    p.add_argument("-port", dest="port", type=int, default=8142)
    p.add_argument("-batchSize", dest="batch_size", type=int, default=128,
                   help="rows of each forward, split over the ranks of the data axis")
    p.add_argument("-maxBatch", dest="max_batch", type=int, default=1024,
                   help="coalescing cap across concurrent requests")
    p.add_argument("-maxWaitMs", dest="max_wait_ms", type=float, default=5.0)
    p.add_argument("-tokenIdx", dest="token_idx", type=int, default=None,
                   help="default mask position (default: center of window)")
    p.add_argument("-seq", dest="seq", type=int, default=1,
                   help="context-parallel mesh shards over the window length (ranks of "
                        "torch.distributed.run, which may share one card)")
    p.add_argument("-dtype", dest="dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("-warmup", action="store_true",
                   help="run the forward once before accepting requests")
    p.add_argument("-device", dest="device", default=default_device(),
                   help="cuda (default; PCAD_PLATFORM=cpu makes it cpu) or cpu")
    return p.parse_args(argv)


def _interrupt(signum, frame):
    raise KeyboardInterrupt


def main(argv=None):
    maybe_force_platform()
    import numpy as np
    import torch

    from plantcaduceus_tpu_torch.engine.runner import InferenceRunner
    from plantcaduceus_tpu_torch.engine.server import ScoringServer, ScoringService, follow
    from plantcaduceus_tpu_torch.utils.device import resolve_device
    from plantcaduceus_tpu_torch.utils.model_loading import load_model_and_tokenizer

    logging.basicConfig(
        force=True,
        level=logging.INFO,
        format="%(asctime)s - %(levelname)s - %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    args = parse_args(argv)
    resolve_device(args.device)  # before any work: no silent CPU run
    device = meshlib.initialize_distributed(args.device)  # this rank's device
    mesh = meshlib.cli_mesh(args.seq, "-seq")

    model, cfg, tokenizer = load_model_and_tokenizer(args.model)
    runner = InferenceRunner(
        model, cfg,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        batch_size=args.batch_size, device=device, mesh=mesh)
    axis = mesh.axis("data", "fsdp", "seq") if mesh is not None else None
    if mesh is not None and mesh.rank != 0:
        n = follow(runner, tokenizer, axis)
        logging.info("rank %d: released by the leader after %d forwards", mesh.rank, n)
        return 0
    service = ScoringService(runner, tokenizer, default_pos=args.token_idx, axis=axis)

    if args.warmup:
        logging.info("Warmup: running the scoring forward once ...")
        probs = service.masked_probs(["A" * 512] * args.batch_size)
        assert np.isfinite(probs).all()
        logging.info("Warmup done")

    server = ScoringServer(service, host=args.host, port=args.port,
                           model_name=args.model, max_batch=args.max_batch,
                           max_wait_ms=args.max_wait_ms)
    logging.info("Scoring server listening on http://%s:%d", args.host,
                 server.port)
    if axis is None:
        server.serve_forever()
        return 0
    logging.info("leader of %d ranks (mesh %s), pid %d: SIGTERM stops every rank",
                 mesh.world_size, mesh.shape, os.getpid())
    signal.signal(signal.SIGTERM, _interrupt)
    try:
        server.serve_forever()   # its shutdown releases the followers
    except KeyboardInterrupt:
        logging.info("stopped")
    if service.failed is not None:
        logging.error("stopped after a failed forward: %r", service.failed)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
