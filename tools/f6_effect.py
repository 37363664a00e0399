#!/usr/bin/env python3
"""How much the order of the bidirectional mixer's direction sum moves bf16
zero-shot scores, on one CUDA card.

    python3 tools/f6_effect.py [--windows N] [--seed S]

Builds l20 with seeded random weights (``load_model_and_tokenizer("l20")``),
masks the centre (position 255) of N seeded random 512-bp windows and
scores every ref/alt pair of the four nucleotides there (log(P_alt /
P_ref), the zero-shot contract) three ways, batch 128, kernels on:

* bf16 with the two direction outputs summed in their own dtype, then cast
  to float32 and gated (the port's order, JAX's:
  ``ops/cuda_mixer._sum_gate``);
* bf16 with each direction cast to float32 before the sum (the order the
  port had before);
* fp32 (either order: they agree in float32).

Prints the card's name and power limit, then one JSON line: the largest
and the median |difference| of the scores between the two bf16 orders, and
each bf16 order's largest and median |difference| from the fp32 scores.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.nn.functional as F

    from plantcaduceus_tpu_torch.engine.runner import InferenceRunner
    from plantcaduceus_tpu_torch.engine.zero_shot import mask_and_encode
    from plantcaduceus_tpu_torch.io.tokenizer import nucleotide_ids
    from plantcaduceus_tpu_torch.ops import cuda_build, cuda_mixer
    from plantcaduceus_tpu_torch.utils.model_loading import load_model_and_tokenizer

    if not torch.cuda.is_available():
        sys.exit("f6_effect: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    cuda_build.build_all()

    model, cfg, tok = load_model_and_tokenizer("l20", seed=args.seed)
    rng = np.random.default_rng(args.seed)
    seqs = ["".join(rng.choice(list("ACGT"), 512)) for _ in range(args.windows)]
    pos = 255
    ids = mask_and_encode(seqs, tok, pos)
    nuc = list(nucleotide_ids(tok))

    def log_probs(dtype):
        runner = InferenceRunner(model, cfg, dtype=dtype, batch_size=128, device="cuda")
        return np.log(runner.masked_probs(ids, nuc, pos, progress=False).astype(np.float64))

    def scores(lp):  # every ordered (ref, alt) pair, ref != alt
        return np.stack([lp[:, a] - lp[:, r] for r in range(4) for a in range(4) if a != r], 1)

    def float32_sum(ys, z, dtype):
        y_sum = ys[0].float() + ys[1].float()
        return y_sum, (y_sum * F.silu(z.float())).to(dtype)

    got = {"fp32": scores(log_probs(torch.float32)),
           "bf16 (sum in bf16)": scores(log_probs(torch.bfloat16))}
    own = cuda_mixer._sum_gate
    cuda_mixer._sum_gate = float32_sum
    try:
        got["bf16 (sum in fp32)"] = scores(log_probs(torch.bfloat16))
    finally:
        cuda_mixer._sum_gate = own

    def gap(a, b):
        d = np.abs(got[a] - got[b])
        return {"max": float(d.max()), "median": float(np.median(d))}

    print(json.dumps({
        "windows": args.windows, "scores": int(got["fp32"].size),
        "bf16 orders": gap("bf16 (sum in bf16)", "bf16 (sum in fp32)"),
        "bf16 (sum in bf16) vs fp32": gap("bf16 (sum in bf16)", "fp32"),
        "bf16 (sum in fp32) vs fp32": gap("bf16 (sum in fp32)", "fp32")}))


if __name__ == "__main__":
    main()
