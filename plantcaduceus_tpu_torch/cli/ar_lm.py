"""CLI: autoregressive Mamba LM sanity harness, on the GPU.

Counterpart of ``plantcaduceus_tpu.cli.ar_lm``, with its flags, defaults
and checkpoint format, plus ``--device``:

  train   — fit an AR Mamba on tokenized data, reporting bits/dim and
            tokens/s. Data: ``--data synthetic`` (procedural textures
            quantised to --levels tokens) or ``--data FILE`` (any file,
            byte-level LM over 256 tokens). bf16 compute, float32 master
            weights, AdamW with optax ``adamw``'s defaults.
  sample  — greedy or temperature/top-k generation from a saved checkpoint
            through the O(1) recurrent decode; prints one JSON line.

Checkpoints are ``.npz`` files of the JAX pytree (keys such as
``blocks/in_proj_x``, the training flags as JSON under ``__config__``):
each package's ``sample`` reads the other's.

    python -m plantcaduceus_tpu_torch.cli.ar_lm train --output ar_lm.npz
    python -m plantcaduceus_tpu_torch.cli.ar_lm sample ar_lm.npz --n-new 64

Runs on CUDA unless ``--device cpu`` is given, and fails when CUDA is asked
for and absent.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

import numpy as np

from plantcaduceus_tpu_torch.parallel.mesh import refuse_multi_rank
from plantcaduceus_tpu_torch.utils.platform import default_device, maybe_force_platform

log = logging.getLogger(__name__)


def _synthetic_batch(rng: np.random.Generator, batch: int, side: int,
                     levels: int) -> np.ndarray:
    """Procedural [batch, side*side] token images: random oriented
    sinusoidal gratings, quantised to ``levels`` bins (the JAX CLI's data,
    draw for draw)."""
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32) / side
    imgs = np.empty((batch, side, side), np.float32)
    for i in range(batch):
        th = rng.uniform(0, np.pi)
        freq = rng.uniform(1.0, 3.0)
        phase = rng.uniform(0, 2 * np.pi)
        g = np.sin(2 * np.pi * freq * (np.cos(th) * xx + np.sin(th) * yy)
                   + phase)
        imgs[i] = 0.5 * (g + 1)
    toks = np.clip((imgs * levels).astype(np.int32), 0, levels - 1)
    return toks.reshape(batch, side * side)


def _file_batches(path: Path, batch: int, seq_len: int,
                  rng: np.random.Generator):
    data = np.frombuffer(path.read_bytes(), np.uint8)
    if data.size < seq_len + 1:
        raise SystemExit(f"{path} too small for seq_len={seq_len}")
    while True:
        starts = rng.integers(0, data.size - seq_len, size=batch)
        yield np.stack([data[s: s + seq_len] for s in starts]).astype(np.int32)


def _config(targs: dict):
    from plantcaduceus_tpu_torch.models.mamba_lm import MambaLmConfig

    synthetic = targs["data"] == "synthetic"
    return MambaLmConfig(d_model=targs["d_model"], n_layer=targs["n_layer"],
                         vocab_size=targs["levels"] if synthetic else 256,
                         d_state=targs["d_state"],
                         ssm_variant=targs.get("ssm_variant", "mamba1"),
                         head_dim=targs.get("head_dim", 64),
                         chunk_size=targs.get("chunk_size", 64))


def train(args):
    import torch

    from plantcaduceus_tpu_torch.compat.params import to_jax_params
    from plantcaduceus_tpu_torch.models import mamba_lm
    from plantcaduceus_tpu_torch.train.optimizer import AdamW, make_schedule
    from plantcaduceus_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    synthetic = args.data == "synthetic"
    vocab = args.levels if synthetic else 256
    seq_len = args.side * args.side if synthetic else args.seq_len
    if args.ssm_variant == "mamba2":
        eff = min(args.chunk_size, seq_len)
        if seq_len % eff:
            raise SystemExit(
                f"--seq-len {seq_len} is not divisible by the effective "
                f"--chunk-size {eff} (mamba2 SSD chunking)")
    cfg = _config(vars(args))
    model = mamba_lm.MambaLm(cfg, mamba_lm.init_params(cfg, seed=args.seed))
    model = model.to(dev).requires_grad_()
    params = dict(model.named_parameters())
    # optax.adamw(lr)'s defaults: b1 0.9, b2 0.999, eps 1e-8, decay 1e-4 on
    # every leaf, no clipping
    opt = AdamW(make_schedule("constant_with_warmup", args.lr), weight_decay=1e-4)
    opt_state = opt.init(params)
    rng = np.random.default_rng(args.seed)
    gen = (None if synthetic
           else _file_batches(Path(args.data), args.batch, seq_len, rng))

    t0 = time.time()
    for it in range(1, args.steps + 1):
        ids = (_synthetic_batch(rng, args.batch, args.side, args.levels)
               if synthetic else next(gen))
        loss = mamba_lm.nll_loss(model, torch.from_numpy(ids).to(dev, torch.long))
        grads = torch.autograd.grad(loss, list(params.values()))
        opt.update(dict(zip(params, grads)), opt_state, params)
        if it % args.log_every == 0 or it == args.steps:
            bpd = float(mamba_lm.bits_per_dim(loss.item()))
            tok_s = it * args.batch * seq_len / (time.time() - t0)
            log.info("step %d  bits/dim %.4f  (uniform %.2f)  %.0f tok/s",
                     it, bpd, np.log2(vocab), tok_s)

    out = Path(args.output)
    tree = to_jax_params(model)
    flat = {k: v for k, v in tree.items() if k != "blocks"}
    flat.update({f"blocks/{k}": v for k, v in tree["blocks"].items()})
    np.savez_compressed(out, __config__=json.dumps(vars(args)), **flat)
    log.info("Saved checkpoint to %s", out)


def _load_ckpt(path: Path):
    """(training flags, nested pytree of numpy arrays) from a checkpoint of
    either package."""
    z = np.load(path, allow_pickle=False)
    args = json.loads(str(z["__config__"]))
    params: dict = {}
    for key in z.files:
        if key == "__config__":
            continue
        node = params
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = z[key]
    return args, params


def sample(args):
    import torch

    from plantcaduceus_tpu_torch.compat.params import mamba_lm_from_jax_params
    from plantcaduceus_tpu_torch.models import mamba_lm
    from plantcaduceus_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    targs, params = _load_ckpt(Path(args.checkpoint))
    cfg = _config(targs)
    model = mamba_lm_from_jax_params(params, cfg).to(dev)
    rng = np.random.default_rng(args.seed)
    if targs["data"] == "synthetic":
        prompt = _synthetic_batch(rng, 1, targs["side"],
                                  targs["levels"])[:, : args.prompt_len]
    else:
        prompt = rng.integers(0, cfg.vocab_size, size=(1, args.prompt_len))
    gen = (None if args.temperature == 0
           else torch.Generator(device=dev).manual_seed(args.seed))
    toks = mamba_lm.generate(model, torch.from_numpy(np.asarray(prompt)).to(dev, torch.long),
                             args.n_new, generator=gen, temperature=args.temperature,
                             top_k=args.top_k)
    print(json.dumps({"prompt": prompt[0].tolist(),
                      "generated": toks[0].cpu().tolist()}))


def main(argv=None):
    maybe_force_platform()
    refuse_multi_rank("cli.ar_lm")
    logging.basicConfig(force=True, level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    tr = sub.add_parser("train")
    tr.add_argument("--data", default="synthetic",
                    help="'synthetic' or a path to any file (byte-level LM)")
    tr.add_argument("--output", default="ar_lm.npz")
    tr.add_argument("--steps", type=int, default=200)
    tr.add_argument("--batch", type=int, default=32)
    tr.add_argument("--side", type=int, default=16,
                    help="synthetic image side (seq_len = side^2)")
    tr.add_argument("--levels", type=int, default=8,
                    help="synthetic quantisation levels (vocab)")
    tr.add_argument("--seq-len", type=int, default=256,
                    help="sequence length for file data")
    tr.add_argument("--d-model", type=int, default=128)
    tr.add_argument("--n-layer", type=int, default=4)
    tr.add_argument("--d-state", type=int, default=16,
                    help="on the GPU the Mamba-1 scan kernel takes 4, 8, 16 or 32")
    tr.add_argument("--ssm-variant", choices=("mamba1", "mamba2"),
                    default="mamba1",
                    help="mamba2 = SSD; the CUDA SSD kernels run at head_dim = "
                         "d_state = chunk = 128, ssd_chunked elsewhere")
    tr.add_argument("--head-dim", type=int, default=64,
                    help="mamba2 head size (d_inner %% head_dim == 0)")
    tr.add_argument("--chunk-size", type=int, default=64,
                    help="mamba2 SSD chunk (seq_len %% chunk == 0)")
    tr.add_argument("--lr", type=float, default=3e-3)
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--log-every", type=int, default=20)
    tr.add_argument("--device", default=default_device(),
                    help="cuda (default; PCAD_PLATFORM=cpu makes it cpu) or cpu")

    sm = sub.add_parser("sample")
    sm.add_argument("checkpoint")
    sm.add_argument("--prompt-len", type=int, default=32)
    sm.add_argument("--n-new", type=int, default=64)
    sm.add_argument("--temperature", type=float, default=0.0)
    sm.add_argument("--top-k", type=int, default=None)
    sm.add_argument("--seed", type=int, default=0)
    sm.add_argument("--device", default=default_device(),
                    help="cuda (default; PCAD_PLATFORM=cpu makes it cpu) or cpu")

    args = p.parse_args(argv)
    (train if args.cmd == "train" else sample)(args)


if __name__ == "__main__":
    main()
