"""Planted-structure convergence check: the pre-training recipe LEARNS.

Counterpart of ``plantcaduceus_tpu.train.convergence``. A corpus whose
structure is known by construction:

* a fixed UPPERCASE motif at random positions in iid background — after
  training, masked positions inside the motif must be predicted far above
  chance while background positions stay at chance;
* a LOWERCASE tandem-repeat tract (soft-masked) whose content is also
  predictable — the soft-mask loss weight must measurably change how fast
  that region is learned, relative to weight 1.0.

Driven through the port's real pipeline: ``PretrainDataset`` (lowercase →
loss weights), ``MlmCollator`` (15% dynamic masking), ``make_train_step``
(weighted CE; on the card K2's residual variant and K3) and ``AdamW`` with
optax ``adamw``'s defaults. ``planted_corpus`` draws from numpy exactly as
the JAX package does, so both packages train and probe on the same strings.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

MOTIF = "GATTACAG"          # planted uppercase motif
REPEAT_UNIT = "acggta"      # lowercase tandem-repeat unit (soft-masked)
REPEAT_SPAN = (100, 124)    # repeat tract [start, end) within each window


def planted_corpus(n: int, window: int = 128, seed: int = 0,
                   motifs_per_seq: int = 2) -> List[str]:
    """Sequences of iid ACGT background + ``motifs_per_seq`` planted copies of
    MOTIF (uppercase, outside the repeat tract) + one lowercase tandem
    REPEAT_UNIT tract at REPEAT_SPAN (phase-locked, so its content is
    predictable from position context alone)."""
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    rs, re = REPEAT_SPAN
    if not (re <= window and rs > motifs_per_seq * (len(MOTIF) + 2)):
        raise ValueError(f"window {window} cannot hold the repeat tract {REPEAT_SPAN} "
                         f"after {motifs_per_seq} motifs")
    out = []
    repeat = (REPEAT_UNIT * ((re - rs) // len(REPEAT_UNIT) + 1))[: re - rs]
    for _ in range(n):
        s = list(rng.choice(bases, window))
        starts: List[int] = []    # non-overlapping motif sites in [0, rs - len(MOTIF))
        while len(starts) < motifs_per_seq:
            c = int(rng.integers(0, rs - len(MOTIF)))
            if all(abs(c - p) >= len(MOTIF) for p in starts):
                starts.append(c)
        for c in starts:
            s[c:c + len(MOTIF)] = list(MOTIF)
        s[rs:re] = list(repeat)
        out.append("".join(s))
    return out


def motif_starts(seq: str) -> List[int]:
    out, i = [], seq.find(MOTIF)
    while i != -1:
        out.append(i)
        i = seq.find(MOTIF, i + 1)
    return out


def train_planted(cfg, steps: int, batch: int = 16, window: int = 128,
                  soft_masked_weight: float = 0.1, seed: int = 0,
                  n_corpus: int = 1024, dtype=torch.float32, lr: float = 3e-3,
                  loss_every: int = 25, device="cuda") -> Dict:
    """Pre-train ``cfg`` on the planted corpus through the real pipeline:
    optax ``adamw`` (weight decay 1e-4 on every tensor, no clipping) with a
    20-step warmup to a constant ``lr``, no remat, on ``device`` (the card
    unless the CPU is asked for).

    Returns {"losses": [(step, loss), ...], "final_loss": float, "state":
    TrainState, "corpus": [...], ...}; evaluate what was learned with
    :func:`evaluate_structure`."""
    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.train import step as step_lib
    from plantcaduceus_tpu_torch.train.data import PretrainDataset
    from plantcaduceus_tpu_torch.train.optimizer import AdamW, make_schedule

    corpus = planted_corpus(n_corpus, window, seed=seed + 100)
    tok = DnaTokenizer()
    data = PretrainDataset(corpus, tok, batch, soft_masked_weight=soft_masked_weight,
                           seed=seed)
    model = Caduceus(cfg, init_params(cfg, seed=seed))
    opt = AdamW(make_schedule("constant_with_warmup", lr, 20), weight_decay=1e-4)
    init_state, train_step, _ = step_lib.make_train_step(cfg, opt, model, dtype=dtype,
                                                         remat=False, device=device)
    state = init_state()

    losses: List[Tuple[int, float]] = []
    for step, batch_np in zip(range(steps), data):
        state, m = train_step(state, batch_np)
        if (step + 1) % loss_every == 0 or step == steps - 1:
            losses.append((step + 1, float(m["loss"])))
    return {"losses": losses, "final_loss": losses[-1][1], "state": state,
            "corpus": corpus, "tokenizer": tok, "cfg": cfg, "dtype": dtype, "seed": seed}


def evaluate_structure(run: Dict, n_eval: int = 128, seed: int = 1,
                       held_out: bool = True) -> Dict[str, float]:
    """Probe what the trained model knows, one masked position per probe:

    * motif_accuracy      — masked base INSIDE a planted motif
    * background_accuracy — masked iid background base (chance = 0.25)
    * repeat_loss         — mean NLL of masked bases inside the lowercase
                            tandem tract

    ``held_out=True`` probes fresh sequences from the same generator with a
    disjoint seed, so motif accuracy measures the planted rule, not recall
    of the training corpus."""
    from plantcaduceus_tpu_torch.io.tokenizer import nucleotide_ids
    from plantcaduceus_tpu_torch.models.caduceus import forward

    tok, model = run["tokenizer"], run["state"].model
    rng = np.random.default_rng(seed)
    if held_out:
        # train_planted draws its corpus at seed+100; +987654 is disjoint.
        corpus = planted_corpus(n_eval, len(run["corpus"][0]),
                                seed=run.get("seed", 0) + 987654)
    else:
        corpus = run["corpus"][:n_eval]
    rs, re = REPEAT_SPAN

    nuc = nucleotide_ids(tok)
    rows, pos, true_b, kind = [], [], [], []
    for s in corpus:
        ms = motif_starts(s)
        if not ms:
            continue
        # motif-interior position (>= 2 in, so context identifies it)
        c = ms[int(rng.integers(len(ms)))]
        j = c + int(rng.integers(2, len(MOTIF)))
        rows.append(s), pos.append(j), true_b.append(s[j]), kind.append("m")
        # background position away from motifs and the repeat tract
        while True:
            j = int(rng.integers(0, rs))
            if all(not (m <= j < m + len(MOTIF)) for m in ms):
                break
        rows.append(s), pos.append(j), true_b.append(s[j]), kind.append("b")
        # repeat-tract position (leave the unit's phase inferable)
        j = int(rng.integers(rs + len(REPEAT_UNIT), re))
        rows.append(s), pos.append(j), true_b.append(s[j].upper()), kind.append("r")

    ids = tok.encode_batch(rows)
    ids[np.arange(len(pos)), pos] = tok.mask_token_id
    device = next(model.parameters()).device
    with torch.inference_mode():
        logits = forward(model, torch.from_numpy(ids).long().to(device),
                         dtype=run["dtype"])["logits"]
        at = logits[torch.arange(len(pos), device=device), torch.tensor(pos, device=device)]
        at = at[:, nuc].float().cpu().numpy()                  # [n, 4] ACGT order
    pred = np.asarray(list("ACGT"))[at.argmax(axis=1)]
    mx = at.max(1, keepdims=True)
    logp = at - mx - np.log(np.exp(at - mx).sum(1, keepdims=True))
    tidx = np.array(["ACGT".index(b) for b in true_b])
    nll = -logp[np.arange(len(tidx)), tidx]

    kind = np.array(kind)
    true_arr = np.array(true_b)
    res = {"held_out": held_out}
    for k, name in (("m", "motif"), ("b", "background"), ("r", "repeat")):
        sel = kind == k
        res[f"{name}_accuracy"] = float((pred[sel] == true_arr[sel]).mean())
        res[f"{name}_loss"] = float(nll[sel].mean())
    return res
