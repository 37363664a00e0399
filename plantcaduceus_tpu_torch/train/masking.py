"""MLM masking collator + soft-mask loss weights (numpy, host side).

A copy of ``plantcaduceus_tpu.train.masking`` over the port's tokenizer,
so the same seed gives the same batches byte for byte:

* dynamic 15% masking with the HF DataCollatorForLanguageModeling policy
  (80% -> [MASK], 10% -> random token, 10% -> unchanged; labels = -100 on
  unmasked positions) — the collator of src/HF_pre_train.py:58-81/473-476;
* per-position loss weights 1.0, down-weighted where the source base was
  lowercase (soft-masked / repeat regions) — src/HF_pre_train.py:424-437.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer


def soft_mask_weights(sequences: Sequence[str], weight: float) -> np.ndarray:
    """[B, L] float32: 1.0 per position, ``weight`` where lowercase."""
    arr = np.frombuffer("".join(sequences).encode("latin-1"), np.uint8)
    arr = arr.reshape(len(sequences), -1)
    lower = (arr >= ord("a")) & (arr <= ord("z"))
    w = np.ones(arr.shape, np.float32)
    w[lower] = weight
    return w


def random_token_ids(tokenizer: DnaTokenizer) -> np.ndarray:
    """Candidate ids for the 10% random-replacement branch: the non-special
    vocabulary (a/c/g/t/n)."""
    return np.asarray(
        [i for tok, i in tokenizer.get_vocab().items() if len(tok) == 1],
        np.int32,
    )


class MlmCollator:
    """Turns raw token-id batches into (input_ids, labels, loss_weights)."""

    def __init__(
        self,
        tokenizer: DnaTokenizer,
        mlm_probability: float = 0.15,
        mask_replace_prob: float = 0.8,
        random_replace_prob: float = 0.1,
        seed: int = 0,
    ):
        self.tokenizer = tokenizer
        self.mlm_probability = mlm_probability
        self.mask_replace_prob = mask_replace_prob
        self.random_replace_prob = random_replace_prob
        self.rng = np.random.default_rng(seed)
        self._random_ids = random_token_ids(tokenizer)
        self._special = np.asarray(
            [i for tok, i in tokenizer.get_vocab().items() if len(tok) > 1],
            np.int32,
        )

    def __call__(
        self,
        input_ids: np.ndarray,
        loss_weights: Optional[np.ndarray] = None,
        rng: Optional[np.random.Generator] = None,
    ) -> Dict[str, np.ndarray]:
        """``rng`` overrides the collator's stateful generator — pass a
        step-keyed generator (``default_rng([seed, step])``) to make the
        batch a pure function of the step, the property checkpoint
        autoresume needs to reproduce an uninterrupted run exactly."""
        rng = rng if rng is not None else self.rng
        ids = np.array(input_ids, np.int32, copy=True)
        labels = np.full(ids.shape, -100, np.int64)

        special = np.isin(ids, self._special)
        probs = np.full(ids.shape, self.mlm_probability)
        probs[special] = 0.0
        masked = rng.random(ids.shape) < probs
        labels[masked] = ids[masked]

        # 80% -> [MASK]
        replace = masked & (rng.random(ids.shape) < self.mask_replace_prob)
        ids[replace] = self.tokenizer.mask_token_id
        # 10% (of masked) -> random token
        rnd_frac = self.random_replace_prob / max(1e-9, 1 - self.mask_replace_prob)
        rnd = masked & ~replace & (rng.random(ids.shape) < rnd_frac)
        ids[rnd] = rng.choice(self._random_ids, size=int(rnd.sum()))

        batch = {"input_ids": ids, "labels": labels}
        if loss_weights is not None:
            batch["loss_weights"] = np.asarray(loss_weights, np.float32)
        return batch
