"""PlantCAD2 zero-shot evaluation tasks (the reference's src/zero-shot-eval.py).

Counterpart of ``plantcaduceus_tpu.engine.eval_tasks``, numpy only: the
scoring functions are copied, and the ROC AUC and average precision come
from ``downstream.metrics`` (sklearn's definitions, with tied scores as one
threshold) rather than from sklearn, which the GPU hosts do not carry.

Pure metric/scoring logic, decoupled from data loading so tests can feed
synthetic frames. Four tasks:

* evo_cons     — single-mask ref-base probability -> AUROC/AUPRC
                 (zero-shot-eval.py:324-369)
* motif_acc    — multi-mask token & whole-motif accuracy (:372-423)
* sv_effect    — unmasked per-position probs, boundary-window mean LLR x(-1)
                 (:181-243, 425-472)
* core_noncore — averaged true-base probability over masked motif -> AUROC
                 (:474-530)
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from plantcaduceus_tpu_torch.downstream.metrics import average_precision, roc_auc

NUCLEOTIDES = ("A", "C", "G", "T")
_IDX = {b: i for i, b in enumerate(NUCLEOTIDES)}


def true_tokens_from_seq(sequences: Sequence[str],
                         positions: Sequence[int]) -> np.ndarray:
    """Row-major [N * P] array of upper-cased true bases at the masked
    positions (zero-shot-eval.py:246-251 ordering)."""
    return np.array([s[i].upper() for s in sequences for i in positions])


def refprob_scores(sequences: Sequence[str], probs: np.ndarray,
                   token_idx: int) -> np.ndarray:
    """Probability assigned to the reference base at the masked index; 0 for
    non-ACGT bases (zero-shot-eval.py:290-298)."""
    scores = np.zeros(len(sequences))
    probs = probs.reshape(len(sequences), -1)
    for i, s in enumerate(sequences):
        b = s[token_idx].upper()
        if b in _IDX:
            scores[i] = probs[i, _IDX[b]]
    return scores


def token_accuracy(probs: np.ndarray, true_tokens: np.ndarray) -> float:
    nuc = np.array(NUCLEOTIDES)
    pred = nuc[probs.argmax(axis=1)]
    valid = np.isin(true_tokens, nuc)
    if not valid.any():
        return 0.0
    return float((pred[valid] == true_tokens[valid]).mean())


def motif_accuracy(probs: np.ndarray, true_tokens: np.ndarray,
                   motif_len: int) -> float:
    nuc = np.array(NUCLEOTIDES)
    pred = nuc[probs.argmax(axis=1)]
    assert len(true_tokens) % motif_len == 0
    pred_g = pred.reshape(-1, motif_len)
    true_g = true_tokens.reshape(-1, motif_len)
    valid = np.all(np.isin(true_g, nuc), axis=1)
    if not valid.any():
        return 0.0
    return float(np.all(pred_g[valid] == true_g[valid], axis=1).mean())


def avg_trueprob_scores(probs: np.ndarray, true_tokens: np.ndarray,
                        motif_len: int) -> np.ndarray:
    """Mean probability of the true base per example over its masked motif;
    unknown bases count 0 (zero-shot-eval.py:301-320)."""
    assert len(true_tokens) % motif_len == 0
    idxs = np.array([_IDX.get(t, -1) for t in true_tokens])
    token_probs = np.zeros(len(true_tokens))
    valid = idxs >= 0
    token_probs[valid] = probs[np.arange(len(probs))[valid], idxs[valid]]
    return token_probs.reshape(-1, motif_len).mean(axis=1)


def auroc_auprc(y_true: np.ndarray, scores: np.ndarray) -> Dict[str, float]:
    return {"auroc": roc_auc(y_true, scores),
            "auprc": average_precision(y_true, scores)}


def sv_llr_boundary(rows, ref_probs: np.ndarray, mut_probs: np.ndarray,
                    flanking: int) -> np.ndarray:
    """Mean log(mut/ref) over boundary windows, negated — the SV-effect score
    (zero-shot-eval.py:181-243). ``rows`` is an iterable of dicts with 1-based
    'left'/'right' breakpoints and 'MutSeq'."""
    L = ref_probs.shape[1]
    center0 = L // 2
    mut_left0 = list(range(center0 - flanking, center0))
    mut_right0 = list(range(center0, center0 + flanking))

    scores = np.zeros(len(rows))
    for i, row in enumerate(rows):
        left1, right1 = int(row["left"]), int(row["right"])
        left_end = left1 - 1
        left_ref = list(range(left_end - (flanking - 1), left_end + 1))
        right_start = right1 + 1
        right_ref = list(range(right_start, right_start + flanking))

        mut_full = row["MutSeq"]
        center_seq = mut_full[mut_left0[0] : mut_left0[0] + 2 * flanking]
        vals: List[float] = []
        for k in range(flanking):
            for p_ref1, p_mut0, b in (
                (left_ref[k], mut_left0[k], center_seq[k].upper()),
                (right_ref[k], mut_right0[k], center_seq[flanking + k].upper()),
            ):
                if b in _IDX:
                    j = _IDX[b]
                    r = ref_probs[i, p_ref1 - 1, j]
                    m = mut_probs[i, p_mut0, j]
                    vals.append(float(np.log(max(m, 1e-12) / max(r, 1e-12))))
                else:
                    vals.append(0.0)
        scores[i] = -float(np.mean(vals))
    return scores
