"""Pure-numpy inference for XGBoost JSON model artifacts.

Counterpart of ``plantcaduceus_tpu.downstream.xgb_json``, copied: the
reference releases its trained TIS/TTS/splice classifiers as XGBoost JSON
files (README "Predict with XGBoost"; saved by src/train_XGBoost.py:129),
and the GPU hosts carry no xgboost wheel. This evaluates them from the
documented JSON schema (xgboost doc/model.schema:
learner/gradient_booster/model/trees): vectorised level-by-level tree
traversal, margins summed per ``tree_info`` class, and the objective's
inverse link. gbtree models with ``binary:logistic``,
``multi:softprob``/``softmax`` and identity-link regression objectives.
No training: fitting stays with ``downstream.gbm``'s backends.

Schema facts this relies on:
* per-tree arrays ``left_children``/``right_children`` (-1 at leaves),
  ``split_indices``, ``split_conditions`` (split threshold at internal
  nodes, LEAF VALUE at leaves), ``default_left`` (missing-value routing);
* decision rule: go left iff ``x[split_index] < split_condition``;
  NaN routes by ``default_left``;
* ``tree_info[t]`` is the class whose margin tree ``t`` contributes to;
* ``learner_model_param.base_score`` is stored on the PROBABILITY scale for
  ``binary:``, ``count:`` and ``rank:`` objectives and is converted to a
  margin (logit) before the tree sum; identity for the others.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


class XgbJsonPredictor:
    """Numpy evaluator over a parsed xgboost JSON ``learner``."""

    def __init__(self, learner: dict):
        gb = learner["gradient_booster"]
        if gb.get("name", "gbtree") != "gbtree":
            raise NotImplementedError(
                f"booster {gb.get('name')!r}: only gbtree is supported")
        model = gb["model"]
        self.objective = learner["objective"]["name"]
        lmp = learner["learner_model_param"]
        self.num_class = max(int(lmp.get("num_class", "0") or 0), 1)
        self.num_feature = int(lmp.get("num_feature", "0") or 0)
        base = float(lmp.get("base_score", "0.5") or 0.5)
        if self.objective.startswith(("binary:", "count:", "rank:")):
            # stored on the probability scale; margin domain needs logit
            base = min(max(base, 1e-16), 1 - 1e-16)
            self.base_margin = float(np.log(base / (1.0 - base)))
        else:
            self.base_margin = base
        self.tree_info = np.asarray(model.get("tree_info", []), np.int64)
        self.trees = []
        for t in model["trees"]:
            # Categorical splits (split_type=1 with a categories bitset)
            # would silently evaluate as numeric thresholds here — refuse
            # rather than return wrong probabilities.
            if (np.any(np.asarray(t.get("split_type", []), np.int64) != 0)
                    or len(t.get("categories", []))):
                raise NotImplementedError(
                    "categorical splits are not supported by the numpy "
                    "evaluator; score this artifact with the xgboost wheel")
            self.trees.append({
                "left": np.asarray(t["left_children"], np.int64),
                "right": np.asarray(t["right_children"], np.int64),
                "feat": np.asarray(t["split_indices"], np.int64),
                "cond": np.asarray(t["split_conditions"], np.float64),
                "default_left": np.asarray(t["default_left"],
                                           np.int64).astype(bool),
            })
        if len(self.trees) != len(self.tree_info):
            raise ValueError("tree_info/trees length mismatch")

    # -- loading -------------------------------------------------------------

    @classmethod
    def load(cls, path) -> "XgbJsonPredictor":
        raw = Path(path).read_bytes()
        if raw[:1] != b"{":
            raise ValueError(
                f"{path}: not an xgboost JSON artifact (UBJSON/binary "
                "formats need the xgboost wheel)")
        doc = json.loads(raw)
        if "learner" not in doc:
            raise ValueError(f"{path}: no 'learner' key — not an xgboost "
                             "JSON model")
        return cls(doc["learner"])

    # -- inference -----------------------------------------------------------

    def _tree_values(self, tree: dict, X: np.ndarray) -> np.ndarray:
        """Leaf value per row: vectorised traversal (all rows advance one
        level per iteration; depth<=max_depth so the loop is short)."""
        node = np.zeros(X.shape[0], np.int64)
        left, right = tree["left"], tree["right"]
        feat, cond, dleft = tree["feat"], tree["cond"], tree["default_left"]
        active = left[node] != -1
        while active.any():
            idx = node[active]
            x = X[active, feat[idx]]
            go_left = np.where(np.isnan(x), dleft[idx], x < cond[idx])
            node[active] = np.where(go_left, left[idx], right[idx])
            active = left[node] != -1
        return cond[node]

    def margin(self, X: np.ndarray) -> np.ndarray:
        """Raw margin [n, num_class] (num_class=1 for binary/regression)."""
        X = np.asarray(X, np.float64)
        if X.ndim != 2:
            raise ValueError(f"X must be [n, features], got {X.shape}")
        out = np.full((X.shape[0], self.num_class), self.base_margin)
        for info, tree in zip(self.tree_info, self.trees):
            out[:, info] += self._tree_values(tree, X)
        return out

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        """[n, 2] for binary, [n, num_class] for multi — the XGBClassifier
        contract the reference's prediction CLI consumes
        (src/predict_XGBoost.py predict_proba[:, 1])."""
        m = self.margin(X)
        if self.objective.startswith("binary:"):
            p1 = 1.0 / (1.0 + np.exp(-m[:, 0]))
            return np.stack([1.0 - p1, p1], axis=1)
        if self.objective.startswith("multi:"):
            e = np.exp(m - m.max(axis=1, keepdims=True))
            return e / e.sum(axis=1, keepdims=True)
        raise NotImplementedError(
            f"predict_proba undefined for objective {self.objective!r}")

    def predict(self, X: np.ndarray) -> np.ndarray:
        m = self.margin(X)
        if self.objective.startswith("binary:"):
            return (m[:, 0] > 0).astype(np.int64)
        if self.objective.startswith("multi:"):
            return m.argmax(axis=1)
        return m[:, 0]  # identity-link regression
