"""Gradient-boosted-tree classifier over either backend.

Counterpart of ``plantcaduceus_tpu.downstream.gbm``, with its dispatch: the
reference hard-depends on the xgboost wheel (src/train_XGBoost.py:118:
XGBClassifier(n_estimators=1000, max_depth=6, lr=0.1)). xgboost is used when
installed; otherwise sklearn's HistGradientBoostingClassifier fits, imported
only when a model is built. Neither is on the GPU hosts: there a released
XGBoost JSON classifier still loads and predicts through the numpy
``XgbJsonPredictor``, and a fit raises sklearn's ImportError, as the JAX
package does on such a host. The sklearn backend saves a pickle of
``{"backend": "sklearn", "model": ...}``, the JAX package's layout, so each
package loads the other's model file.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

try:
    import xgboost as _xgb

    HAVE_XGBOOST = True
except ImportError:
    _xgb = None
    HAVE_XGBOOST = False


class GbmClassifier:
    """fit / predict_proba / save / load over either backend."""

    def __init__(self, n_estimators: int = 1000, max_depth: int = 6,
                 learning_rate: float = 0.1, random_state: int = 42,
                 backend: str = "auto"):
        if backend == "auto":
            backend = "xgboost" if HAVE_XGBOOST else "sklearn"
        self.backend = backend
        if backend == "xgboost":
            if not HAVE_XGBOOST:
                raise ImportError("xgboost is not installed")
            self._model = _xgb.XGBClassifier(
                n_estimators=n_estimators, max_depth=max_depth,
                learning_rate=learning_rate, random_state=random_state,
                n_jobs=-1)
        elif backend == "sklearn":
            from sklearn.ensemble import HistGradientBoostingClassifier

            self._model = HistGradientBoostingClassifier(
                max_iter=n_estimators, max_depth=max_depth,
                learning_rate=learning_rate, random_state=random_state,
                early_stopping=True)
        else:
            raise ValueError(f"unknown backend {backend!r}")

    def fit(self, X, y, eval_set=None):
        if self.backend == "xgb_json":
            raise RuntimeError(
                "this model came from an xgboost JSON artifact via the "
                "numpy evaluator — inference-only; construct a fresh "
                "GbmClassifier to train")
        if self.backend == "xgboost":
            self._model.fit(X, y, eval_set=eval_set or None, verbose=False)
        else:
            self._model.fit(X, y)
        return self

    def predict_proba(self, X) -> np.ndarray:
        return self._model.predict_proba(X)

    def save(self, path) -> None:
        path = Path(path)
        if self.backend == "xgb_json":
            raise RuntimeError("xgb_json models are read-only artifacts; "
                               "the source JSON file IS the saved model")
        if self.backend == "xgboost":
            self._model.save_model(str(path))
        else:
            with open(path, "wb") as f:
                pickle.dump({"backend": "sklearn", "model": self._model}, f)

    @classmethod
    def load(cls, path) -> "GbmClassifier":
        path = Path(path)
        with open(path, "rb") as f:
            head = f.read(2)
        obj = cls.__new__(cls)
        if head[:1] == b"\x80":  # pickle protocol marker -> sklearn backend
            with open(path, "rb") as f:
                data = pickle.load(f)
            obj.backend = data["backend"]
            obj._model = data["model"]
            return obj
        # an xgboost JSON/UBJ artifact (the reference's released
        # classifiers/*.json files among them)
        if not HAVE_XGBOOST:
            # Without the wheel the JSON classifiers still load and predict
            # through the numpy evaluator; fit() needs a real backend.
            from plantcaduceus_tpu_torch.downstream.xgb_json import XgbJsonPredictor

            obj.backend = "xgb_json"
            obj._model = XgbJsonPredictor.load(path)
            return obj
        obj.backend = "xgboost"
        obj._model = _xgb.XGBClassifier()
        obj._model.load_model(str(path))
        return obj
