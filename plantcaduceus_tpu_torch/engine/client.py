"""Stdlib client for the scoring server (engine/server.py). No deps.

Counterpart of ``plantcaduceus_tpu.engine.client``, copied; it speaks to
the JAX package's server and to the port's alike.
"""

from __future__ import annotations

import json
import urllib.request
from typing import List, Optional, Sequence


class ScoringClient:
    def __init__(self, base_url: str = "http://127.0.0.1:8142",
                 timeout: float = 300.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _post(self, path: str, payload: dict) -> dict:
        req = urllib.request.Request(
            self.base_url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read())

    def healthz(self) -> dict:
        with urllib.request.urlopen(self.base_url + "/healthz",
                                    timeout=self.timeout) as r:
            return json.loads(r.read())

    def score(self, sequences: Sequence[str], refs: Sequence[str],
              alts: Sequence[str], pos: Optional[int] = None) -> List[float]:
        items = [{"sequence": s, "ref": r, "alt": a}
                 for s, r, a in zip(sequences, refs, alts)]
        return self._post("/score", {"items": items, "pos": pos})["scores"]

    def masked_probs(self, sequences: Sequence[str],
                     pos: Optional[int] = None) -> List[List[float]]:
        return self._post("/masked_probs",
                          {"sequences": list(sequences), "pos": pos})["probs"]

    def embed(self, sequences: Sequence[str],
              pos: Optional[int] = None) -> List[List[float]]:
        return self._post("/embed", {"sequences": list(sequences),
                                     "pos": pos})["embeddings"]
