"""Persistent scoring server on the GPU: the serving mode.

Counterpart of ``plantcaduceus_tpu.engine.server`` over the port's runner,
tokenizer and zero-shot helpers. A resident process builds the model once
and then serves requests, with nothing beyond the stdlib:

* ``ScoringService`` — owns an InferenceRunner + tokenizer and exposes the
  three inference primitives (variant scores, masked nucleotide probs,
  RC-averaged center embeddings).
* ``MicroBatcher`` — cross-request batching: concurrent requests are queued
  and drained by a single worker thread into one runner call (the runner
  pads every group to its batch size, as the JAX package's fixed-shape
  runner does). The one worker thread is the only one that touches the
  card: requests are validated on their own threads without a tensor, and
  ``torch.inference_mode`` (thread-local) is entered inside the runner.
* ``ScoringServer`` — a ThreadingHTTPServer with a tiny JSON API:

      GET  /healthz               -> {"status": "ok", "model": ...}
      POST /score                 {"items": [{"sequence","ref","alt"}...],
                                   "pos": 255?}         -> {"scores": [...]}
      POST /masked_probs          {"sequences": [...], "pos": 255?}
                                  -> {"probs": [[4]...], "nucleotides": [...]}
      POST /embed                 {"sequences": [...], "pos": 255?}
                                                        -> {"embeddings": ...}

  400 for bad input, 500 for a runtime failure; a one-rank server's worker
  survives both (several ranks: below).

Over several ranks (``cli.serve`` under ``torch.distributed.run``; JAX
serves ``-seq`` over a seq mesh) rank 0 is the leader: it alone binds the
port and runs the batcher. Its service (``axis``: every rank of the mesh)
broadcasts each coalesced forward's kind, shape, mask position and ids to
the other ranks before running its part; each follower loops in
:func:`follow`, running the same sharded forward, until the leader's
batcher thread, on shutdown, broadcasts the stop. Only that thread issues
collectives, always in one order. Whatever a forward would refuse (a mask
position outside the window, a window that the seq axis does not divide)
is refused before it is broadcast. An input error that a forward still
raises, it raises on every rank at the same point: the follower logs it
and goes on, and the leader answers it. Any other failure of a forward
(out of memory, a lost peer) may leave the ranks' collectives out of step:
a follower then exits, and a leader stops serving and its ``cli.serve``
exits non-zero, so ``torch.distributed.run`` ends every rank at once
rather than leaving them waiting on a collective.

Client side: ``client.ScoringClient`` (urllib, no deps).
"""

from __future__ import annotations

import json
import logging
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence

import numpy as np
import torch

from plantcaduceus_tpu_torch.engine.runner import InferenceRunner
from plantcaduceus_tpu_torch.engine.zero_shot import (NUCLEOTIDES, log_ratio_scores,
                                                      mask_and_encode)
from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer, nucleotide_ids
from plantcaduceus_tpu_torch.parallel.collectives import broadcast

log = logging.getLogger(__name__)

# The forwards a leader broadcasts (the header's first entry), and the stop.
STOP, MASKED_PROBS, EMBED = 0, 1, 2
# What a forward raises for its input: on every rank alike, at one point.
INPUT_ERRORS = (KeyError, IndexError, TypeError, ValueError)


def _forward(runner: InferenceRunner, nuc_ids, kind: int, ids: np.ndarray,
             pos: int) -> np.ndarray:
    if kind == MASKED_PROBS:
        return runner.masked_probs(ids, nuc_ids, pos, progress=False)
    return runner.center_embeddings(ids, pos, progress=False)


def _announce(axis, device, kind: int, ids: Optional[np.ndarray] = None, pos: int = 0) -> None:
    """The leader's broadcast: the header [kind, rows, length, pos], then
    the ids (none after the stop)."""
    rows, length = ids.shape if ids is not None else (0, 0)
    broadcast(torch.tensor([kind, rows, length, pos], device=device), axis)
    if ids is not None:
        broadcast(torch.from_numpy(ids.astype(np.int64)).to(device), axis)


def follow(runner: InferenceRunner, tokenizer: DnaTokenizer, axis) -> int:
    """A follower rank's loop: receive each forward the leader announces,
    run this rank's part of it, until the stop. Returns the forwards run."""
    nuc_ids, device, n = nucleotide_ids(tokenizer), runner.device, 0
    while True:
        kind, rows, length, pos = broadcast(
            torch.zeros(4, dtype=torch.long, device=device), axis).tolist()
        if kind == STOP:
            return n
        ids = broadcast(torch.zeros((rows, length), dtype=torch.long, device=device), axis)
        try:
            _forward(runner, nuc_ids, kind, ids.cpu().numpy(), pos)
        except INPUT_ERRORS:   # the leader raised it too, and answers it
            log.exception("a forward refused its input; waiting for the next")
            continue
        n += 1


class ScoringService:
    """Model-owning facade: numpy in, numpy out, no HTTP concerns. With
    ``axis`` (every rank of the runner's mesh) it is the leader of several
    ranks: each forward is announced to the followers first."""

    def __init__(self, runner: InferenceRunner, tokenizer: DnaTokenizer,
                 default_pos: Optional[int] = None, axis=None):
        self.runner = runner
        self.tokenizer = tokenizer
        self.nuc_ids = nucleotide_ids(tokenizer)
        self.default_pos = default_pos
        self.axis = axis
        self.failed: Optional[BaseException] = None  # a leader's forward out of step

    def _run(self, kind: int, ids: np.ndarray, pos: int) -> np.ndarray:
        if self.axis is None:
            return _forward(self.runner, self.nuc_ids, kind, ids, pos)
        if self.failed is not None:
            raise RuntimeError(f"the ranks stopped serving after {self.failed!r}")
        _announce(self.axis, self.runner.device, kind, ids, pos)
        try:
            return _forward(self.runner, self.nuc_ids, kind, ids, pos)
        except INPUT_ERRORS:
            raise
        except Exception as e:   # the followers may wait in a collective
            self.failed = e
            raise

    def close(self) -> None:
        """Release the followers (a leader's last collective), unless a
        failed forward left them out of step."""
        if self.axis is not None and self.failed is None:
            _announce(self.axis, self.runner.device, STOP)
        self.axis = None

    def _check(self, length: int, pos) -> None:
        """Refuse what the forward would refuse, before it is announced."""
        if isinstance(pos, bool) or not isinstance(pos, (int, np.integer)):
            raise TypeError(f"pos must be an integer, got {pos!r}")
        if not -length <= pos < length:
            raise ValueError(f"pos {pos} lies outside the {length}-bp window")
        mesh = self.runner.mesh
        if mesh is not None and length % mesh.shape["seq"]:
            raise ValueError(f"a {length}-bp window does not divide over the "
                             f"{mesh.shape['seq']}-way seq axis")

    def _pos(self, pos: Optional[int], seq_len: int) -> int:
        if pos is not None:
            return pos
        if self.default_pos is not None:
            return self.default_pos
        return seq_len // 2 - 1  # 255 for 512-bp windows, 4095 for 8192

    def masked_probs(self, sequences: Sequence[str],
                     pos: Optional[int] = None) -> np.ndarray:
        p = self._pos(pos, len(sequences[0]))
        self._check(len(sequences[0]), p)
        ids = mask_and_encode(sequences, self.tokenizer, p)
        return self._run(MASKED_PROBS, ids, p)

    def score(self, sequences: Sequence[str], refs: Sequence[str],
              alts: Sequence[str], pos: Optional[int] = None) -> np.ndarray:
        for r, a in zip(refs, alts):
            if r not in NUCLEOTIDES or a not in NUCLEOTIDES:
                raise ValueError(f"non-SNP alleles ref={r!r} alt={a!r}")
        probs = self.masked_probs(sequences, pos)
        return log_ratio_scores(probs, refs, alts)

    def embed(self, sequences: Sequence[str],
              pos: Optional[int] = None) -> np.ndarray:
        p = self._pos(pos, len(sequences[0]))
        self._check(len(sequences[0]), p)
        ids = self.tokenizer.encode_batch(sequences)
        return self._run(EMBED, ids, p)


class MicroBatcher:
    """Coalesce concurrent requests into single batched model calls.

    Requests enqueue (kind, payload) work items and block on an event; one
    worker thread drains the queue, groups items by kind, concatenates each
    group into one service call, and scatters results back. Grouping across
    requests means P parallel clients sending 1 window each cost ~1 forward,
    not P.
    """

    _KINDS = ("score", "masked_probs", "embed")

    def __init__(self, service: ScoringService, max_batch: int = 1024,
                 max_wait_ms: float = 5.0, on_failed=None):
        self.service = service
        self.on_failed = on_failed  # called when a leader stops serving
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.groups = 0
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="pcad-batcher")
        self._worker.start()

    def submit(self, kind: str, **payload):
        """Blocking: returns the numpy result for this request's items."""
        assert kind in self._KINDS, kind
        # Validate before enqueueing: a malformed item must fail its own
        # request (handler 400), never reach the shared worker thread.
        seqs = payload.get("sequences")
        if not isinstance(seqs, (list, tuple)) or not seqs:
            raise ValueError("sequences must be a non-empty list")
        if not all(isinstance(s, str) and s for s in seqs):
            raise ValueError("every sequence must be a non-empty string")
        if len({len(s) for s in seqs}) != 1:
            raise ValueError("all sequences in one request must share a "
                             "window length")
        item = {"kind": kind, "payload": payload,
                "event": threading.Event(), "result": None, "error": None}
        if not self._worker.is_alive():
            raise RuntimeError("the server has stopped")
        self._q.put(item)
        item["event"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def shutdown(self):
        self._stop.set()
        self._q.put(None)  # wake the worker
        # a leader's worker releases the followers before it ends: wait for it
        self._worker.join(timeout=None if self.service.axis is not None else 5)

    # -- worker ----------------------------------------------------------

    def _drain(self) -> List[dict]:
        """Block for one item, then opportunistically gather more until the
        batch is full or max_wait has passed (classic bounded coalescing)."""
        first = self._q.get()
        if first is None:
            return []
        items, n = [first], len(first["payload"]["sequences"])
        while n < self.max_batch:
            try:
                nxt = self._q.get(timeout=self.max_wait)
            except queue.Empty:
                break
            if nxt is None:
                break
            items.append(nxt)
            n += len(nxt["payload"]["sequences"])
        return items

    def _run(self):
        try:
            self._serve()
        finally:   # on this thread: the only one that issues collectives
            self.service.close()
            while True:   # nothing is served after this thread
                try:
                    it = self._q.get_nowait()
                except queue.Empty:
                    break
                if it is not None:
                    it["error"] = RuntimeError("the server has stopped")
                    it["event"].set()

    def _serve(self):
        while not self._stop.is_set():
            if self.service.failed is not None:
                log.error("a forward failed on the leader (%r) and may have left the ranks "
                          "out of step: the server stops", self.service.failed)
                if self.on_failed is not None:
                    self.on_failed()
                return
            items = self._drain()
            if not items:
                continue
            by_kind: dict = {}
            for it in items:
                by_kind.setdefault(it["kind"], []).append(it)
            for kind, group in by_kind.items():
                try:
                    self._run_group(kind, group)
                except Exception as e:  # keep the worker thread alive
                    log.exception("batch group failed")
                    for it in group:
                        if not it["event"].is_set():
                            it["error"] = e
                            it["event"].set()

    def _run_group(self, kind: str, group: List[dict]):
        # Items in a group must agree on pos AND window length to share one
        # forward (a ragged encode would raise and fail every co-batched
        # request); sub-groups are keyed by (effective pos, length).
        by_pos: dict = {}
        for it in group:
            try:
                length = len(it["payload"]["sequences"][0])
                eff = self.service._pos(it["payload"].get("pos"), length)
            except Exception as e:  # bad item: fail it, not the batch
                it["error"] = e
                it["event"].set()
                continue
            by_pos.setdefault((eff, length), []).append(it)
        for (pos, _length), sub in by_pos.items():
            seqs: List[str] = []
            for it in sub:
                seqs.extend(it["payload"]["sequences"])
            try:
                self.groups += 1
                if kind == "score":
                    refs = [r for it in sub for r in it["payload"]["refs"]]
                    alts = [a for it in sub for a in it["payload"]["alts"]]
                    out = self.service.score(seqs, refs, alts, pos)
                elif kind == "masked_probs":
                    out = self.service.masked_probs(seqs, pos)
                else:
                    out = self.service.embed(seqs, pos)
            except Exception as e:  # propagate to every waiter in the batch
                for it in sub:
                    it["error"] = e
                    it["event"].set()
                continue
            off = 0
            for it in sub:
                k = len(it["payload"]["sequences"])
                it["result"] = out[off : off + k]
                off += k
                it["event"].set()


def _make_handler(batcher: MicroBatcher, model_name: str):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through logging, not stderr
            log.debug("http: " + fmt, *args)

        def _reply(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok", "model": model_name})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                return self._reply(400, {"error": f"bad JSON: {e}"})
            try:
                if self.path == "/score":
                    items = req["items"]
                    # validate BEFORE enqueueing so a bad item can't fail
                    # the co-batched requests of other clients
                    for it in items:
                        if (it["ref"] not in NUCLEOTIDES
                                or it["alt"] not in NUCLEOTIDES):
                            raise ValueError(
                                f"non-SNP alleles ref={it['ref']!r} "
                                f"alt={it['alt']!r}")
                    out = batcher.submit(
                        "score",
                        sequences=[it["sequence"] for it in items],
                        refs=[it["ref"] for it in items],
                        alts=[it["alt"] for it in items],
                        pos=req.get("pos"))
                    self._reply(200, {"scores": np.asarray(out).tolist()})
                elif self.path == "/masked_probs":
                    out = batcher.submit("masked_probs",
                                         sequences=req["sequences"],
                                         pos=req.get("pos"))
                    self._reply(200, {"probs": np.asarray(out).tolist(),
                                      "nucleotides": list(NUCLEOTIDES)})
                elif self.path == "/embed":
                    out = batcher.submit("embed", sequences=req["sequences"],
                                         pos=req.get("pos"))
                    self._reply(200, {"embeddings": np.asarray(out).tolist()})
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            except INPUT_ERRORS as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # model/runtime failure
                log.exception("request failed")
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


class ScoringServer:
    """Own the HTTP server + batcher lifecycle (start/stop for tests)."""

    def __init__(self, service: ScoringService, host: str = "127.0.0.1",
                 port: int = 8142, model_name: str = "?",
                 max_batch: int = 1024, max_wait_ms: float = 5.0):
        self.batcher = MicroBatcher(service, max_batch=max_batch,
                                    max_wait_ms=max_wait_ms,
                                    on_failed=self._stop_serving)
        self.httpd = ThreadingHTTPServer(
            (host, port), _make_handler(self.batcher, model_name))
        self.httpd.daemon_threads = True

    def _stop_serving(self):
        # from the batcher's thread: shutdown() waits for serve_forever
        threading.Thread(target=self.httpd.shutdown, daemon=True).start()

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def serve_forever(self):
        log.info("serving on %s:%d", *self.httpd.server_address[:2])
        try:
            self.httpd.serve_forever()
        finally:
            self.shutdown()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True,
                             name="pcad-http")
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()
        self.batcher.shutdown()
