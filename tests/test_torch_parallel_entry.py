"""The data axis on the port's entry points, on gloo ranks of this CPU:
fine-tuning, XGBoost embeddings and serving, against one process.

One group of 2 ranks (``tests/torch_multirank_jobs.py:entry2``, started
once for the module) and ``cli.serve -seq 2`` under ``torch.distributed.run``
run while this process computes the references. Everything is held to the
port's own one-process path, which the single-process tests hold to JAX:

* 2 LoRA steps and 2 full fine-tuning steps (grad-accum 2, 8 rows over
  data 2) at dropout 0 against one process over all rows, and at dropout
  0.1 against one process that takes each rank's rows as their own pass
  with the same seed (JAX's semantics: every rank draws its masks from the
  one replicated key over its own rows); the logits of 8 rows through the
  row split, bit for bit;
* ``lora_fine_tune train`` (2 steps) and ``predict`` on 2 ranks: the
  adapter against one process's, the predictions from it byte for byte;
  ``finetune_suite``'s metrics;
* ``train_xgboost`` and ``predict_xgboost`` on 2 ranks: the cached
  embeddings and the files rank 0 writes, bit for bit;
* the server's leader (HTTP on rank 0) and follower over data 2 and seq 2
  against the one-process service; requests that fail validation (a
  non-SNP allele, a pos past the window, a window the seq axis does not
  divide) answered 400 and never broadcast; a forward that raises on every
  rank answered 400 with the follower going on to the next; the follower
  released on shutdown; and ``cli.serve -seq 2`` stopped by SIGTERM to its
  leader, both ranks exiting 0;
* without ranks: a leader whose forward fails for another cause than its
  input stops serving and releases nothing.

The runners' batch sizes are global: the ranks' ``-batchSize 4`` at data 2
is held to one process at 2, the rows each rank's forward takes.

Float32 throughout (the XGBoost embeddings in the CLIs' bf16). Tolerances:
row-split results bit for bit (each row computed alone, as in one
process); trained tensors within 1e-4 of each leaf's max |value| and
losses 1e-5 relative (sums in another order); sequence-sharded replies
within 1e-5 of their max |value|.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_multirank_jobs import (SCORE_L, SCORE_POS, ft_batches, ft_run,
                                        ft_trainer, lora_train_args, predict_args,
                                        predict_xgb_args, scoring_service, suite_manifest,
                                        write_entry_inputs, xgb_args)
from tests.torch_parallel_ranks import DEADLINE_S, REPO, Ranks
from tests.torch_threads import one_torch_thread  # noqa: F401

PARAM_TOL, LOSS_TOL, SEQ_TOL = 1e-4, 1e-5, 1e-5


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The ranks and ``cli.serve -seq 2`` on 2 ranks of
    ``torch.distributed.run``, started before any test, with their
    inputs."""
    from tests.test_torch_downstream import _classifier

    d = tmp_path_factory.mktemp("entry2")
    paths = write_entry_inputs(d)
    rng = np.random.default_rng(23)
    np.savez(d / "inputs.npz", serve_seqs=np.array(
        ["".join(rng.choice(list("ACGT"), SCORE_L)) for _ in range(5)]))
    emb = scoring_service().runner.center_embeddings(
        np.asarray(_tok().encode_batch(_tsv_seqs(d / "test.tsv"))), SCORE_POS, progress=False)
    (d / "clf.json").write_text(json.dumps(_classifier(emb)))
    ranks = Ranks(2, "tests.torch_multirank_jobs:entry2", d)
    port = _free_port()
    log = open(d / "serve.log", "w+b")
    serve = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "plantcaduceus_tpu_torch.cli.serve", "-model", paths["model"], "-seq", "2",
         "-batchSize", "4", "-dtype", "float32", "-port", str(port), "-device", "cpu"],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO)),
        stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
    yield ranks, d, (serve, port, log)
    ranks.wait()
    _stop(serve)


def _stop(proc):
    """End a ``torch.distributed.run`` that a test left running: SIGTERM to
    it stops its ranks (they run in sessions of their own, out of reach of
    a kill of its group); SIGKILL to its group after 30 s."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.wait()


def _tok():
    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer

    return DnaTokenizer()


def _tsv_seqs(path):
    return [ln.split("\t")[0] for ln in Path(path).read_text().splitlines()[1:]]


def _done(started):
    """The ranks' work directory, once they have finished."""
    return started[0].wait()


def _result(started, name):
    return dict(np.load(_done(started) / f"{name}.npz"))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


# -- fine-tuning steps --------------------------------------------------------------


def _assert_trained(got, want):
    for s in range(2):
        assert float(got[f"loss{s}"]) == pytest.approx(float(want[f"loss{s}"]), rel=LOSS_TOL)
    names = [k for k in want if k.startswith("t_")]
    assert names and set(names) == {k for k in got if k.startswith("t_")}
    for k in names:
        assert _rel(got[k], want[k]) <= PARAM_TOL, (k, _rel(got[k], want[k]))


@pytest.mark.parametrize("name,full", [("lora", False), ("full", True)],
                         ids=["lora", "full_finetune"])
def test_fine_tuning_data2_matches_one_process(started, name, full):
    """Dropout 0: the data-parallel steps compute one process's over all
    rows; the logits through the row split equal one process's."""
    want = ft_run(full=full)
    got = _result(started, name)
    _assert_trained(got, want)
    assert _rel(got["logits"], want["logits"]) <= PARAM_TOL


def _per_rank_reference(dropout):
    """One process taking each rank's 4 rows of each batch as their own
    pass (grad-accum 2, the seed ``fold_in(11, step)`` on both), weighted
    by their share of the 8 global rows, the gradients summed, then one
    update: what JAX's data-parallel LoRA step with dropout computes."""
    from plantcaduceus_tpu_torch.models import heads
    from plantcaduceus_tpu_torch.models.caduceus import fold_in
    from plantcaduceus_tpu_torch.train import lora

    model, cfg, cfg_l, opt, _, _, state = ft_trainer(dropout=dropout)
    batches, _ = ft_batches()
    out = {}
    for s, batch in enumerate(batches):
        seed = fold_in(11, s)
        tensors = lora.trainable(state)

        def loss_fn(mb, i):
            ctx = lora.lora_ctx(state.adapters, cfg_l, dropout_seed=fold_in(seed, i))
            logits = heads.sequence_logits(model, state.head, mb["input_ids"], cfg,
                                           dtype=torch.float32, remat=True, lora=ctx)
            return heads.task_loss(logits, mb["labels"], "classification")

        total, grads = 0.0, None
        for r in range(2):
            rows = {k: v[4 * r:4 * r + 4] for k, v in batch.items()}
            loss, g = lora._accumulated_step(
                loss_fn, tensors, lora._to_device(rows, "cpu", "classification"), 2, 8)
            total = total + loss
            grads = g if grads is None else {n: grads[n] + g[n] for n in g}
        opt.update(grads, state.opt_state, tensors)
        state.step += 1
        out[f"loss{s}"] = total.detach()
    out.update({"t_" + n: t.detach() for n, t in lora.trainable(state).items()})
    return out


def test_lora_dropout_data2_draws_each_ranks_masks_over_its_rows(started):
    _assert_trained(_result(started, "lora_dropout"), _per_rank_reference(0.1))


def test_lora_dropout_data2_is_not_one_process_over_all_rows(started):
    """The same seed over 4 rows a rank is not one draw over all 8 rows:
    the steps differ from one process's, beyond the sum-order tolerance."""
    got, want = _result(started, "lora_dropout"), ft_run(dropout=0.1)
    assert max(_rel(got[k], want[k]) for k in want if k.startswith("t_")) > 100 * PARAM_TOL


def test_row_split_logits_equal_one_process_bit_for_bit(started):
    """The ranks' trained LoRA state through ``infer_fn``'s row split
    against the same weights in one process."""
    from plantcaduceus_tpu_torch.train import lora

    got = _result(started, "lora")
    model, cfg, cfg_l, _, _, infer, state = ft_trainer()
    with torch.no_grad():
        for n, t in lora.trainable(state).items():
            t.copy_(torch.from_numpy(got["t_" + n]))
    _, ids = ft_batches()
    np.testing.assert_array_equal(infer(state, model, {"input_ids": ids}).numpy(),
                                  got["logits"])


# -- the fine-tuning entry points ------------------------------------------------------


def _adapter(path):
    tree = torch.load(Path(path) / "adapter.pt", weights_only=True)
    out = {f"head.{k}": v for k, v in tree["head"].items()}
    for n, ab in tree["adapters"].items():
        out.update({f"{n}.{k}": v for k, v in ab.items()})
    return out


def test_lora_cli_train_data2_matches_one_process(started, tmp_path):
    from plantcaduceus_tpu_torch.cli import lora_fine_tune

    d = _done(started)
    lora_fine_tune.main(lora_train_args(d, tmp_path / "ft"))
    want, got = _adapter(tmp_path / "ft" / "final"), _adapter(d / "ft" / "final")
    assert set(got) == set(want)
    for k, v in want.items():
        assert _rel(got[k].numpy(), v.numpy()) <= PARAM_TOL, k
    assert (d / "ft" / "checkpoint-2" / "train_state.pt").is_file()


def test_lora_cli_predict_data2_equals_one_process_byte_for_byte(started, tmp_path):
    from plantcaduceus_tpu_torch.cli import lora_fine_tune

    d = _done(started)
    lora_fine_tune.main(predict_args(d, d / "ft" / "final", tmp_path / "pred.csv"))
    assert (d / "pred.csv").read_bytes() == (tmp_path / "pred.csv").read_bytes()


def test_finetune_suite_data2_matches_one_process(started, tmp_path):
    from plantcaduceus_tpu_torch.cli import finetune_suite

    d = _done(started)
    finetune_suite.main([str(suite_manifest(d)), "--output-dir", str(tmp_path / "suite")])
    want = json.loads((tmp_path / "suite" / "suite_metrics.json").read_text())
    got = json.loads((d / "suite" / "suite_metrics.json").read_text())
    assert got.keys() == want.keys() == {"job"}
    for k, v in want["job"].items():
        assert got["job"][k] == pytest.approx(v, rel=1e-5, abs=1e-6), k


# -- XGBoost ---------------------------------------------------------------------------


def test_train_xgboost_data2_equals_one_process_bit_for_bit(started, tmp_path):
    """The cached embeddings and every file rank 0 writes."""
    from plantcaduceus_tpu_torch.cli import train_xgboost

    d = _done(started)
    train_xgboost.main(xgb_args(d, tmp_path / "xgb", batch=2))
    names = sorted(p.name for p in (tmp_path / "xgb").iterdir())
    assert names == sorted(p.name for p in (d / "xgb").iterdir())
    for name in names:
        if name.endswith(".npz"):
            want, got = np.load(tmp_path / "xgb" / name), np.load(d / "xgb" / name)
            assert sorted(want.files) == sorted(got.files), name
            for k in want.files:
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name}:{k}")


def test_predict_xgboost_data2_equals_one_process_byte_for_byte(started, tmp_path):
    from plantcaduceus_tpu_torch.cli import predict_xgboost

    d = _done(started)
    predict_xgboost.main(predict_xgb_args(d, tmp_path / "pred.tsv", batch=2))
    assert (d / "pred_xgb.tsv").read_bytes() == (tmp_path / "pred.tsv").read_bytes()


# -- serving -----------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["serve_data2", "serve_seq2"])
def test_server_leader_and_follower_match_one_process(started, name):
    """The leader's replies against the one-process service at the rows of
    a rank's forward (data 2: bit for bit; seq 2: within 1e-5 of max
    |value|)."""
    d = _done(started)
    got = _result(started, name)
    service = scoring_service(batch=2)
    seqs = [str(s) for s in np.load(d / "inputs.npz")["serve_seqs"]]
    refs = [s[SCORE_POS] for s in seqs]
    alts = ["ACGT"[("ACGT".index(r) + 1) % 4] for r in refs]
    want = {"scores": service.score(seqs, refs, alts), "probs": service.masked_probs(seqs[:3], 17),
            "emb": service.embed(seqs[:3])}
    for k, v in want.items():
        if name == "serve_data2":
            np.testing.assert_array_equal(got[k], np.asarray(v, got[k].dtype), err_msg=k)
        else:
            assert _rel(got[k], v) <= SEQ_TOL, (k, _rel(got[k], v))


@pytest.mark.parametrize("name", ["serve_data2", "serve_seq2"])
def test_server_refusals_keep_the_follower_in_step(started, name):
    """A non-SNP allele, a pos past the window and (at seq 2) a 63-bp window
    are answered 400 and never broadcast; a forward broadcast past the
    leader's check raises on both ranks, is answered 400, and the follower
    runs the next forward, whose reply equals the first /embed's. The
    follower ran the valid requests' forwards (at data 2 the 63-bp window
    too) and was released."""
    d = _done(started)
    got = _result(started, name)
    seq2 = name == "serve_seq2"
    assert {k: int(got[k]) for k in ("bad", "bad_pos", "bad_len", "raised")} == {
        "bad": 400, "bad_pos": 400, "bad_len": 400 if seq2 else 200, "raised": 400}
    np.testing.assert_array_equal(got["emb_after"], got["emb"])
    assert json.loads((d / f"{name}_follower1.json").read_text()) == {
        "forwards": 4 if seq2 else 5}


class _NoPeers:
    """Stands in for a mesh axis: a leader that announces to nobody."""


def test_leader_stops_after_a_forward_fails_for_another_cause(monkeypatch):
    """A leader's forward that fails for another cause than its input (the
    followers may wait in a collective): 500, the HTTP server stops, later
    requests are refused, and the stop is never broadcast."""
    from plantcaduceus_tpu_torch.engine import server as server_lib

    sent = []
    monkeypatch.setattr(server_lib, "broadcast", lambda t, axis: sent.append(t.tolist()) or t)
    service = scoring_service()
    service.axis = _NoPeers()

    def lost(*a, **kw):
        raise RuntimeError("CUDA out of memory")

    monkeypatch.setattr(service.runner, "center_embeddings", lost)
    server = server_lib.ScoringServer(service, port=0)
    thread = server.start_background()
    seqs = ["ACGT" * (SCORE_L // 4)]
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(server.port, "/embed", {"sequences": seqs})
    assert exc.value.code == 500
    thread.join(timeout=30)
    assert not thread.is_alive()   # serve_forever returned
    assert isinstance(service.failed, RuntimeError)
    with pytest.raises(RuntimeError, match="the server has stopped"):
        server.batcher.submit("embed", sequences=seqs)
    server.shutdown()
    assert [h[0] for h in sent if len(h) == 4] == [server_lib.EMBED]   # no stop


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_serve_cli_seq2_answers_and_stops_cleanly(started):
    """``cli.serve -seq 2`` on 2 ranks of ``torch.distributed.run``:
    /masked_probs within 1e-5 of the one-process service; SIGTERM to the
    leader (its pid in its log) stops the server and releases the other
    rank, and every process exits 0."""
    serve, port, log = started[2]
    seqs = [str(s) for s in np.load(started[1] / "inputs.npz")["serve_seqs"]]
    end = time.monotonic() + DEADLINE_S
    while True:
        assert serve.poll() is None, log.seek(0) or log.read().decode()[-4000:]
        try:
            reply = _post(port, "/masked_probs", {"sequences": seqs, "pos": 17})
            break
        except OSError:
            assert time.monotonic() < end, "cli.serve did not answer"
            time.sleep(0.5)
    want = scoring_service().masked_probs(seqs, 17)
    assert _rel(reply["probs"], want) <= SEQ_TOL
    log.seek(0)
    pid = int(re.search(rb"leader of 2 ranks .*pid (\d+)", log.read()).group(1))
    os.kill(pid, signal.SIGTERM)
    try:
        rc = serve.wait(timeout=60)
    finally:
        log.seek(0)
        text = log.read().decode()
    assert rc == 0, text[-4000:]
    assert "released by the leader after 1 forwards" in text, text[-4000:]
