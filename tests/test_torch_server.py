"""The port's serving mode (``engine/server.py``, ``engine/client.py``,
``cli/serve.py``) on the CPU.

``tests/test_server.py``'s seven behaviours run against the port's server
(a real ThreadingHTTPServer on an ephemeral port, a tiny float32 model):
endpoint results equal direct engine calls, concurrent requests share
forwards, and malformed input fails its own request with 400 while the
worker thread lives on. Then the same requests go to a JAX server and a
port server over one checkpoint (written by the port's ``export_hf_dir``):
replies agree within 1e-5 (float32 forwards that agree to ~1e-6). And
``cli.serve`` refuses ``-seq 2`` in one process (it needs 2 ranks).
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from plantcaduceus_tpu_torch.engine import zero_shot
from plantcaduceus_tpu_torch.engine.client import ScoringClient
from plantcaduceus_tpu_torch.engine.runner import InferenceRunner
from plantcaduceus_tpu_torch.engine.server import MicroBatcher, ScoringServer, ScoringService
from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
from plantcaduceus_tpu_torch.models.config import CaduceusConfig
from tests.torch_threads import one_torch_thread  # noqa: F401

TINY = dict(d_model=32, n_layer=2, vocab_size=16, d_state=8)
L = 128
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def service():
    cfg = CaduceusConfig(**TINY)
    runner = InferenceRunner(Caduceus(cfg, init_params(cfg, seed=0)), cfg,
                             dtype=torch.float32, batch_size=8, device="cpu")
    return ScoringService(runner, DnaTokenizer())


@pytest.fixture(scope="module")
def server(service):
    srv = ScoringServer(service, port=0, model_name="tiny", max_wait_ms=20.0)
    srv.start_background()
    yield srv
    srv.shutdown()


def _seqs(rng, n, length=L):
    return ["".join(rng.choice(list("ACGT"), length)) for _ in range(n)]


def _post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_healthz_and_score_matches_engine(server, service, rng):
    client = ScoringClient(f"http://127.0.0.1:{server.port}")
    assert client.healthz() == {"status": "ok", "model": "tiny"}

    seqs = _seqs(rng, 5)
    refs = [s[L // 2 - 1] for s in seqs]
    alts = ["A" if r != "A" else "G" for r in refs]
    got = client.score(seqs, refs, alts)

    ids = zero_shot.mask_and_encode(seqs, service.tokenizer, L // 2 - 1)
    probs = service.runner.masked_probs(ids, service.nuc_ids, L // 2 - 1, progress=False)
    np.testing.assert_allclose(got, zero_shot.log_ratio_scores(probs, refs, alts), **TOL)


def test_masked_probs_and_embed_endpoints(server, service, rng):
    client = ScoringClient(f"http://127.0.0.1:{server.port}")
    seqs = _seqs(rng, 3)
    reply = _post(server.port, "/masked_probs", {"sequences": seqs, "pos": 17})
    assert reply["nucleotides"] == ["A", "C", "G", "T"]
    probs = np.asarray(reply["probs"])
    assert probs.shape == (3, 4)
    np.testing.assert_allclose(probs, service.masked_probs(seqs, pos=17), **TOL)

    emb = np.asarray(client.embed(seqs))
    want = service.embed(seqs)
    assert emb.shape == want.shape == (3, TINY["d_model"])  # RC-averaged halves
    np.testing.assert_allclose(emb, want, **TOL)


def test_concurrent_requests_are_coalesced(service, rng):
    """Twelve parallel single-window requests share forwards."""
    calls = []
    orig = service.masked_probs

    def counting(seqs, pos=None):
        calls.append(len(seqs))
        return orig(seqs, pos)

    service.masked_probs = counting
    try:
        batcher = MicroBatcher(service, max_batch=64, max_wait_ms=50.0)
        seqs = _seqs(rng, 12)
        results = [None] * 12

        def one(i):
            results[i] = batcher.submit("masked_probs", sequences=[seqs[i]])

        threads = [threading.Thread(target=one, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        batcher.shutdown()
    finally:
        service.masked_probs = orig

    assert sum(calls) == 12 and len(calls) < 12 and batcher.groups == len(calls)
    got = np.concatenate([np.asarray(r) for r in results])
    np.testing.assert_allclose(got, orig(seqs), **TOL)


def test_bad_request_isolated(server, rng):
    """A non-SNP allele fails with 400; the server keeps serving."""
    client = ScoringClient(f"http://127.0.0.1:{server.port}")
    seqs = _seqs(rng, 1)
    with pytest.raises(urllib.error.HTTPError) as exc:
        client.score(seqs, ["N"], ["A"])
    assert exc.value.code == 400
    assert client.healthz()["status"] == "ok"
    assert np.isfinite(client.score(seqs, [seqs[0][L // 2 - 1]], ["A"])).all()


def test_empty_sequences_rejected_without_killing_worker(server, rng):
    for bad in ({"sequences": []}, {"sequences": [""]}, {}):
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(server.port, "/masked_probs", bad)
        assert exc.value.code == 400
    client = ScoringClient(f"http://127.0.0.1:{server.port}")
    assert np.asarray(client.masked_probs(_seqs(rng, 2))).shape == (2, 4)


def test_string_and_ragged_sequences_rejected(server):
    for bad in ({"sequences": "ACGT"}, {"sequences": ["ACGT" * 8, "ACGT" * 4]}):
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(server.port, "/masked_probs", bad)
        assert exc.value.code == 400


def test_mixed_window_lengths_cobatch_isolated(service, rng):
    """The same effective pos at two window lengths: separate sub-groups, so
    both succeed instead of one ragged encode failing the group."""
    batcher = MicroBatcher(service, max_batch=64, max_wait_ms=50.0)
    try:
        short, long = _seqs(rng, 2, 64), _seqs(rng, 2)
        results = {}

        def one(name, seqs):
            try:
                results[name] = batcher.submit("masked_probs", sequences=seqs, pos=10)
            except Exception as e:  # pragma: no cover - fails the assert below
                results[name] = e

        threads = [threading.Thread(target=one, args=(n, s))
                   for n, s in (("short", short), ("long", long))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        batcher.shutdown()
    for name, seqs in (("short", short), ("long", long)):
        assert not isinstance(results[name], Exception), results[name]
        np.testing.assert_allclose(np.asarray(results[name]),
                                   service.masked_probs(seqs, pos=10), **TOL)


def test_runtime_failure_is_500_and_worker_survives(server, service, rng, monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("device lost")

    monkeypatch.setattr(service.runner, "center_embeddings", broken)
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(server.port, "/embed", {"sequences": _seqs(rng, 1)})
    assert exc.value.code == 500
    monkeypatch.undo()
    assert len(ScoringClient(f"http://127.0.0.1:{server.port}").embed(_seqs(rng, 1))) == 1


def test_replies_match_jax_server(tmp_path, rng):
    """The same requests to a JAX server and a port server over one checkpoint."""
    import jax
    import jax.numpy as jnp

    from plantcaduceus_tpu.engine.runner import InferenceRunner as JaxRunner
    from plantcaduceus_tpu.engine.server import ScoringServer as JaxServer
    from plantcaduceus_tpu.engine.server import ScoringService as JaxService
    from plantcaduceus_tpu.parallel import mesh as meshlib
    from plantcaduceus_tpu.utils.model_loading import load_model_and_tokenizer as jax_load
    from plantcaduceus_tpu_torch.compat.hf_export import export_hf_dir
    from plantcaduceus_tpu_torch.utils.model_loading import load_model_and_tokenizer

    cfg = CaduceusConfig(**TINY)
    export_hf_dir(tmp_path / "ckpt", init_params(cfg, seed=4), cfg)
    params, jcfg, jtok = jax_load(str(tmp_path / "ckpt"))
    mesh = meshlib.make_mesh(meshlib.MeshConfig(data=1), devices=jax.devices()[:1])
    model, tcfg, ttok = load_model_and_tokenizer(str(tmp_path / "ckpt"))
    servers = {
        "jax": JaxServer(JaxService(JaxRunner(params, jcfg, mesh=mesh, dtype=jnp.float32,
                                              batch_size=8), jtok), port=0),
        "torch": ScoringServer(ScoringService(InferenceRunner(
            model, tcfg, dtype=torch.float32, batch_size=8, device="cpu"), ttok), port=0)}
    seqs = _seqs(rng, 6)
    refs = [s[L // 2 - 1] for s in seqs]
    requests = [("/score", {"items": [{"sequence": s, "ref": r, "alt": "A" if r != "A" else "C"}
                                      for s, r in zip(seqs, refs)]}),
                ("/masked_probs", {"sequences": seqs[:3], "pos": 63}),
                ("/embed", {"sequences": seqs[2:]})]
    replies = {}
    try:
        for name, srv in servers.items():
            srv.start_background()
            replies[name] = [_post(srv.port, path, body) for path, body in requests]
    finally:
        for srv in servers.values():
            srv.shutdown()
    for got, want in zip(replies["torch"], replies["jax"]):
        assert set(got) == set(want)
        for k in want:
            if k == "nucleotides":
                assert got[k] == want[k]
            else:
                np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                           rtol=1e-5, atol=1e-5, err_msg=k)


def test_serve_cli_refuses_seq():
    """``-seq 2`` needs 2 ranks (``tests/test_torch_parallel_entry.py``
    serves over them); one process is refused before the model loads."""
    from plantcaduceus_tpu_torch.cli.serve import main

    with pytest.raises(SystemExit, match="-seq 2: 1 rank"):
        main(["-model", "l20", "-seq", "2", "-device", "cpu"])
