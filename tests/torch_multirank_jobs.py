"""What the ranks of ``tests/test_torch_fsdp.py`` and
``tests/test_torch_parallel_entry.py`` run, and the one-process runs the
tests hold them to (the same functions with no mesh).

The ranks are started by ``tests/torch_parallel_ranks.Ranks`` (gloo over a
``FileStore``, one PyTorch thread a rank). Each job runs the port over its
mesh, through the library and through the entry points a user calls, and
rank 0 writes the results to ``<name>.npz`` in the work directory (the
entry points write their own files there). This module imports neither JAX
nor the JAX package.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from tests.torch_parallel_ranks import TINY, TINY2, _save

ROWS, WINDOW = 8, 64          # pre-training and distillation batches
FT_ROWS, FT_L = 8, 32         # fine-tuning batches
SCORE_L, SCORE_POS = 64, 31   # scoring and serving windows


def _mesh(config):
    from plantcaduceus_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(config) if config is not None else None


def _mlm_batches():
    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu_torch.train import data as data_lib

    seqs = data_lib.sequence_source("synthetic", window=WINDOW, synthetic_n=64, seed=3)
    return data_lib.PretrainDataset(seqs, DnaTokenizer(), ROWS, seed=3)


# -- FSDP ---------------------------------------------------------------------------


CARD = dict(d_model=64, n_layer=2, vocab_size=16, d_state=16)   # shapes the kernels take


def train_run(config=None, device="cpu", model_kw=TINY) -> dict:
    """2 fp32 train steps of a small Mamba-1 model (the tiny one unless
    ``model_kw``; grad-accum 2, remat, rows over the mesh's batch axes):
    each step's metrics, an eval step's, the full weights after, and under
    fsdp the numbers of elements this rank holds between steps (module
    parameters, blocks, each moment)."""
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.train import step as step_lib
    from plantcaduceus_tpu_torch.train.optimizer import make_optimizer

    cfg = CaduceusConfig(**model_kw)
    model = Caduceus(cfg, init_params(cfg, seed=2))
    opt = make_optimizer(learning_rate=1e-3, warmup_steps=1, total_steps=3,
                         params=dict(model.named_parameters()))
    init, step, eval_step = step_lib.make_train_step(
        cfg, opt, model, dtype=torch.float32, remat=True, grad_accum=2, device=device,
        mesh=_mesh(config))
    ds = _mlm_batches()
    state, out = init(), {}
    for s in range(2):
        state, m = step(state, ds.batch_at(s))
        out.update({f"{k}{s}": torch.tensor(float(v)) for k, v in m.items()})
    ev = eval_step(state, ds.batch_at(0))
    out.update({"eval_" + k: torch.tensor(float(v)) for k, v in ev.items()})
    weights = dict(model.named_parameters())
    if state.fsdp is not None:
        f = state.fsdp
        count = lambda tree: sum(t.numel() for t in tree.values())
        out.update(held_module=count(weights), held_blocks=count(f.shards),
                   held_mu=count(state.opt_state["mu"]), held_nu=count(state.opt_state["nu"]),
                   full=sum(int(np.prod(s)) for s in f.shapes.values()))
        weights = f.full(f.masters())
    out.update({"p_" + n: p.detach().cpu().clone() for n, p in weights.items()})
    return out


def distill_run(config=None) -> dict:
    """2 fp32 distillation steps, tiny Mamba-1 teacher -> tiny Mamba-2
    student, over the mesh (the student FSDP-sharded where it has fsdp):
    each step's metrics and the student's full weights after."""
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.train.distill import make_distill_step
    from plantcaduceus_tpu_torch.train.optimizer import make_optimizer

    tcfg, scfg = CaduceusConfig(**TINY), CaduceusConfig(**TINY2)
    teacher = Caduceus(tcfg, init_params(tcfg, seed=4))
    student = Caduceus(scfg, init_params(scfg, seed=6))
    opt = make_optimizer(learning_rate=1e-3, warmup_steps=1, total_steps=3,
                         params=dict(student.named_parameters()))
    init, step = make_distill_step(tcfg, scfg, opt, student, dtype=torch.float32, remat=True,
                                   device="cpu", mesh=_mesh(config))
    ds = _mlm_batches()
    state, out = init(), {}
    for s in range(2):
        state, m = step(state, teacher, ds.batch_at(s))
        out.update({f"{k}{s}": torch.tensor(float(v)) for k, v in m.items()})
    weights = (state.fsdp.full(state.fsdp.masters()) if state.fsdp is not None
               else dict(student.named_parameters()))
    out.update({"p_" + n: p.detach().clone() for n, p in weights.items()})
    return out


def pretrain_args(workdir: Path) -> list:
    """``cli.pretrain`` flags of the tiny model, 4 fp32 steps of 8 rows,
    a checkpoint every 2."""
    return ["--dataset", "synthetic", "--config", str(workdir / "tiny.json"), "--window",
            str(WINDOW), "--batch-size", str(ROWS), "--save-steps", "2", "--log-steps", "1",
            "--warmup-steps", "1", "--lr", "1e-3", "--dtype", "float32", "--device", "cpu"]


def collectives_run(rank, world, workdir, device="cpu"):
    """``psum_scatter`` and ``all_gather_tiled`` over a ``world``-way fsdp
    axis, with their adjoints, and ``broadcast`` from coordinate 1, on
    tensors on ``device``."""
    from plantcaduceus_tpu_torch.parallel.collectives import (all_gather, all_gather_tiled,
                                                              broadcast, psum_scatter)
    from plantcaduceus_tpu_torch.parallel.mesh import MeshConfig

    ax = _mesh(MeshConfig(fsdp=world)).axis("fsdp")
    inp = {k: torch.from_numpy(v[rank]).to(device)
           for k, v in np.load(workdir / "inputs.npz").items()}
    x = inp["ps_x"].requires_grad_(True)     # [2 world, 3]
    t = inp["ag_x"].requires_grad_(True)     # [2, 3]
    ps, ag = psum_scatter(x, ax, dim=0), all_gather_tiled(t, ax, dim=1)
    ((ps * inp["ps_c"]).sum() + (ag * inp["ag_c"]).sum()).backward()
    bc = broadcast(inp["ag_x"].detach(), ax, src=1)
    assert all(v.device == x.device for v in (ps, ag, x.grad, t.grad, bc))
    out = {k: all_gather(v.detach(), ax) for k, v in
           (("ps", ps), ("ag", ag), ("d_ps", x.grad), ("d_ag", t.grad), ("bc", bc))}
    _save(rank, workdir, f"collectives{world}", out)


def fsdp2(rank, world, workdir):
    """2 ranks: the train steps and distillation at fsdp 2, the
    collectives, and ``cli.pretrain --fsdp 2``: 4 steps, and 2 steps then
    a resume to 4."""
    from plantcaduceus_tpu_torch.cli import pretrain
    from plantcaduceus_tpu_torch.parallel.mesh import MeshConfig

    collectives_run(rank, world, workdir)
    _save(rank, workdir, "train_fsdp2", train_run(MeshConfig(fsdp=2)))
    _save(rank, workdir, "distill_fsdp2", distill_run(MeshConfig(fsdp=2)))
    args = pretrain_args(workdir) + ["--fsdp", "2"]
    pretrain.main(args + ["--max-steps", "4", "--output-dir", str(workdir / "full")])
    pretrain.main(args + ["--max-steps", "2", "--output-dir", str(workdir / "resumed")])
    pretrain.main(args + ["--max-steps", "4", "--output-dir", str(workdir / "resumed")])


def fsdp_on_card(rank, world, workdir):
    """2 ranks sharing ``cuda:0`` (gloo through the host): the collectives
    and 2 train steps at fsdp 2 through the kernels."""
    from plantcaduceus_tpu_torch.parallel.mesh import MeshConfig

    collectives_run(rank, world, workdir, device="cuda")
    _save(rank, workdir, "train_fsdp2",
          train_run(MeshConfig(fsdp=2), device="cuda", model_kw=CARD))


def fsdp4(rank, world, workdir):
    """4 ranks: the collectives, the train steps at data 2 x fsdp 2 and at
    fsdp 2 x seq 2, and distillation at data 2 x fsdp 2."""
    from plantcaduceus_tpu_torch.parallel.mesh import MeshConfig

    collectives_run(rank, world, workdir)
    _save(rank, workdir, "train_data2_fsdp2", train_run(MeshConfig(data=2, fsdp=2)))
    _save(rank, workdir, "train_fsdp2_seq2", train_run(MeshConfig(fsdp=2, seq=2)))
    _save(rank, workdir, "distill_data2_fsdp2", distill_run(MeshConfig(data=2, fsdp=2)))


# -- the data axis on the entry points ------------------------------------------------


def ft_batches():
    """Two fine-tuning batches of 8 rows (classification) and 8 rows to
    infer, from a numpy seed."""
    rng = np.random.default_rng(21)
    ids = lambda: rng.integers(3, 8, (FT_ROWS, FT_L)).astype(np.int32)
    batches = [{"input_ids": ids(), "labels": rng.integers(0, 2, FT_ROWS)} for _ in range(2)]
    return batches, ids()


def ft_trainer(config=None, dropout=0.0, full=False):
    """(model, cfg, cfg_l, optimizer, train_step, infer_fn, state): the
    tiny model's LoRA (r 4) or full fine-tuning at grad-accum 2, fp32,
    remat, the CLI's optimizer."""
    from plantcaduceus_tpu_torch.models import heads
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.train import lora
    from plantcaduceus_tpu_torch.train.optimizer import make_optimizer

    cfg = CaduceusConfig(**TINY)
    model = Caduceus(cfg, init_params(cfg, seed=5))
    cfg_l = lora.LoraConfig(r=4, alpha=8.0, dropout=dropout)
    opt = make_optimizer(learning_rate=1e-3, schedule="linear", warmup_steps=1, total_steps=3,
                         weight_decay=0.01, grad_clip=1.0)
    kw = dict(task_type="classification", dtype=torch.float32, grad_accum=2, device="cpu",
              mesh=_mesh(config))
    if full:
        step, infer = lora.make_full_finetune_step(cfg, opt, model, **kw)
        head = heads.init_head(torch.Generator().manual_seed(9), cfg, 2)
        state = lora.init_full_state(model, head, opt)
    else:
        step, infer = lora.make_lora_train_step(cfg, cfg_l, opt, model, **kw)
        state = lora.init_lora_state(7, model, cfg, cfg_l, 2, opt, device="cpu")
    return model, cfg, cfg_l, opt, step, infer, state


def ft_run(config=None, dropout=0.0, full=False) -> dict:
    """2 steps (dropout seeds ``fold_in(11, step)``, as the CLI keys them):
    the losses, the trained tensors after, and the logits of 8 rows."""
    from plantcaduceus_tpu_torch.models.caduceus import fold_in
    from plantcaduceus_tpu_torch.train import lora

    model, _, _, _, step, infer, state = ft_trainer(config, dropout, full)
    batches, ids = ft_batches()
    out = {}
    for s, b in enumerate(batches):
        state, m = step(state, model, b, fold_in(11, s))
        out[f"loss{s}"] = m["loss"].detach()
    out.update({"t_" + n: t.detach().clone()
                for n, t in lora.trainable(state, full=full).items()})
    out["logits"] = infer(state, model, {"input_ids": ids})
    return out


def write_entry_inputs(d: Path) -> dict:
    """The entry points' inputs: a tiny HF checkpoint, a tokenized
    fine-tuning file, a one-job suite manifest and XGBoost TSVs."""
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.train.checkpoint import export_params

    cfg = CaduceusConfig(**TINY)
    export_params(d / "model", Caduceus(cfg, init_params(cfg, seed=5)), cfg)
    batches, _ = ft_batches()
    np.savez(d / "ft.npz", input_ids=np.concatenate([b["input_ids"] for b in batches]),
             label=np.concatenate([b["labels"] for b in batches]))
    rng = np.random.default_rng(22)
    for name, n in (("train", 12), ("valid", 8), ("test", 8)):
        with open(d / f"{name}.tsv", "w") as fh:
            fh.write("sequences\tlabel\n")
            for i in range(n):
                fh.write("".join(rng.choice(list("ACGT"), SCORE_L)) + f"\t{i % 2}\n")
    return dict(model=str(d / "model"), data=str(d / "ft.npz"))


def lora_train_args(d: Path, out: Path) -> list:
    return ["train", "--train-dir", str(d / "ft.npz"), "--valid-dir", str(d / "ft.npz"),
            "--model-name", str(d / "model"), "--output-dir", str(out), "--max-steps", "2",
            "--save-steps", "2", "--eval-steps", "2", "--train-batch-size", "4",
            "--grad-accum", "2", "--eval-batch-size", "4", "--lora-r", "4",
            "--lora-dropout", "0", "--no-bf16", "--device", "cpu"]


def predict_args(d: Path, adapter: Path, out: Path) -> list:
    return ["predict", "--checkpoint-dir", str(adapter), "--data-dir", str(d / "ft.npz"),
            "--batch-size", "4", "--output-file", str(out), "--no-bf16", "--device", "cpu"]


def suite_manifest(d: Path) -> Path:
    path = d / "suite.json"
    path.write_text(json.dumps({
        "defaults": {"model-name": str(d / "model"), "max-steps": 2, "train-batch-size": 4,
                     "grad-accum": 2, "eval-batch-size": 4, "lora-r": 4,
                     "lora-dropout": 0, "no-bf16": True, "device": "cpu"},
        "jobs": [{"name": "job", "train_dir": str(d / "ft.npz"),
                  "valid_dir": str(d / "ft.npz")}]}))
    return path


def xgb_args(d: Path, out: Path, batch: int = 4) -> list:
    """``train_xgboost`` flags; ``-batchSize`` is global (2 rows a rank at
    data 2, as one process at ``batch`` 2)."""
    return ["-train", str(d / "train.tsv"), "-valid", str(d / "valid.tsv"), "-test",
            str(d / "test.tsv"), "-model", str(d / "model"), "-output", str(out),
            "-batchSize", str(batch), "-tokenIdx", str(SCORE_POS), "-device", "cpu",
            "-no-progress"]


def predict_xgb_args(d: Path, out: Path, batch: int = 4) -> list:
    return ["-input", str(d / "test.tsv"), "-model", str(d / "model"), "-classifier",
            str(d / "clf.json"), "-output", str(out), "-batchSize", str(batch), "-tokenIdx",
            str(SCORE_POS), "-device", "cpu", "-no-progress"]


def _status(call) -> int:
    """The HTTP status of a client call."""
    try:
        call()
        return 200
    except Exception as e:   # an HTTPError
        return getattr(e, "code", -1)


def serve_run(rank, world, workdir, config, name):
    """The tiny model served over ``config``'s mesh: rank 0 leads (an HTTP
    server on a free port), rank 1 follows. The leader sends /score,
    /masked_probs at pos 17 and /embed; then what fails: a non-SNP
    request, an /embed at a pos past the window, a 63-bp window (which the
    seq axis does not divide), an /embed past the window with the leader's
    check switched off (broadcast: every rank's forward raises), and a last
    /embed. Rank 0 writes the replies and statuses, and each follower its
    forward count."""
    from plantcaduceus_tpu_torch.engine.client import ScoringClient
    from plantcaduceus_tpu_torch.engine.server import ScoringServer, follow
    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer

    mesh = _mesh(config)
    service = scoring_service(mesh)
    axis = mesh.axis("data", "fsdp", "seq")
    if rank != 0:
        n = follow(service.runner, DnaTokenizer(), axis)
        (workdir / f"{name}_follower{rank}.json").write_text(json.dumps({"forwards": n}))
        return
    seqs = [str(s) for s in np.load(workdir / "inputs.npz")["serve_seqs"]]
    server = ScoringServer(service, port=0, model_name="tiny")
    server.start_background()
    try:
        client = ScoringClient(f"http://127.0.0.1:{server.port}")
        refs = [s[SCORE_POS] for s in seqs]
        alts = ["ACGT"[("ACGT".index(r) + 1) % 4] for r in refs]
        out = {"scores": np.asarray(client.score(seqs, refs, alts)),
               "probs": np.asarray(client.masked_probs(seqs[:3], pos=17)),
               "emb": np.asarray(client.embed(seqs[:3]))}
        out["bad"] = np.array(_status(lambda: client.score(seqs[:1], ["N"], ["A"])))
        out["bad_pos"] = np.array(_status(lambda: client.embed(seqs[:1], pos=SCORE_L)))
        out["bad_len"] = np.array(_status(lambda: client.masked_probs([seqs[0][1:]])))
        check, service._check = service._check, lambda length, pos: None
        out["raised"] = np.array(_status(lambda: client.embed(seqs[:1], pos=SCORE_L)))
        service._check = check
        out["emb_after"] = np.asarray(client.embed(seqs[:3]))
    finally:
        server.shutdown()
    _save(rank, workdir, name, out)


def scoring_service(mesh=None, batch=4):
    """The tiny model's fp32 scoring service over ``mesh`` (``batch`` rows
    a forward, split over the data axis); the leader's when the mesh spans
    several ranks."""
    from plantcaduceus_tpu_torch.engine.runner import InferenceRunner
    from plantcaduceus_tpu_torch.engine.server import ScoringService
    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig

    cfg = CaduceusConfig(**TINY)
    runner = InferenceRunner(Caduceus(cfg, init_params(cfg, seed=5)), cfg, dtype=torch.float32,
                             batch_size=batch, device="cpu", mesh=mesh)
    axis = mesh.axis("data", "fsdp", "seq") if mesh is not None else None
    return ScoringService(runner, DnaTokenizer(), axis=axis)


def entry2(rank, world, workdir):
    """2 ranks on the data axis (and serving at seq 2): LoRA and full
    fine-tuning steps, ``lora_fine_tune train`` and ``predict``,
    ``finetune_suite``, ``train_xgboost``, ``predict_xgboost``, and the
    server's leader and follower at data 2 and at seq 2."""
    from plantcaduceus_tpu_torch.cli import (finetune_suite, lora_fine_tune, predict_xgboost,
                                             train_xgboost)
    from plantcaduceus_tpu_torch.parallel.mesh import MeshConfig

    data2 = MeshConfig(data=2)
    _save(rank, workdir, "lora", ft_run(data2))
    _save(rank, workdir, "lora_dropout", ft_run(data2, dropout=0.1))
    _save(rank, workdir, "full", ft_run(data2, full=True))
    serve_run(rank, world, workdir, data2, "serve_data2")
    serve_run(rank, world, workdir, MeshConfig(seq=2), "serve_seq2")
    lora_fine_tune.main(lora_train_args(workdir, workdir / "ft"))
    lora_fine_tune.main(predict_args(workdir, workdir / "ft" / "final", workdir / "pred.csv"))
    finetune_suite.main([str(suite_manifest(workdir)), "--output-dir", str(workdir / "suite")])
    train_xgboost.main(xgb_args(workdir, workdir / "xgb"))
    predict_xgboost.main(predict_xgb_args(workdir, workdir / "pred_xgb.tsv"))
