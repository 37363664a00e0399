"""The port's data and seq mesh axes on 2 gloo ranks of this CPU, against
the JAX package.

One group of 2 ranks and one of 4 (``tests/torch_parallel_ranks.py``:
``world2``, ``world4``, started once for the module) run every multi-rank
check and write their results; each test below holds one of them to JAX.
JAX's two Pallas references in interpret mode run meanwhile in a process of
their own (``tests/torch_parallel_refs.py``). The checks:

* the collectives' adjoints at 4 ranks, as ``jax.lax`` transposes them;

* ``halo_depthwise_conv_silu``, forward and gradient, against JAX's under
  ``shard_map`` on 2 virtual devices;
* the sharded Mamba-1 scan's forward against JAX's
  ``selective_scan_seq_sharded`` under ``shard_map`` (Pallas in interpret
  mode), and both scans' (Mamba-1 in both dt modes, the SSD in both
  directions; 2 and 4 shards) outputs and gradients against JAX's
  single-device functions and ``jax.grad``, not its sharded gradients,
  whose CPU runs take minutes;
* the tiny Caduceus forward and gradient at seq 2, both SSM variants,
  against JAX's single-device forward and ``jax.grad``;
* 2 train steps at data 2 × seq 1 (grad-accum 2) and at data 1 × seq 2
  against JAX ``make_train_step`` on one device;
* scoring with each batch's rows split over data 2 (the runner's row split)
  against one process, bit for bit.

Without ranks: the plain K3's ``g0``/``emit_dh0`` against JAX's
``_pallas_bwd_group`` in interpret mode, ``MeshConfig.resolve`` and the
FSDP rule of ``param_specs`` against JAX's, the refusals (LoRA with ``sp``,
the unported axes, several ranks of the entry points that JAX runs on one
device, a host tensor under NCCL), and
``zero_shot_score -seq 2`` under ``torch.distributed.run`` against one
process, byte for byte.

Float32 throughout. Tolerances (relative to each output's largest
magnitude): 1e-4 for the plain K3 and the forwards (the same math summed in
other orders; JAX's exp against the port's exp2), 1e-3 for gradients (as
JAX's own sharded-gradient tests), train steps as ``test_torch_train.py``.
"""

import functools
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from plantcaduceus_tpu.ops.conv import halo_depthwise_conv_silu as jax_halo
from plantcaduceus_tpu.ops.selective_scan import selective_scan_sequential
from plantcaduceus_tpu_torch.ops.cuda_scan import scan_bwd_plain
from tests.torch_parallel_ranks import DEADLINE_S, MODELS, TINY, Ranks, randn32, scan_inputs
from tests.torch_parallel_refs import K3_CASES, k3_key
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
FWD_TOL, GRAD_TOL = 1e-4, 1e-3


def _value_and_vjp(f, args, cot):
    """f(*args) and its vector-Jacobian product with ``cot``, as one
    compiled program."""
    def both(args, cot):
        y, vjp = jax.vjp(f, *args)
        return y, vjp(cot)

    return jax.jit(both)(list(args), cot)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = max(np.abs(want).max(), 1e-6)
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol} x {scale:.3e}"


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compiles():
    """XLA's optimisation passes off for this module's tiny JAX programs: the
    same functions, compiled in less time."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


def _cli_inputs(d):
    """A tiny HF checkpoint and a 5-record TSV for ``zero_shot_score``."""
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.train.checkpoint import export_params

    cfg = CaduceusConfig(**TINY)
    export_params(d / "model", Caduceus(cfg, init_params(cfg, seed=9)), cfg)
    rng = np.random.default_rng(12)
    with open(d / "in.tsv", "w") as fh:
        fh.write("ref\talt\tsequences\n")
        for _ in range(5):
            seq = "".join(rng.choice(list("ACGT"), 64))
            fh.write(f"{seq[32]}\t{'ACGT'[('ACGT'.index(seq[32]) + 1) % 4]}\t{seq}\n")
    return ["-input-table", str(d / "in.tsv"), "-model", str(d / "model"), "-batchSize", "2",
            "-tokenIdx", "32", "-dtype", "float32", "-device", "cpu", "-no-progress"]


@pytest.fixture(autouse=True, scope="module")
def _started(tmp_path_factory):
    """Every multi-rank run of the module, started before its first test so
    that the tests without ranks (first in the file) run while they work: 2
    ranks (``world2``), 4 ranks (``world4``: the scans at 4 shards) and
    ``zero_shot_score -seq 2`` on 2 ranks of ``torch.distributed.run``."""
    rng = np.random.default_rng(11)
    inp = scan_inputs()
    inp.update({"ids": rng.integers(0, 16, (2, 64)), "cot": randn32(rng, 2, 64, 16),
                "windows": np.array(["".join(rng.choice(list("ACGT"), 64)) for _ in range(5)]),
                "halo_x": randn32(rng, 2, 16, 8), "halo_w": randn32(rng, 8, 4, sc=0.5),
                "halo_b": randn32(rng, 8, sc=0.1), "halo_cot": randn32(rng, 2, 16, 8),
                "coll_x": randn32(rng, 4, 3, 5), "coll_g": randn32(rng, 4, 4, 3, 5),
                "coll_p": randn32(rng, 4, 3, 5), "coll_s": randn32(rng, 4, 3, 5)})
    runs = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"ranks{world}")
        np.savez(d / "inputs.npz", **inp)
        runs[world] = Ranks(world, f"tests.torch_parallel_ranks:world{world}", d)
    d = tmp_path_factory.mktemp("cli")
    args = _cli_inputs(d)
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "plantcaduceus_tpu_torch.cli.zero_shot_score", *args, "-seq", "2",
         "-output", str(d / "two.tsv")],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, start_new_session=True)
    rd = tmp_path_factory.mktemp("refs")
    refs = subprocess.Popen(
        [sys.executable, "-m", "tests.torch_parallel_refs", str(rd)], cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
                 PYTHONPATH=os.pathsep.join([str(REPO), *sys.path])),
        stdout=open(rd / "log", "wb"), stderr=subprocess.STDOUT, start_new_session=True)
    yield runs, inp, (cli, d, args), (refs, rd, time.monotonic() + DEADLINE_S)
    for r in runs.values():
        r.wait()
    for proc in (cli, refs):
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()


@pytest.fixture(scope="module")
def jax_refs(_started):
    """The Pallas references of ``tests/torch_parallel_refs.py`` (its
    process joined, killed past the deadline)."""
    proc, d, end = _started[3]
    try:
        proc.wait(timeout=max(end - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.wait()
    assert proc.returncode == 0, (d / "log").read_text(errors="replace")[-4000:]
    return {k: dict(np.load(d / f"{k}.npz")) for k in ("k3", "shard_map_scan")}


@pytest.fixture(scope="module")
def ranks2(_started):
    """The 2-rank results (the ranks joined) and the inputs."""
    runs, inp = _started[:2]
    return runs[2].wait(), inp


@pytest.fixture(scope="module")
def ranks4(_started):
    runs, inp = _started[:2]
    return runs[4].wait(), inp


def _result(ranks, name):
    d, _ = ranks
    return dict(np.load(d / f"{name}.npz"))


# -- without ranks ------------------------------------------------------------------


@pytest.mark.parametrize("kw,n", [(dict(), 8), (dict(seq=2), 8), (dict(data=2, seq=4), 8),
                                  (dict(seq=3), 8), (dict(data=3, seq=2), 8),
                                  (dict(fsdp=2, tensor=2, pipe=2), 4)])
def test_mesh_config_resolve_matches_jax(kw, n):
    from plantcaduceus_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
    from plantcaduceus_tpu_torch.parallel.mesh import MeshConfig

    try:
        want = JaxMeshConfig(**kw).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            MeshConfig(**kw).resolve(n)
        assert str(got.value) == str(e)
    else:
        assert MeshConfig(**kw).resolve(n) == want


def test_mesh_rank_order_is_jax_device_order():
    """rank = (((d·F + f)·S + s)·T + t)·P + p, as JAX reshapes its devices."""
    from plantcaduceus_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
    from plantcaduceus_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from plantcaduceus_tpu_torch.parallel.mesh import AXES, MeshConfig, rank_grid

    devices = jax.devices()
    for kw in (dict(data=2, seq=4), dict(seq=8), dict(data=4, seq=2)):
        jm = jax_make_mesh(JaxMeshConfig(**kw), devices=devices)
        want = np.vectorize(lambda d: devices.index(d))(jm.devices)
        got = rank_grid(dict(zip(AXES, MeshConfig(**kw).resolve(8)))).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(MODELS))
def test_sp_refuses_activation_lora(name):
    from plantcaduceus_tpu_torch.models import caduceus
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.parallel.mesh import Axis

    cfg = CaduceusConfig(**MODELS[name])
    p = caduceus.Caduceus(cfg, caduceus.init_params(cfg, seed=0)).layers[0].params()
    mixer = caduceus.mamba2_mixer if name == "mamba2" else caduceus.mamba_mixer
    sp = Axis("seq", 2, 0, (0, 1), None, staged=True)
    with pytest.raises(NotImplementedError, match="activation-path LoRA does not compose"):
        mixer(p, torch.zeros(1, 8, cfg.d_model), cfg, lora={"adapters": {}, "scale": 1.0},
              sp=sp)


def test_nccl_collectives_refuse_host_tensors():
    """Under NCCL (an axis not staged through the host) every collective
    refuses a tensor on the host before the backend sees it; under gloo the
    backend gets a host copy."""
    from plantcaduceus_tpu_torch.parallel import collectives
    from plantcaduceus_tpu_torch.parallel.mesh import Axis

    t = torch.ones(2, 3)
    nccl = Axis("data", 2, 0, (0, 1), None, staged=False)
    with pytest.raises(ValueError, match="NCCL takes tensors on the rank's card, got one on cpu"):
        collectives._buffer(t, nccl)
    for op in (collectives.all_gather, collectives.psum,
               lambda v, a: collectives.ppermute(v, a, [(0, 1)]),
               collectives.psum_scatter, collectives.all_gather_tiled, collectives.broadcast):
        with pytest.raises(ValueError, match="NCCL takes tensors on the rank's card"):
            op(t, nccl)
    buf = collectives._buffer(t, Axis("data", 2, 0, (0, 1), None, staged=True))
    assert buf.device.type == "cpu" and buf.data_ptr() != t.data_ptr()
    assert torch.equal(buf, t)


@pytest.mark.parametrize("kw", [dict(replicated=False), dict(pipeline=True)])
def test_sharded_param_specs_refused(kw):
    """The FSDP rule (``replicated=False``) and the pipeline layout
    (``pipeline=True``: the n_layer axis of every block leaf over pipe)
    against JAX's, on leaves that carry no tensor axis; the tensor rule is
    held to JAX's in ``tests/test_torch_tensor.py``."""
    from plantcaduceus_tpu.parallel.mesh import param_specs as jax_param_specs
    from plantcaduceus_tpu_torch.parallel.mesh import param_specs

    assert param_specs()("blocks/in_proj_x", (2, 1, 16, 32)) == ()
    rule, jax_rule = param_specs(**kw), jax_param_specs(**kw)
    for path, shape in (("embedding", (16, 384)), ("norm_f_weight", (384,)),
                        ("lm_head", (16, 384)), ("blocks/norm_weight", (20, 384)),
                        ("tie", (8, 8)), ("scalar", (1,)), ("blocks/x", (1, 6, 6))):
        assert rule(path, shape) == tuple(jax_rule(path, shape)), path


@pytest.mark.parametrize("flag", ["--tensor", "--pipe", "--pipe-microbatches"])
def test_pretrain_refuses_unported_axes(flag, capsys):
    """The tensor and pipe flags are live now (their refusals are JAX's,
    ``tests/test_torch_tensor.py``, ``tests/test_torch_pipeline.py``): each
    parses to its value and says nothing of an unported axis."""
    from plantcaduceus_tpu_torch.cli import pretrain

    args = pretrain.parse_args(["--dataset", "synthetic", "--output-dir", "x", flag, "2"])
    assert getattr(args, flag.lstrip("-").replace("-", "_")) == 2
    assert "not ported" not in capsys.readouterr().err


SINGLE_DEVICE_CLIS = ("ar_lm", "mutagenesis", "format_vcf")


@pytest.mark.parametrize("cli", SINGLE_DEVICE_CLIS)
def test_single_device_entry_points_refuse_several_ranks(cli, monkeypatch):
    """The entry points whose JAX CLIs build no mesh."""
    import importlib

    monkeypatch.setenv("WORLD_SIZE", "2")
    mod = importlib.import_module(f"plantcaduceus_tpu_torch.cli.{cli}")
    with pytest.raises(SystemExit, match="runs on one device, as the JAX package's CLI does"):
        mod.main(["--help"])


# -- the train step and the model (JAX's references first: the ranks run meanwhile) --


def _jax_cfg_params(name, seed):
    from plantcaduceus_tpu.models.config import CaduceusConfig as JaxConfig
    from plantcaduceus_tpu_torch.compat.params import to_jax_params
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig

    cfg = CaduceusConfig(**MODELS[name])
    model = Caduceus(cfg, init_params(cfg, seed=seed))
    # JAX's sequential reference scan: the associative one's function in less
    # compile time
    jax_kw = dict(scan_impl="sequential") if name == "mamba1" else {}
    return JaxConfig(**MODELS[name], **jax_kw), model, to_jax_params(model)


def _as_jax_tree(model, by_name):
    """A dict of tensors keyed by the model's parameter names, as JAX's
    parameter tree."""
    from plantcaduceus_tpu_torch.compat.params import to_jax_params

    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.as_tensor(by_name[n]))
    return to_jax_params(model)


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jax_train():
    """2 steps of JAX ``make_train_step`` on one device (grad-accum 2): each
    step's metrics and the weights after them; and the port's model."""
    from plantcaduceus_tpu.parallel import mesh as jax_mesh
    from plantcaduceus_tpu.train import step as jax_step
    from plantcaduceus_tpu.train.optimizer import make_optimizer as jax_opt
    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu_torch.train import data as data_lib

    jcfg, model, params = _jax_cfg_params("mamba1", 2)
    params = jax.tree.map(jnp.asarray, params)
    mesh = jax_mesh.make_mesh(jax_mesh.MeshConfig(data=1), devices=jax.devices()[:1])
    tx = jax_opt(learning_rate=1e-3, warmup_steps=1, total_steps=3, params=params)
    init, step, _ = jax_step.make_train_step(jcfg, tx, mesh, params, dtype=jnp.float32,
                                             remat=False, grad_accum=2)
    seqs = data_lib.sequence_source("synthetic", window=64, synthetic_n=64, seed=3)
    ds = data_lib.PretrainDataset(seqs, DnaTokenizer(), 4, seed=3)
    state, metrics = init(params), []
    for s in range(2):
        state, m = step(state, {k: jnp.asarray(v) for k, v in ds.batch_at(s).items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _leaves(jax.device_get(state.params)), model


@pytest.mark.parametrize("run", ["train_data2", "train_seq2"],
                         ids=["data2_seq1", "data1_seq2"])
def test_train_steps_match_jax_one_device(jax_train, ranks2, run):
    """2 steps at grad-accum 2 (remat on the ranks) against JAX's."""
    metrics, want_p, model = jax_train
    got = _result(ranks2, run)
    for s, m in enumerate(metrics):
        assert float(got[f"loss{s}"]) == pytest.approx(m["loss"], rel=1e-5), s
        assert float(got[f"accuracy{s}"]) == pytest.approx(m["accuracy"], abs=1e-6), s
        assert float(got[f"grad_norm{s}"]) == pytest.approx(m["grad_norm"], rel=1e-4), s
    assert np.isfinite(float(got["eval_loss"])) and 0 <= float(got["eval_accuracy"]) <= 1
    got_p = _leaves(_as_jax_tree(model, {k[2:]: v for k, v in got.items()
                                         if k.startswith("p_")}))
    for k, v in want_p.items():
        np.testing.assert_allclose(got_p[k], v, rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", list(MODELS))
def test_model_seq2_matches_jax_single_device(ranks2, name):
    """Logits at seq 2 and the gradient of sum(logits * cot)."""
    from plantcaduceus_tpu.models import caduceus as jax_caduceus

    jcfg, model, params = _jax_cfg_params(name, 5)
    inp = ranks2[1]
    ids, cot = jnp.asarray(inp["ids"], jnp.int32), jnp.asarray(inp["cot"])
    fwd = lambda p: jax_caduceus.forward(p, ids, jcfg, dtype=jnp.float32)["logits"]
    want_logits, (want_grads,) = _value_and_vjp(fwd, [jax.tree.map(jnp.asarray, params)], cot)
    got = _result(ranks2, f"model_{name}")
    _close(got["logits"], want_logits, FWD_TOL, "logits")
    got_grads = _leaves(_as_jax_tree(model, {k[2:]: v for k, v in got.items()
                                             if k.startswith("g_")}))
    for k, g in _leaves(want_grads).items():
        _close(got_grads[k], g, GRAD_TOL, k)


def test_zero_shot_score_seq2_matches_one_process(_started):
    """``zero_shot_score -seq 2`` on 2 ranks of ``torch.distributed.run``
    writes the same bytes as one process (fp32, a tiny HF checkpoint)."""
    from plantcaduceus_tpu_torch.cli import zero_shot_score

    proc, d, args = _started[2]
    zero_shot_score.main(args + ["-output", str(d / "one.tsv")])
    try:
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    assert proc.returncode == 0, out.decode()[-4000:]
    assert (d / "two.tsv").read_bytes() == (d / "one.tsv").read_bytes()


# -- sharded scans ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def m1_reference(pre):
    """JAX's single-device Mamba-1 scan of the group layout (group 1
    reversed, dt projected outside when fused), and its jax.grad."""
    inp = scan_inputs()
    names = ["x", "dt", "A", "Bm", "Cm", "Ds", "dtb"] + (["W"] if pre == "m1f_" else [])
    args = [jnp.asarray(inp[pre + k]) for k in names]
    flip1 = lambda t: t.at[1].set(jnp.flip(t[1], axis=1))

    def f(x, dt, A, Bm, Cm, Ds, dtb, W=None):
        if W is not None:
            dt = jnp.einsum("gblr,gri->gbli", dt, W)
        y = selective_scan_sequential(flip1(x), flip1(dt), A, flip1(Bm), flip1(Cm), Ds,
                                      dt_bias=dtb)
        return flip1(y)

    y, grads = _value_and_vjp(f, args, jnp.asarray(inp[pre + "cot"]))
    return y, dict(zip(names, grads))


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("pre", ["m1f_", "m1u_"], ids=["fused_dt", "dt_given"])
def test_seq_sharded_scan_matches_jax_single_device(ranks2, ranks4, pre, shards):
    got = _result(ranks2 if shards == 2 else ranks4, pre + "scan")
    want_y, want_g = m1_reference(pre)
    _close(got["y"], want_y, FWD_TOL, "y")
    for k, g in want_g.items():
        _close(got["d_" + k], g, GRAD_TOL, "d" + k)


@functools.lru_cache(maxsize=None)
def ssd_reference(reverse):
    from plantcaduceus_tpu.ops.pallas_ssd import ssd_dir_xla

    inp = scan_inputs()
    names = ("x", "dt", "A", "Bm", "Cm", "Ds", "dtb")
    args = [jnp.asarray(inp["ssd_" + k]) for k in names]
    chunk = int(inp["ssd_chunk"])
    y, grads = _value_and_vjp(lambda *a: ssd_dir_xla(*a, chunk, reverse), args,
                              jnp.asarray(inp["ssd_cot"]))
    return y, dict(zip(names, grads))


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("reverse", [False, True])
def test_ssd_seq_sharded_matches_jax_single_device(ranks2, ranks4, reverse, shards):
    got = _result(ranks2 if shards == 2 else ranks4, f"ssd{int(reverse)}_scan")
    want_y, want_g = ssd_reference(reverse)
    _close(got["y"], want_y, FWD_TOL, "y")
    for k, g in want_g.items():
        _close(got["d_" + k], g, GRAD_TOL, "d" + k)


@pytest.mark.parametrize("reverse", [False, True])
def test_ssd_seq_sharded_forward_matches_jax_shard_map(ranks2, reverse):
    """Against JAX's ``ssd_dir_seq_sharded(impl="xla")`` on 2 devices."""
    from plantcaduceus_tpu.ops.ssd_seq_parallel import ssd_dir_seq_sharded

    inp = ranks2[1]
    got = _result(ranks2, f"ssd{int(reverse)}_scan")
    args = [jnp.asarray(inp["ssd_" + k]) for k in ("x", "dt", "A", "Bm", "Cm", "Ds", "dtb")]
    lspec = P(None, "seq", None)
    f = jax.shard_map(
        lambda *a: ssd_dir_seq_sharded(*a, int(inp["ssd_chunk"]), reverse, "seq", 2,
                                       impl="xla"),
        mesh=Mesh(np.asarray(jax.devices()[:2]), ("seq",)),
        in_specs=(lspec, lspec, P(), lspec, lspec, P(), P()), out_specs=lspec,
        check_vma=False)
    _close(got["y"], jax.jit(f)(*args), FWD_TOL, "y vs shard_map")


@pytest.mark.parametrize("anticausal", [False, True])
def test_halo_conv_matches_jax(ranks2, anticausal):
    inp = ranks2[1]
    x, w, b, cot = (jnp.asarray(inp["halo_" + k]) for k in ("x", "w", "b", "cot"))
    lspec = P(None, "seq", None)
    f = jax.shard_map(lambda x, w, b: jax_halo(x, w, b, anticausal, "seq", 2),
                      mesh=Mesh(np.asarray(jax.devices()[:2]), ("seq",)),
                      in_specs=(lspec, P(), P()), out_specs=lspec, check_vma=False)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) * cot), argnums=(0, 1, 2)))(x, w, b)
    got = _result(ranks2, f"halo{int(anticausal)}")
    _close(got["y"], jax.jit(f)(x, w, b), FWD_TOL, "y")
    for k, g in zip("xwb", grads):
        _close(got["d_" + k], g, GRAD_TOL, "d" + k)


def test_collective_adjoints_at_4_ranks(ranks4):
    """``all_gather`` (adjoint: each rank's slice of the summed cotangents,
    a reduce-scatter), ``ppermute`` i -> i + 1 (adjoint: the reverse
    permutation, zeros at the last rank) and ``psum`` (adjoint: the sum),
    as ``jax.lax`` transposes them."""
    inp = ranks4[1]
    got = _result(ranks4, "collectives")
    x, g, p, s = (inp[k] for k in ("coll_x", "coll_g", "coll_p", "coll_s"))
    np.testing.assert_array_equal(got["gather"], np.broadcast_to(x, (4,) + x.shape))
    np.testing.assert_array_equal(got["permute"], np.concatenate([np.zeros_like(x[:1]), x[:-1]]))
    np.testing.assert_allclose(got["sum"], np.broadcast_to(x.sum(0), x.shape), rtol=1e-6)
    want = g.sum(0) + np.concatenate([p[1:], np.zeros_like(p[:1])]) + s.sum(0)
    np.testing.assert_allclose(got["grad"], want, rtol=1e-6, atol=1e-6)


def test_seq_with_tensor_refused_with_jax_message(ranks4):
    """``MeshConfig(seq=2, tensor=2)`` over 4 ranks: JAX's
    ``make_grad_fn`` message (``train/step.py``)."""
    msg = str(_result(ranks4, "seq_tensor")["msg"])
    assert msg == ("sequence and tensor parallelism cannot be combined "
                   "(the context-parallel mixer needs unsharded d_inner)")


def test_striped_scores_match_one_process(ranks2):
    """5 records over data 2 through the runner's row split (each padded
    batch of 2 rows split 1 and 1, the rows gathered back), against one
    process at the rows of a rank's forward (batch 1), bit for bit."""
    from plantcaduceus_tpu_torch.engine import zero_shot
    from plantcaduceus_tpu_torch.engine.runner import InferenceRunner
    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig

    cfg = CaduceusConfig(**TINY)
    runner = InferenceRunner(Caduceus(cfg, init_params(cfg, seed=5)), cfg,
                             dtype=torch.float32, batch_size=1, device="cpu")
    want = zero_shot.nucleotide_probs(runner, DnaTokenizer(),
                                      [str(s) for s in ranks2[1]["windows"]], 32,
                                      progress=False)
    np.testing.assert_array_equal(_result(ranks2, "row_split")["probs"], want)


# -- JAX's Pallas references, last: their process runs meanwhile -------------------


def test_seq_sharded_scan_forward_matches_jax_shard_map(ranks2, jax_refs):
    """The port against JAX's own sharded scan (2 shards, fused dt, both
    directions; Pallas in interpret mode, bl 32, bd 16;
    ``tests/torch_parallel_refs.py``)."""
    _close(_result(ranks2, "m1f_scan")["y"], jax_refs["shard_map_scan"]["y"], FWD_TOL, "y")


@pytest.mark.parametrize("fuse,reverse", K3_CASES,
                         ids=["fused_dt-fwd", "fused_dt-rev", "dt_given-fwd", "dt_given-rev"])
def test_plain_k3_g0_dh0_match_pallas(jax_refs, fuse, reverse):
    """The plain K3 with a g0 seed and emit_dh0 against
    ``_pallas_bwd_group(g0=..., emit_dh0=True)`` over two 16-step chunks
    (interpret mode; ``tests/torch_parallel_refs.py``)."""
    c = {k: jax_refs["k3"][k3_key(fuse, reverse, k)]
         for k in ("x", "gy", "dt", "A", "Bm", "Cm", "Ds", "dtb", "hb", "w", "g0")}
    want = lambda k: jax_refs["k3"][k3_key(fuse, reverse, "want_" + k)]
    T = torch.from_numpy
    got = scan_bwd_plain(*(T(c[k]) for k in ("x", "gy", "dt", "A", "Bm", "Cm", "Ds", "dtb",
                                             "hb")), T(c["w"]) if fuse else None,
                         reverse, 16, g0=T(c["g0"]), emit_dh0=True)
    names = ("dx", "ddt", "dB", "dC", "dA", "ddtb", "dD", "dW", "dh0")
    for k, g in zip(names, got):
        if k == "dW" and not fuse:
            continue
        _close(g.numpy(), want(k) if k == "dh0" else want(k)[0], FWD_TOL, k)
