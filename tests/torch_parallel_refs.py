"""JAX's Pallas references for ``tests/test_torch_parallel.py``, computed in
a process of their own while the test process computes the rest.

Pallas's interpret mode runs one program at a time in a process, and these
two take most of the module's time: the plain K3's ``g0``/``emit_dh0``
cases against ``_pallas_bwd_group`` and JAX's ``selective_scan_seq_sharded``
under ``shard_map``. The test module starts this (``python -m
tests.torch_parallel_refs <workdir>``) with its ranks, and it writes
``k3.npz`` (each case's inputs, the plain forward's chunk-entry states and
JAX's outputs) and ``shard_map_scan.npz`` to the work directory.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

K3_CASES = [(fuse, reverse) for fuse in (True, False) for reverse in (False, True)]
K3_OUTPUTS = ("dx", "ddt", "dA", "dB", "dC", "dD", "ddtb", "dW", "dh0")  # JAX's order


def k3_key(fuse, reverse, name):
    return f"{'fused' if fuse else 'given'}_{'rev' if reverse else 'fwd'}_{name}"


def k3_cases() -> dict:
    """Per (fuse, reverse): the inputs (numpy, a seed), the plain forward's
    chunk-entry states (processing order, as both read them), and JAX's
    ``_pallas_bwd_group(g0=..., emit_dh0=True)`` on them in interpret mode,
    all four in one compiled program."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from jax.experimental.pallas import tpu as pltpu

    from plantcaduceus_tpu.ops import pallas_scan
    from plantcaduceus_tpu_torch.ops.cuda_scan import scan_fwd_plain
    from tests.torch_parallel_ranks import randn32

    rng = np.random.default_rng(92)
    B, L, D, N, R = 1, 32, 16, 4, 3
    x, gy, Bm, Cm = (randn32(rng, B, L, D), randn32(rng, B, L, D), randn32(rng, B, L, N),
                     randn32(rng, B, L, N))
    A, Ds, dtb = -np.exp(randn32(rng, D, N, sc=0.5)), randn32(rng, D), randn32(rng, D, sc=0.3)
    w, g0 = randn32(rng, R, D, sc=0.3), randn32(rng, B, D, N, sc=0.5)
    T = torch.from_numpy
    cases = {}
    for fuse, reverse in K3_CASES:
        dt = randn32(rng, B, L, R if fuse else D, sc=0.5)
        _, hb = scan_fwd_plain(T(x), T(dt), T(A), T(Bm), T(Cm), T(Ds), T(dtb),
                               T(w) if fuse else None, reverse, hb_chunk=16)
        cases[fuse, reverse] = dict(x=x, gy=gy, dt=dt, A=A, Bm=Bm, Cm=Cm, Ds=Ds, dtb=dtb,
                                    w=w, g0=g0, hb=hb.numpy())

    def pallas_all():
        J = lambda v: jnp.asarray(v[None])
        return [pallas_scan._pallas_bwd_group(
            J(c["x"]), J(c["dt"]), J(c["A"]), J(c["Bm"]), J(c["Cm"]), J(c["Ds"]), J(c["dtb"]),
            J(c["w"]) if fuse else None, J(c["gy"]), jnp.asarray(c["hb"]), 16, 16, fuse,
            g0=jnp.asarray(c["g0"]), emit_dh0=True, reverse=reverse)
            for (fuse, reverse), c in cases.items()]

    with pltpu.force_tpu_interpret_mode():
        wants = jax.jit(pallas_all)()
    out = {}
    for (fuse, reverse), want in zip(cases, wants):
        c = cases[fuse, reverse]
        c.update({"want_" + n: np.asarray(t) for n, t in zip(K3_OUTPUTS, want) if t is not None})
        out.update({k3_key(fuse, reverse, k): v for k, v in c.items()})
    return out


def shard_map_scan():
    """JAX's ``selective_scan_seq_sharded`` on :func:`scan_inputs`'s fused-dt
    case over 2 devices, both directions (Pallas in interpret mode, bl 32,
    bd 16)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental.pallas import tpu as pltpu
    from jax.sharding import Mesh, PartitionSpec as P

    from plantcaduceus_tpu.ops.seq_parallel import selective_scan_seq_sharded
    from tests.torch_parallel_ranks import scan_inputs

    inp = scan_inputs()
    names = ("x", "dt", "A", "Bm", "Cm", "Ds", "dtb", "W")
    x, dt, A, Bm, Cm, Ds, dtb, W = (jnp.asarray(inp["m1f_" + k]) for k in names)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("seq",))
    lspec = P(None, None, "seq", None)

    def local(x, dt, Bm, Cm):
        return selective_scan_seq_sharded(x, dt, A, Bm, Cm, Ds, dtb, W, "seq", 2,
                                          directions=(False, True), bl=32, bd=16)

    f = jax.shard_map(local, mesh=mesh, in_specs=(lspec,) * 4, out_specs=lspec,
                      check_vma=False)
    with pltpu.force_tpu_interpret_mode():
        return {"y": np.asarray(jax.jit(f)(x, dt, Bm, Cm))}


def main(workdir: Path) -> None:
    import numpy as np

    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ.setdefault("PCAD_PLATFORM", "cpu")
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    # XLA's optimisation passes off: the same functions, compiled in less time
    jax.config.update("jax_disable_most_optimizations", True)
    torch.set_num_threads(1)
    np.savez(workdir / "k3.npz", **k3_cases())
    np.savez(workdir / "shard_map_scan.npz", **shard_map_scan())


if __name__ == "__main__":
    main(Path(sys.argv[1]))
