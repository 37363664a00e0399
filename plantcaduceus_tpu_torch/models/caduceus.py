"""Caduceus (bidirectional, RC-equivariant) masked LM in PyTorch.

Counterpart of ``plantcaduceus_tpu.models.caduceus``: the Mamba-1 family
(the released models) and the SSD (Mamba-2) family of the ``*-ssd``
presets. The same flattened formulation:

* **RC stream folding.** The residual stream is ``[2B, L, d]``; rows ``B:``
  hold the network state of the reverse-complemented input in its working
  frame, so every layer treats both streams alike. The RCPS frame changes
  reduce to embedding the RC token ids as extra rows, and one flip plus a
  complement gather in the LM head and the hidden-state readout.
* **Direction folding.** Per-direction weights are stacked on a leading
  group axis ``G``; the reverse direction runs an anticausal conv and a
  right-to-left scan, with no flipped copies.

Mixer paths:

* tied in/out projections with the ``add`` combine (the released models):
  at d_inner <= 768 (JAX's threshold, ``caduceus.py:455``) kernel K2's
  ``fuse_in`` variant (``ops.cuda_mixer.bimamba_mixer_fused_x``: in_proj's
  x half inside the kernel, xi kept in float32 and never in device memory)
  once per direction; above it in_proj with ``torch.matmul``, then K2 with
  xi given; then the gate, out_proj;
* the same configs with ``PCAD_GATED_KERNEL=1`` in the environment at
  import (JAX's switch, ``caduceus.py:59``; not under ``sp``): in_proj,
  conv and x_proj in plain PyTorch (with any adapters, summed over
  ``tp``), then ``ops.cuda_scan.bimamba_scan_gated`` (K1 forward, K1
  reverse with the ``combine`` epilogue; K1-hb and K3 under training),
  out_proj;
* everything else (untied, ``ew_multiply``, unidirectional): conv and
  x_proj in plain PyTorch, then kernel K1 (``ops.cuda_scan``) per
  direction, with dt projected inside the kernel when G=2 and outside when
  G=1, as the JAX package does;
* Mamba-2 (:func:`mamba2_mixer`): five in-projections with ``torch.matmul``,
  kernel K5 (``ops.cuda_mixer2``: conv, SiLU, the SSD chunk scan, the gated
  RMS norm) once per direction, out_proj;
* activation-path LoRA (``lora=``, PEFT's dropout semantics): Mamba-1 takes
  the K1 route for every config, tied + add included, with the adapter
  deltas at in_proj, x_proj and out_proj; Mamba-2 keeps K5, its adapted
  sites all being outside the interior.

* context parallelism (``sp=``, a ``parallel.mesh.Axis`` over which L is
  sharded; JAX's ``sp_axis``): Mamba-1 runs in_proj, the halo-exchanging
  conv (``ops.conv.halo_depthwise_conv_silu``), x_proj, then the two-pass
  sharded scan (``ops.seq_parallel``: K1 with h0/hfin, K3 with g0/dh0) per
  direction; K2 does not run there, as in JAX. Mamba-2 runs the five
  in-projections, halo convs, the sharded SSD (``ops.ssd_seq_parallel``:
  K4, K6) and the gated norm; K5 does not run there. The RC stream's flip
  and the LM head's flip reverse the shard order too.

* tensor parallelism (``tp=``, a ``parallel.mesh.Axis`` over which the
  mixers' d_inner axis is sharded; JAX's ``tp_axis``): the layer's weights
  are this rank's slices (``parallel.mesh.tensor_dims``). Mamba-1 runs the
  decomposed route as JAX does there: in_proj, conv and x_proj at the local
  d_inner, one sum over ``tp`` of x_proj's dt/B/C products (both
  directions' in one all-reduce), K1 (K1-hb and K3 under training) per
  direction with dt_proj fused, the gate, out_proj and its sum; K2 does not
  run there, as in JAX. Mamba-2 shards heads (``n_groups`` must be 1): the
  five in-projections (B and C whole on every rank), the three convs, K4
  (K4 with chunk-entry states and K6 in plain mode under training) per
  direction, the gate, the gated RMS norm with its sum of squares summed
  over ``tp``, out_proj and its sum; K5 does not run there. The input
  enters through ``tp_boundary`` (the identity, its adjoint a sum), the
  sums feeding the sharded scans sum their adjoints too (``psum_psum_bwd``)
  and out_proj's does not (``psum_id_bwd``), as JAX's custom VJPs.

Under training (grad enabled, and the input or a weight requiring it) the
same paths go through autograd Functions: ``BimambaMixerFn`` (K2's residual
variant, K3 in the backward; the ``fuse_in`` route takes it after an
in_proj in the compute dtype, as JAX's VJP does), ``SelectiveScanFn`` (K1
with chunk-entry states, K3), ``BimambaScanGatedFn`` (K1-hb, K3) and
``Mamba2InteriorFn`` (K5's residual variant, K6 in ``pre_silu`` mode in the
backward).
Under ``no_grad``/``inference_mode`` the inference kernels run. Weights are
float32 master copies; compute runs in the forward's ``dtype`` with a
float32 residual stream, as in the JAX package. On CPU tensors the kernel
wrappers run their plain versions.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from plantcaduceus_tpu_torch.models.config import CaduceusConfig
from plantcaduceus_tpu_torch.ops.conv import causal_conv1d, halo_depthwise_conv_silu
from plantcaduceus_tpu_torch.ops.cuda_mixer import (bimamba_mixer, bimamba_mixer_fused,
                                                    bimamba_mixer_fused_x)
from plantcaduceus_tpu_torch.ops.cuda_mixer2 import (mamba2_mixer_interior,
                                                     mamba2_mixer_interior_plain,
                                                     mamba2_mixer_interior_train)
from plantcaduceus_tpu_torch.ops.cuda_scan import (bimamba_scan_gated, scan_fwd,
                                                   scan_fwd_plain, selective_scan)
from plantcaduceus_tpu_torch.ops.norms import layer_norm, rms_norm
from plantcaduceus_tpu_torch.ops.seq_parallel import scan_seq_sharded
from plantcaduceus_tpu_torch.ops.ssd_seq_parallel import ssd_dir_seq_sharded
from plantcaduceus_tpu_torch.ops.cuda_ssd import ssd_dir, ssd_dir_plain, ssd_dir_train
from plantcaduceus_tpu_torch.parallel.collectives import (ppermute, psum_id_bwd, psum_psum_bwd,
                                                          tp_boundary)

# JAX's PCAD_GATED_KERNEL switch (caduceus.py:59), read once at import.
_USE_GATED_KERNEL = os.environ.get("PCAD_GATED_KERNEL") == "1"
# The widest d_inner whose tied + add mixer fuses in_proj into K2 (JAX
# caduceus.py:455, measured there on a TPU v5e; kept as it is).
FUSE_IN_MAX_D_INNER = 768

LAYER_KEYS = ("norm_weight", "in_proj_x", "in_proj_z", "out_proj", "conv_w",
              "conv_b", "x_proj_dt", "x_proj_B", "x_proj_C", "dt_proj_w",
              "dt_proj_b", "A_log", "D")
LAYER_KEYS_MAMBA2 = ("norm_weight", "in_proj_x", "in_proj_z", "in_proj_B", "in_proj_C",
                     "in_proj_dt", "conv_x_w", "conv_x_b", "conv_B_w", "conv_B_b",
                     "conv_C_w", "conv_C_b", "mixer_norm_weight", "out_proj", "dt_bias",
                     "A_log", "D")


def layer_keys(cfg: CaduceusConfig):
    """The block leaves of ``cfg``'s SSM variant, in the JAX layout."""
    return LAYER_KEYS_MAMBA2 if cfg.ssm_variant == "mamba2" else LAYER_KEYS


# ---------------------------------------------------------------------------
# Initialisation (the distributions of the JAX init_params / mamba_ssm)
# ---------------------------------------------------------------------------


def _uniform(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen) * (hi - lo) + lo


def _linear_init(gen, fan_in, shape):
    """Kaiming-uniform, torch nn.Linear default: U(-1/sqrt(fan_in), +)."""
    bound = 1.0 / math.sqrt(fan_in)
    return _uniform(gen, shape, -bound, bound)


def _dt_bias_init(gen, shape, dt_min=1e-3, dt_max=1e-1, dt_floor=1e-4):
    """softplus(bias) ~ LogUniform(dt_min, dt_max)."""
    u = torch.rand(shape, generator=gen)
    dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
    dt = dt.clamp(min=dt_floor)
    return dt + torch.log(-torch.expm1(-dt))  # inverse softplus


def init_params(cfg: CaduceusConfig, generator: Optional[torch.Generator] = None,
                seed: int = 0) -> dict:
    """Parameter dict in the JAX package's layout (block leaves stacked on a
    leading n_layer axis), float32 on the CPU, drawn from ``generator``
    (default: a new one seeded with ``seed``). The numbers differ from JAX's
    for the same seed; the distributions are the same."""
    gen = generator if generator is not None else torch.Generator().manual_seed(seed)
    if cfg.ssm_variant == "mamba2":
        return _init_params_mamba2(cfg, gen)
    d, di, N, R, K = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dt_rank, cfg.d_conv
    G = cfg.n_directions
    Gio = 1 if (cfg.bidirectional_weight_tie or G == 1) else G
    nl = cfg.n_layer
    in_proj = _linear_init(gen, d, (nl, Gio, d, 2 * di))
    x_proj = _linear_init(gen, di, (nl, G, di, R + 2 * N))
    params = {
        "embedding": 0.02 * torch.randn((cfg.vocab_size, d), generator=gen),
        "blocks": {
            "norm_weight": torch.ones((nl, d)),
            "in_proj_x": in_proj[..., :di].contiguous(),
            "in_proj_z": in_proj[..., di:].contiguous(),
            # rescale_prenorm_residual: out_proj /= sqrt(2 * n_layer)
            "out_proj": _linear_init(gen, di, (nl, Gio, di, d)) / math.sqrt(2 * nl),
            "conv_w": _linear_init(gen, K, (nl, G, di, K)),
            "conv_b": _linear_init(gen, K, (nl, G, di)),
            "x_proj_dt": x_proj[..., :R].contiguous(),
            "x_proj_B": x_proj[..., R:R + N].contiguous(),
            "x_proj_C": x_proj[..., R + N:].contiguous(),
            "dt_proj_w": _uniform(gen, (nl, G, R, di), -(R ** -0.5), R ** -0.5),
            "dt_proj_b": _dt_bias_init(gen, (nl, G, di)),
            "A_log": torch.log(torch.arange(1, N + 1, dtype=torch.float32)
                               .expand(nl, G, di, N).contiguous()),
            "D": torch.ones((nl, G, di)),
        },
        "norm_f_weight": torch.ones((d,)),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = 0.02 * torch.randn((cfg.vocab_size, d), generator=gen)
    return params


def _init_params_mamba2(cfg: CaduceusConfig, gen: torch.Generator) -> dict:
    """The SSD (Mamba-2) variant (JAX ``_init_params_mamba2``): A ~ U(1, 16)
    per head, dt bias log-uniform, D = 1, gated-RMSNorm weight 1; in/out
    projections and the norm weight tied across directions when
    ``bidirectional_weight_tie``, the B/C/dt projections per direction."""
    d, di, N, K = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.d_conv
    H, NGN = cfg.n_heads, cfg.n_groups * cfg.d_state
    G = cfg.n_directions
    Gio = 1 if (cfg.bidirectional_weight_tie or G == 1) else G
    nl = cfg.n_layer
    in_proj = _linear_init(gen, d, (nl, Gio, d, 2 * di))
    params = {
        "embedding": 0.02 * torch.randn((cfg.vocab_size, d), generator=gen),
        "blocks": {
            "norm_weight": torch.ones((nl, d)),
            "in_proj_x": in_proj[..., :di].contiguous(),
            "in_proj_z": in_proj[..., di:].contiguous(),
            "in_proj_B": _linear_init(gen, d, (nl, G, d, NGN)),
            "in_proj_C": _linear_init(gen, d, (nl, G, d, NGN)),
            "in_proj_dt": _linear_init(gen, d, (nl, G, d, H)),
            "conv_x_w": _linear_init(gen, K, (nl, G, di, K)),
            "conv_x_b": _linear_init(gen, K, (nl, G, di)),
            "conv_B_w": _linear_init(gen, K, (nl, G, NGN, K)),
            "conv_B_b": torch.zeros((nl, G, NGN)),
            "conv_C_w": _linear_init(gen, K, (nl, G, NGN, K)),
            "conv_C_b": torch.zeros((nl, G, NGN)),
            "mixer_norm_weight": torch.ones((nl, Gio, di)),
            # rescale_prenorm_residual: out_proj /= sqrt(2 * n_layer)
            "out_proj": _linear_init(gen, di, (nl, Gio, di, d)) / math.sqrt(2 * nl),
            "dt_bias": _dt_bias_init(gen, (nl, G, H)),
            "A_log": torch.log(_uniform(gen, (nl, G, H), 1.0, 16.0)),
            "D": torch.ones((nl, G, H)),
        },
        "norm_f_weight": torch.ones((d,)),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = 0.02 * torch.randn((cfg.vocab_size, d), generator=gen)
    return params


# ---------------------------------------------------------------------------
# Module
# ---------------------------------------------------------------------------


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t.detach().float().clone().contiguous(), requires_grad=False)


class CaduceusLayer(nn.Module):
    """One block's weights, in the JAX layout without the n_layer axis."""

    def __init__(self, tensors: Dict[str, torch.Tensor], keys=LAYER_KEYS):
        super().__init__()
        self.keys = tuple(keys)
        for k in self.keys:
            setattr(self, k, _param(tensors[k]))

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in self.keys}


class Caduceus(nn.Module):
    """Caduceus masked LM, Mamba-1 or Mamba-2 by ``cfg.ssm_variant``. Weights
    are kept in float32; each forward casts them to its compute ``dtype``
    where the JAX package does. They are built frozen for scoring;
    ``requires_grad_()`` makes them train."""

    def __init__(self, cfg: CaduceusConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.embedding = _param(params["embedding"])
        self.norm_f_weight = _param(params["norm_f_weight"])
        self.lm_head = _param(params["lm_head"]) if "lm_head" in params else None
        blocks = params["blocks"]
        keys = layer_keys(cfg)
        self.layers = nn.ModuleList(
            CaduceusLayer({k: blocks[k][i] for k in keys}, keys)
            for i in range(cfg.n_layer))
        self.register_buffer("cmap", torch.tensor(cfg.complement_map, dtype=torch.long),
                             persistent=False)

    def forward(self, input_ids: torch.Tensor, dtype=torch.bfloat16,
                output_hidden_states: bool = False, all_hidden_states: bool = False,
                use_kernels: bool = True, remat: bool = False,
                sp=None, tp=None) -> Dict[str, torch.Tensor]:
        return forward(self, input_ids, dtype=dtype,
                       output_hidden_states=output_hidden_states,
                       all_hidden_states=all_hidden_states, use_kernels=use_kernels,
                       remat=remat, sp=sp, tp=tp)


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------


def _sp_flip(x: torch.Tensor, sp, dim: int) -> torch.Tensor:
    """Flip a possibly sequence-sharded axis globally: the local flip, then
    the shard order reversed over ``sp`` (JAX ``_sp_flip``). Differentiable."""
    x = x.flip(dim)
    if sp is None or sp.size == 1:
        return x
    return ppermute(x, sp, [(i, sp.size - 1 - i) for i in range(sp.size)])


def rc_ids(input_ids: torch.Tensor, cmap: torch.Tensor, sp=None) -> torch.Tensor:
    """Reverse-complement token ids: complement map, then reverse along L
    (across the shards of ``sp`` too)."""
    return _sp_flip(cmap[input_ids], sp, -1)


SP_MAMBA_MSG = ("sequence parallelism needs bidirectional 'add', tied in_proj, "
                "and no tensor axis")
SP_LORA_MSG = ("activation-path LoRA does not compose with tensor/sequence "
               "axes; merge adapters (train.lora.merge_lora) instead")
TP_GROUPS_MSG = ("mamba2 tensor parallelism requires n_groups == 1 (grouped "
                 "B/C would need group-aligned head sharding)")
SP_TP_MAMBA2_MSG = "mamba2 mixer: tensor and sequence axes cannot combine"


def _norm(x, w, cfg):
    if cfg.rms_norm:
        return rms_norm(x, w, cfg.norm_epsilon)
    return layer_norm(x, w, None, cfg.norm_epsilon)


def _training(p: Dict[str, torch.Tensor], x: torch.Tensor, lora: Optional[dict] = None) -> bool:
    """Whether the mixer's output needs a gradient: through the input (frozen
    layers above trained ones), one of its own weights or an adapter."""
    adapters = lora["adapters"].values() if lora is not None else ()
    return torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in p.values())
        or any(t.requires_grad for ab in adapters for t in ab.values()))


# ---------------------------------------------------------------------------
# Activation-path LoRA (PEFT semantics)
# ---------------------------------------------------------------------------
#
# PEFT's LoraLayer computes y = W x + (alpha/r) * B A dropout(x): dropout acts
# on the adapted projection's input, independently per (row, position,
# feature). The mixers take an optional ``lora`` dict of one layer
#     {"adapters": {name: {"a": [G?, in, r], "b": [G?, r, out]}},
#      "scale": alpha/r, "dropout": p, "seed": int or None}
# (``backbone`` slices the stacked adapters per layer) and add the delta at
# each adapted site. With dropout off this equals the merged weights
# W + scale * a @ b up to rounding (linearity).

# The projection sites an adapter can hook (``train.lora.DEFAULT_TARGETS``).
_LORA_SITE_IDS = {name: i for i, name in enumerate((
    "in_proj_x", "in_proj_z", "out_proj",
    "x_proj_dt", "x_proj_B", "x_proj_C",
    "in_proj_B", "in_proj_C", "in_proj_dt",
))}

# Dropout-mask groups = the reference's torch modules. PEFT hangs one
# lora_dropout on each adapted Linear (in_proj, x_proj, out_proj); the split
# sites of one Linear share its mask.
_LORA_DROP_GROUPS = {
    "in_proj_x": 0, "in_proj_z": 0,
    "in_proj_B": 0, "in_proj_C": 0, "in_proj_dt": 0,   # mamba2 in_proj
    "x_proj_dt": 1, "x_proj_B": 1, "x_proj_C": 1,      # mamba1 x_proj
    "out_proj": 2,
}

_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (splitmix64's finaliser):
    the counterpart of ``jax.random.fold_in`` for integer seeds."""
    z = (seed * 0x9E3779B97F4A7C15 + data * 0xD1B54A32D192ED03 + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def _dropped(lora: dict, name: str, x: torch.Tensor, g: Optional[int]) -> torch.Tensor:
    """``x`` under the dropout of ``name``'s module: one Bernoulli mask per
    (layer, drop group, direction) over x's full shape, scaled by 1/(1-p).
    The mask comes from a generator seeded with (the layer's seed, group,
    direction), so a remat recompute and a resumed run draw the same bits.
    in_proj's sites all read the block input, one mask for every direction
    (as JAX's draw over ``x``)."""
    p_drop, seed = lora.get("dropout", 0.0), lora.get("seed")
    if seed is None or p_drop <= 0:
        return x
    group = _LORA_DROP_GROUPS[name]
    key = (group, 0 if group == 0 else (g or 0))
    cache = lora.setdefault("dropped", {})
    if key not in cache:
        gen = torch.Generator(device=x.device).manual_seed(fold_in(seed, key[0] * 4 + key[1]))
        keep = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        keep.bernoulli_(1.0 - p_drop, generator=gen)
        cache[key] = x * keep.to(x.dtype) / (1.0 - p_drop)
    return cache[key]


def _lora_delta(lora: Optional[dict], name: str, x: torch.Tensor,
                g: Optional[int] = None) -> Optional[torch.Tensor]:
    """scale * ((dropout(x) @ a) @ b) for an adapted site, or None when the
    site has no adapter. ``g`` picks the adapter's direction (sites applied
    per direction); without it the site gets one delta per direction of its
    adapter, stacked on a leading axis (in_proj's ``[G, rows, L, out]``)."""
    if lora is None:
        return None
    ab = lora["adapters"].get(name)
    if ab is None:
        return None
    x = _dropped(lora, name, x, g)
    a, b = ab["a"], ab["b"]
    if g is not None:
        a, b = a[min(g, a.shape[0] - 1)], b[min(g, b.shape[0] - 1)]
        return lora["scale"] * ((x @ a.to(x.dtype)) @ b.to(x.dtype))
    d = [(x @ ai.to(x.dtype)) @ bi.to(x.dtype) for ai, bi in zip(a, b)]
    return lora["scale"] * (d[0][None] if len(d) == 1 else torch.stack(d))


def _add_lora(base: torch.Tensor, lora: Optional[dict], name: str, x: torch.Tensor,
              g: Optional[int] = None) -> torch.Tensor:
    d = _lora_delta(lora, name, x, g)
    return base if d is None else base + d.to(base.dtype)


def mamba_mixer(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: CaduceusConfig,
                use_kernels: bool = True, lora: Optional[dict] = None,
                sp=None, tp=None) -> torch.Tensor:
    """One (Bi)Mamba mixer over ``x: [rows, L, d]``. ``p`` holds one layer's
    weights. Under training (grad enabled, and ``x``, a weight or an adapter
    requiring it) the kernels run through their autograd Functions.
    ``use_kernels=False`` runs the kernels' plain versions on any device,
    differentiated by autograd.

    The tied + add config, without LoRA, ``sp``, ``tp`` or
    ``PCAD_GATED_KERNEL``, is K2's route: at d_inner <= 768 the ``fuse_in``
    variant from x (``bimamba_mixer_fused_x``), above it K2 on in_proj's
    output (JAX ``caduceus.py:430-466``).

    With ``lora`` (activation-path adapters) the tied + add config leaves K2,
    whose fused interior hides the x_proj sites, for the decomposed route:
    in_proj, conv, x_proj with their deltas, then K1 (K1-hb and K3 under
    training) with dt_proj fused, both directions, and one out_proj on the
    summed, gated streams (JAX ``caduceus.py:572-578``).

    With ``PCAD_GATED_KERNEL=1`` the tied + add config outside ``sp`` takes
    the decomposed route up to x_proj (LoRA deltas and the ``tp`` sum
    included), then ``bimamba_scan_gated`` and out_proj, where JAX's
    ``elif fused`` branch does (``caduceus.py:535-551``).

    With ``sp`` (context parallelism; ``x`` holds this rank's chunk of L)
    the tied + add config runs the same decomposed route with the halo conv
    and the sharded scan (``ops.seq_parallel``), whatever ``use_kernels``
    says; other configs and LoRA are refused, as in JAX.

    With ``tp`` (tensor parallelism; ``p`` holds this rank's d_inner slice)
    any config takes the decomposed route with x_proj's products and
    out_proj's summed over ``tp``; LoRA is refused, as in JAX."""
    G = cfg.n_directions
    cdtype = x.dtype
    Gio = p["in_proj_x"].shape[0]
    A = -torch.exp(p["A_log"].float())                          # [G, D, N]
    train = use_kernels and _training(p, x, lora)
    tied_add = G == 2 and Gio == 1 and cfg.bidirectional_strategy == "add"
    if lora is not None and (tp is not None or sp is not None):
        raise NotImplementedError(SP_LORA_MSG)
    if sp is not None and not tied_add:
        raise NotImplementedError(SP_MAMBA_MSG)
    if tp is not None:
        x = tp_boundary(x, tp)

    gated = _USE_GATED_KERNEL and tied_add and sp is None
    if tied_add and lora is None and sp is None and tp is None and not gated:
        # Released-model path: K2 once per direction (K2-res and K3 under training).
        z = x @ p["in_proj_z"][0].to(cdtype)
        args = (p["conv_w"], p["conv_b"], p["x_proj_dt"], p["x_proj_B"], p["x_proj_C"],
                p["dt_proj_w"], p["dt_proj_b"], A, p["D"])
        if not train and p["in_proj_x"].shape[-1] <= FUSE_IN_MAX_D_INNER:
            # in_proj inside K2 (under grad with the plain versions, the
            # function takes JAX's decomposition itself)
            y_gated = bimamba_mixer_fused_x(x, z, p["in_proj_x"][0], *args,
                                            use_kernels=use_kernels)
        else:
            xi = x @ p["in_proj_x"][0].to(cdtype)
            y_gated = (bimamba_mixer(xi, z, *args) if train
                       else bimamba_mixer_fused(xi, z, *args, use_kernels=use_kernels))
        return y_gated @ p["out_proj"][0].to(cdtype)

    scan = selective_scan if train else (scan_fwd if use_kernels else scan_fwd_plain)
    xi = _add_lora(torch.einsum("bld,gdi->gbli", x, p["in_proj_x"].to(cdtype)),
                   lora, "in_proj_x", x)
    z = _add_lora(torch.einsum("bld,gdi->gbli", x, p["in_proj_z"].to(cdtype)),
                  lora, "in_proj_z", x)
    Gx = xi.shape[0]
    conv_w, conv_b = p["conv_w"].to(cdtype), p["conv_b"].to(cdtype)
    xgs, projs = [], []
    for g in range(G):
        if sp is not None:
            xg = halo_depthwise_conv_silu(xi[0], conv_w[g], conv_b[g], g == 1, sp)
        else:
            xg = causal_conv1d(xi[min(g, Gx - 1)], conv_w[g], conv_b[g],
                               activation="silu", anticausal=(g == 1))
        xgs.append(xg)
        projs.append([_add_lora(xg @ p[k][g].to(cdtype), lora, k, xg, g=g)
                      for k in ("x_proj_dt", "x_proj_B", "x_proj_C")])
    if tp is not None:
        # x_proj contracts the sharded d_inner: one sum of every direction's
        # dt/B/C products (JAX's three _maybe_psum_sharded_consumer sums)
        sizes = [t.shape[-1] for t in projs[0]]
        summed = psum_psum_bwd(torch.stack([torch.cat(pr, -1) for pr in projs]), tp)
        projs = [list(summed[g].split(sizes, -1)) for g in range(G)]
    if gated:
        # JAX's PCAD_GATED_KERNEL route: both scans, the sum and the gate in one op
        dt_lr, Bm, Cm = (torch.stack([pr[i] for pr in projs]) for i in range(3))
        y_gated = bimamba_scan_gated(torch.stack(xgs), dt_lr, A, Bm, Cm, p["D"], p["dt_proj_b"],
                                     p["dt_proj_w"], z[0], use_kernels=use_kernels)
        return psum_id_bwd(_add_lora(y_gated @ p["out_proj"][0].to(cdtype), lora, "out_proj",
                                     y_gated, g=0), tp)
    ys = []
    for g in range(G):
        xg, (dt_lr, Bm, Cm) = xgs[g], projs[g]
        if sp is not None:
            ys.append(scan_seq_sharded(xg, dt_lr, A[g], Bm, Cm, p["D"][g], p["dt_proj_b"][g],
                                       p["dt_proj_w"][g].float(), sp, reverse=(g == 1)))
        elif G == 2:  # dt projected inside the kernel
            ys.append(scan(xg, dt_lr, A[g], Bm, Cm, p["D"][g], p["dt_proj_b"][g],
                           p["dt_proj_w"][g], reverse=(g == 1)))
        else:
            dt = dt_lr @ p["dt_proj_w"][g].to(cdtype)
            ys.append(scan(xg, dt, A[g], Bm, Cm, p["D"][g], p["dt_proj_b"][g]))
    gate = F.silu(z)
    if tied_add:
        # Tied + add under LoRA: share the gate, one out_proj (one dropout mask).
        y_sum = (ys[0] + ys[1]) * gate[0]
        return psum_id_bwd(_add_lora(y_sum @ p["out_proj"][0].to(cdtype), lora, "out_proj",
                                     y_sum, g=0), tp)
    Go = p["out_proj"].shape[0]
    outs = []
    for g in range(G):
        og = ys[g] * gate[min(g, gate.shape[0] - 1)]
        outs.append(psum_id_bwd(_add_lora(og @ p["out_proj"][min(g, Go - 1)].to(cdtype), lora,
                                          "out_proj", og, g=g), tp))
    if G == 1:
        return outs[0]
    if cfg.bidirectional_strategy == "add":
        return outs[0] + outs[1]
    return outs[0] * outs[1]  # ew_multiply


def mamba2_mixer(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: CaduceusConfig,
                 use_kernels: bool = True, lora: Optional[dict] = None,
                 sp=None, tp=None) -> torch.Tensor:
    """One (Bi)Mamba-2 (SSD) mixer over ``x: [rows, L, d]`` (JAX
    ``mamba2_mixer`` on one device). Per direction: the x, z, B, C and dt
    in-projections, K5 (conv, SiLU, the SSD chunk scan, gated RMS norm; the
    reverse direction anticausal, with no flips), then out_proj. Tied
    in/out projections with the ``add`` combine sum the normed streams
    before one out_proj. Under training (grad enabled, and ``x``, a weight
    or an adapter requiring it) the interior is
    ``cuda_mixer2.Mamba2InteriorFn`` (K5-res, then K6 in the backward).
    ``use_kernels=False`` runs K5's plain version on any device,
    differentiated by autograd. ``lora``'s six sites (the five
    in-projections and out_proj) all lie outside the interior, so K5 serves
    LoRA as it is.

    With ``sp`` (context parallelism; ``x`` holds this rank's chunk of L)
    the interior is decomposed as JAX decomposes it there: the three halo
    convs, the sharded SSD (``ops.ssd_seq_parallel``: K4 and K6 on the
    card), the gate and the RMS norm; LoRA is refused.

    With ``tp`` (tensor parallelism; ``p`` holds this rank's heads, B and C
    whole) the interior is decomposed as JAX decomposes it there: the three
    convs, K4 (``SsdDirFn`` under training: K4 with chunk-entry states, K6
    in plain mode), the gate and the gated RMS norm over the whole d_inner
    (its sum of squares summed over ``tp``); out_proj's products are summed
    over ``tp``. ``n_groups`` must be 1; LoRA is refused."""
    G = cfg.n_directions
    cdtype = x.dtype
    if sp is not None and tp is not None:
        raise NotImplementedError(SP_TP_MAMBA2_MSG)
    if lora is not None and (sp is not None or tp is not None):
        raise NotImplementedError(SP_LORA_MSG)
    if tp is not None:
        if p["in_proj_B"].shape[-1] // cfg.d_state > 1:
            raise NotImplementedError(TP_GROUPS_MSG)
        if not use_kernels:
            ssd = ssd_dir_plain
        else:
            ssd = ssd_dir_train if _training(p, x) else ssd_dir
        x = tp_boundary(x, tp)
        interior = functools.partial(_mamba2_interior_tp, ssd=ssd)
    elif sp is not None:
        interior = functools.partial(_mamba2_interior_sp, sp=sp)
    elif not use_kernels:
        interior = mamba2_mixer_interior_plain
    elif _training(p, x, lora):
        interior = mamba2_mixer_interior_train
    else:
        interior = mamba2_mixer_interior

    def proj(name, g):
        return _add_lora(x @ p[name][g].to(cdtype), lora, name, x, g=g)

    Gio, Gn, Go = (p[k].shape[0] for k in ("in_proj_x", "mixer_norm_weight", "out_proj"))
    xi = [proj("in_proj_x", g) for g in range(Gio)]
    z = [proj("in_proj_z", g) for g in range(Gio)]
    A = -torch.exp(p["A_log"].float())                          # [G, H]
    outs = [interior(xi[min(g, Gio - 1)], z[min(g, Gio - 1)], proj("in_proj_B", g),
                     proj("in_proj_C", g), proj("in_proj_dt", g),
                     p["conv_x_w"][g], p["conv_x_b"][g], p["conv_B_w"][g], p["conv_B_b"][g],
                     p["conv_C_w"][g], p["conv_C_b"][g], p["mixer_norm_weight"][min(g, Gn - 1)],
                     A[g], p["D"][g], p["dt_bias"][g], d_state=cfg.d_state,
                     eps=cfg.norm_epsilon, chunk=cfg.chunk_size, reverse=(g == 1))
            for g in range(G)]
    if tp is not None:
        outs = _tp_gated_norm(outs, [p["mixer_norm_weight"][min(g, Gn - 1)] for g in range(G)],
                              cfg, tp)
    if G == 2 and Go == 1 and cfg.bidirectional_strategy == "add":
        o_sum = outs[0] + outs[1]
        return psum_id_bwd(_add_lora(o_sum @ p["out_proj"][0].to(cdtype), lora, "out_proj",
                                     o_sum, g=0), tp)
    projs = [psum_id_bwd(_add_lora(o @ p["out_proj"][min(g, Go - 1)].to(cdtype), lora,
                                   "out_proj", o, g=g), tp)
             for g, o in enumerate(outs)]
    if G == 1:
        return projs[0]
    if cfg.bidirectional_strategy == "add":
        return projs[0] + projs[1]
    return projs[0] * projs[1]  # ew_multiply


def _mamba2_interior_sp(xi, z, Braw, Craw, dt, conv_x_w, conv_x_b, conv_B_w, conv_B_b,
                        conv_C_w, conv_C_b, norm_w, A, Dskip, dt_bias, *, d_state, eps, chunk,
                        reverse, sp):
    """One Mamba-2 direction's interior over a sequence-sharded chunk (JAX
    ``mamba2_mixer``'s ``sp`` branch), with ``mamba2_mixer_interior``'s
    arguments."""
    cd = xi.dtype
    conv = lambda t, w, b: halo_depthwise_conv_silu(t, w.to(cd), b.to(cd), reverse, sp)
    xs, Bs, Cs = conv(xi, conv_x_w, conv_x_b), conv(Braw, conv_B_w, conv_B_b), \
        conv(Craw, conv_C_w, conv_C_b)
    rows, L = xi.shape[:2]
    NG = Bs.shape[-1] // d_state
    y = ssd_dir_seq_sharded(xs, dt, A, Bs.reshape(rows, L, NG, d_state),
                            Cs.reshape(rows, L, NG, d_state), Dskip, dt_bias, chunk, reverse,
                            sp)
    return rms_norm(y.to(cd) * F.silu(z), norm_w.to(cd), eps)


def _mamba2_interior_tp(xi, z, Braw, Craw, dt, conv_x_w, conv_x_b, conv_B_w, conv_B_b,
                        conv_C_w, conv_C_b, norm_w, A, Dskip, dt_bias, *, d_state, eps, chunk,
                        reverse, ssd):
    """One Mamba-2 direction's interior on this rank's heads (JAX
    ``mamba2_mixer``'s tensor-parallel branch) up to the gate: the three
    convs, ``ssd`` and ``y * silu(z)``, in the compute dtype. The gated norm
    follows over every direction at once (:func:`_tp_gated_norm`)."""
    cd = xi.dtype
    conv = lambda t, w, b: causal_conv1d(t, w.to(cd), b.to(cd), activation="silu",
                                         anticausal=reverse)
    xs, Bs, Cs = conv(xi, conv_x_w, conv_x_b), conv(Braw, conv_B_w, conv_B_b), \
        conv(Craw, conv_C_w, conv_C_b)
    rows, L = xi.shape[:2]
    NG = Bs.shape[-1] // d_state
    y = ssd(xs, dt, A, Bs.reshape(rows, L, NG, d_state), Cs.reshape(rows, L, NG, d_state),
            Dskip, dt_bias, chunk, reverse)
    return y.to(cd) * F.silu(z)


def _tp_gated_norm(us, norm_ws, cfg: CaduceusConfig, tp):
    """The gated RMS norm of each direction's ``u`` over the whole, sharded
    d_inner: the sums of squares of every direction summed over ``tp`` in
    one all-reduce whose adjoint sums too (the sharded-consumer rule), over
    ``cfg.d_inner`` (JAX ``caduceus.py:764-772``)."""
    ufs = [u.float() for u in us]
    ss = psum_psum_bwd(torch.stack([(uf * uf).sum(-1, keepdim=True) for uf in ufs]), tp)
    cd = us[0].dtype
    return [(uf * torch.rsqrt(ss[g] / cfg.d_inner + cfg.norm_epsilon)).to(cd) * w.to(cd)
            for g, (uf, w) in enumerate(zip(ufs, norm_ws))]


def embed_residual(model: Caduceus, input_ids: torch.Tensor,
                   dtype=torch.bfloat16, sp=None) -> torch.Tensor:
    """Token embedding -> residual stream ``[S*B, L, d]`` (S=2 with rcps:
    rows B: are the RC stream), float32 when cfg.residual_in_fp32. With
    ``sp`` the ids are this rank's chunk of L."""
    cfg = model.cfg
    ids = input_ids
    if cfg.rcps:
        ids = torch.cat([input_ids, rc_ids(input_ids, model.cmap, sp)], dim=0)
    table = model.embedding.to(dtype)
    if torch.is_grad_enabled() and model.embedding.requires_grad:
        # One-hot product: the same rows exactly (one nonzero term per sum),
        # and a gradient that is a matrix product, not a scatter-add, so it
        # is the same run to run on the card.
        hidden = F.one_hot(ids, table.shape[0]).to(dtype) @ table
    else:
        hidden = table[ids]
    return hidden.float() if cfg.residual_in_fp32 else hidden


def make_block_fn(cfg: CaduceusConfig, dtype=torch.bfloat16, use_kernels: bool = True,
                  remat: bool = False, sp=None, tp=None):
    """One residual block, ``block(res, p) -> res + mixer(norm(res))`` over a
    layer's weights ``p`` (JAX ``make_block_fn``): the single definition of
    the backbone and the pipeline stages. ``remat=True`` recomputes the
    block in the backward pass (``torch.utils.checkpoint``) when gradients
    are on."""
    mixer = mamba2_mixer if cfg.ssm_variant == "mamba2" else mamba_mixer

    def block(res, p):
        normed = _norm(res.to(dtype), p["norm_weight"], cfg)
        out = mixer(p, normed, cfg, use_kernels=use_kernels, sp=sp, tp=tp)
        return res + out.to(res.dtype)

    if not remat:
        return block
    return lambda res, p: (checkpoint(block, res, p, use_reentrant=False)
                           if torch.is_grad_enabled() else block(res, p))


def backbone(model: Caduceus, input_ids: torch.Tensor, dtype=torch.bfloat16,
             collect_layers: bool = False, use_kernels: bool = True,
             remat: bool = False, lora: Optional[dict] = None, sp=None, tp=None):
    """Embedding, n_layer blocks, final norm. Returns the working-frame
    hidden states ``[S*B, L, d]``; with ``collect_layers`` also the list of
    each block's residual-stream input (in ``dtype``). ``remat=True``
    recomputes each block in the backward pass (``torch.utils.checkpoint``,
    as JAX ``make_block_fn``'s ``jax.checkpoint``): activation memory of
    O(L * d) per layer instead of every block's intermediates.

    ``lora`` (``train.lora.lora_ctx``): adapters stacked on n_layer,
    ``{"adapters": {name: {"a", "b"}}, "scale", "dropout", "seed"}``; each
    layer takes its slice and the seed folded with its index, so its
    dropout masks are a function of (seed, layer) and a recompute draws
    them again. ``sp``: context parallelism over that axis, ``tp``: tensor
    parallelism over that one (the mixers)."""
    cfg = model.cfg
    mixer = mamba2_mixer if cfg.ssm_variant == "mamba2" else mamba_mixer
    residual = embed_residual(model, input_ids, dtype, sp)
    run = make_block_fn(cfg, dtype, use_kernels, remat, sp, tp)
    per_layer = []
    for i, layer in enumerate(model.layers):
        p = layer.params()
        if collect_layers:
            per_layer.append(residual.to(dtype))
        if lora is None:
            residual = run(residual, p)
            continue
        seed = lora.get("seed")
        ctx = {"adapters": {n: {k: t[i] for k, t in ab.items()}
                            for n, ab in lora["adapters"].items()},
               "scale": lora["scale"], "dropout": lora.get("dropout", 0.0),
               "seed": None if seed is None else fold_in(seed, i)}

        def block(res, p=p, ctx=ctx):
            normed = _norm(res.to(dtype), p["norm_weight"], cfg)
            # a fresh mask cache per call: the recompute draws its masks anew
            out = mixer(p, normed, cfg, use_kernels=use_kernels, lora=dict(ctx), sp=sp, tp=tp)
            return res + out.to(res.dtype)

        residual = (checkpoint(block, residual, use_reentrant=False)
                    if remat and torch.is_grad_enabled() else block(residual))
    final = _norm(residual.to(dtype), model.norm_f_weight, cfg)
    return (final, per_layer) if collect_layers else final


def readout_hidden(h_work: torch.Tensor, cfg: CaduceusConfig, sp=None) -> torch.Tensor:
    """Working frame ``[S*B, L, d]`` -> HF-contract hidden states: with rcps
    ``[B, L, 2d]`` whose channels ``d:`` are the RC stream in its stored
    frame (length and channels flipped; the length across ``sp``'s shards
    too)."""
    if not cfg.rcps:
        return h_work
    B = h_work.shape[0] // 2
    return torch.cat([h_work[:B], _sp_flip(h_work[B:], sp, 1).flip(2)], dim=-1)


def lm_logits(model: Caduceus, h_work: torch.Tensor, sp=None) -> torch.Tensor:
    """MLM head. RCPS head: forward logits plus the time-flipped (across
    ``sp``'s shards too), complement-permuted RC logits."""
    cfg = model.cfg
    W = (model.lm_head if model.lm_head is not None else model.embedding).to(h_work.dtype)
    logits = h_work @ W.T                                       # [SB, L, V]
    if not cfg.rcps:
        return logits
    B = logits.shape[0] // 2
    out = logits[:B] + _sp_flip(logits[B:], sp, 1)[..., model.cmap]
    if cfg.lm_head_strategy == "mean":
        out = out * 0.5
    return out


def forward(model: Caduceus, input_ids: torch.Tensor, dtype=torch.bfloat16,
            output_hidden_states: bool = False, all_hidden_states: bool = False,
            use_kernels: bool = True, remat: bool = False,
            sp=None, tp=None) -> Dict[str, torch.Tensor]:
    """Masked-LM forward: ``logits [B, L, V]``, optionally ``hidden_states``
    (final layer) and ``all_hidden_states [n_layer+1, B, L, hidden]`` (entry
    k = block k's input, last = ``hidden_states``). ``remat`` as
    :func:`backbone`. ``sp`` (a ``parallel.mesh.Axis``): context
    parallelism; ``input_ids`` hold this rank's chunk of L, and the outputs
    come back sharded the same way. ``tp`` (an Axis): tensor parallelism;
    the model's mixer weights are this rank's slices, and the outputs are
    whole on every rank."""
    h_work = backbone(model, input_ids, dtype, collect_layers=all_hidden_states,
                      use_kernels=use_kernels, remat=remat, sp=sp, tp=tp)
    per_layer = None
    if all_hidden_states:
        h_work, per_layer = h_work
    out = {"logits": lm_logits(model, h_work, sp)}
    if output_hidden_states or all_hidden_states:
        out["hidden_states"] = readout_hidden(h_work, model.cfg, sp)
    if all_hidden_states:
        out["all_hidden_states"] = torch.stack(
            [readout_hidden(h, model.cfg, sp) for h in per_layer] + [out["hidden_states"]])
    return out


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor,
             loss_weights: Optional[torch.Tensor] = None,
             ignore_index: int = -100) -> torch.Tensor:
    """Weighted masked cross-entropy: positions labelled ``ignore_index``
    contribute nothing; ``loss_weights`` scale each position and the
    normaliser is the weight sum over scored positions."""
    valid = labels != ignore_index
    labels_safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels_safe[..., None])[..., 0]
    w = valid.float()
    if loss_weights is not None:
        w = w * loss_weights.float()
    return (nll * w).sum() / w.sum().clamp(min=1e-8)
