"""Caduceus (Mamba-1, bidirectional, RC-equivariant) masked LM in PyTorch.

Counterpart of ``plantcaduceus_tpu.models.caduceus`` for the Mamba-1
family, forward only. The same flattened formulation:

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
  in_proj with ``torch.matmul``, then kernel K2 (``ops.cuda_mixer``) once
  per direction, the fp32 gate, out_proj;
* everything else (untied, ``ew_multiply``, unidirectional): conv and
  x_proj in plain PyTorch, then kernel K1 (``ops.cuda_scan``) per
  direction, with dt projected inside the kernel when G=2 and outside when
  G=1, as the JAX package does.

On CPU tensors the kernel wrappers run their plain versions.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from plantcaduceus_tpu_torch.models.config import CaduceusConfig
from plantcaduceus_tpu_torch.ops.conv import causal_conv1d
from plantcaduceus_tpu_torch.ops.cuda_mixer import bimamba_mixer_fused
from plantcaduceus_tpu_torch.ops.cuda_scan import scan_fwd, scan_fwd_plain
from plantcaduceus_tpu_torch.ops.norms import layer_norm, rms_norm

LAYER_KEYS = ("norm_weight", "in_proj_x", "in_proj_z", "out_proj", "conv_w",
              "conv_b", "x_proj_dt", "x_proj_B", "x_proj_C", "dt_proj_w",
              "dt_proj_b", "A_log", "D")


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
    if cfg.ssm_variant != "mamba1":
        raise NotImplementedError("the PyTorch port covers Mamba-1 models only")
    gen = generator if generator is not None else torch.Generator().manual_seed(seed)
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


# ---------------------------------------------------------------------------
# Module
# ---------------------------------------------------------------------------


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t.detach().float().clone().contiguous(), requires_grad=False)


class CaduceusLayer(nn.Module):
    """One block's weights, in the JAX layout without the n_layer axis."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        for k in LAYER_KEYS:
            setattr(self, k, _frozen(tensors[k]))

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in LAYER_KEYS}


class Caduceus(nn.Module):
    """Mamba-1 Caduceus masked LM. Weights are kept in float32; each forward
    casts them to its compute ``dtype`` where the JAX package does."""

    def __init__(self, cfg: CaduceusConfig, params: dict):
        super().__init__()
        if cfg.ssm_variant != "mamba1":
            raise NotImplementedError("the PyTorch port covers Mamba-1 models only")
        self.cfg = cfg
        self.embedding = _frozen(params["embedding"])
        self.norm_f_weight = _frozen(params["norm_f_weight"])
        self.lm_head = _frozen(params["lm_head"]) if "lm_head" in params else None
        blocks = params["blocks"]
        self.layers = nn.ModuleList(
            CaduceusLayer({k: blocks[k][i] for k in LAYER_KEYS})
            for i in range(cfg.n_layer))
        self.register_buffer("cmap", torch.tensor(cfg.complement_map, dtype=torch.long),
                             persistent=False)

    def forward(self, input_ids: torch.Tensor, dtype=torch.bfloat16,
                output_hidden_states: bool = False, all_hidden_states: bool = False,
                use_kernels: bool = True) -> Dict[str, torch.Tensor]:
        return forward(self, input_ids, dtype=dtype,
                       output_hidden_states=output_hidden_states,
                       all_hidden_states=all_hidden_states, use_kernels=use_kernels)


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------


def rc_ids(input_ids: torch.Tensor, cmap: torch.Tensor) -> torch.Tensor:
    """Reverse-complement token ids: complement map, then reverse along L."""
    return cmap[input_ids].flip(-1)


def _norm(x, w, cfg):
    if cfg.rms_norm:
        return rms_norm(x, w, cfg.norm_epsilon)
    return layer_norm(x, w, None, cfg.norm_epsilon)


def mamba_mixer(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: CaduceusConfig,
                use_kernels: bool = True) -> torch.Tensor:
    """One (Bi)Mamba mixer over ``x: [rows, L, d]``. ``p`` holds one layer's
    weights. ``use_kernels=False`` runs the kernels' plain versions on any
    device."""
    G = cfg.n_directions
    cdtype = x.dtype
    Gio = p["in_proj_x"].shape[0]
    A = -torch.exp(p["A_log"].float())                          # [G, D, N]

    if G == 2 and Gio == 1 and cfg.bidirectional_strategy == "add":
        # Released-model path: K2 once per direction.
        xi = x @ p["in_proj_x"][0].to(cdtype)
        z = x @ p["in_proj_z"][0].to(cdtype)
        y_gated = bimamba_mixer_fused(
            xi, z, p["conv_w"], p["conv_b"], p["x_proj_dt"], p["x_proj_B"],
            p["x_proj_C"], p["dt_proj_w"], p["dt_proj_b"], A, p["D"],
            use_kernels=use_kernels)
        return y_gated @ p["out_proj"][0].to(cdtype)

    scan = scan_fwd if use_kernels else scan_fwd_plain
    xi = torch.einsum("bld,gdi->gbli", x, p["in_proj_x"].to(cdtype))
    z = torch.einsum("bld,gdi->gbli", x, p["in_proj_z"].to(cdtype))
    conv_w, conv_b = p["conv_w"].to(cdtype), p["conv_b"].to(cdtype)
    ys = []
    for g in range(G):
        xg = causal_conv1d(xi[min(g, Gio - 1)], conv_w[g], conv_b[g],
                           activation="silu", anticausal=(g == 1))
        dt_lr = xg @ p["x_proj_dt"][g].to(cdtype)
        Bm = xg @ p["x_proj_B"][g].to(cdtype)
        Cm = xg @ p["x_proj_C"][g].to(cdtype)
        if G == 2:  # dt projected inside the kernel
            ys.append(scan(xg, dt_lr, A[g], Bm, Cm, p["D"][g], p["dt_proj_b"][g],
                           p["dt_proj_w"][g], reverse=(g == 1)))
        else:
            dt = dt_lr @ p["dt_proj_w"][g].to(cdtype)
            ys.append(scan(xg, dt, A[g], Bm, Cm, p["D"][g], p["dt_proj_b"][g]))
    gate = F.silu(z)
    outs = [(ys[g] * gate[min(g, Gio - 1)]) @ p["out_proj"][min(g, Gio - 1)].to(cdtype)
            for g in range(G)]
    if G == 1:
        return outs[0]
    if cfg.bidirectional_strategy == "add":
        return outs[0] + outs[1]
    return outs[0] * outs[1]  # ew_multiply


def embed_residual(model: Caduceus, input_ids: torch.Tensor,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """Token embedding -> residual stream ``[S*B, L, d]`` (S=2 with rcps:
    rows B: are the RC stream), float32 when cfg.residual_in_fp32."""
    cfg = model.cfg
    ids = input_ids
    if cfg.rcps:
        ids = torch.cat([input_ids, rc_ids(input_ids, model.cmap)], dim=0)
    hidden = model.embedding.to(dtype)[ids]
    return hidden.float() if cfg.residual_in_fp32 else hidden


def backbone(model: Caduceus, input_ids: torch.Tensor, dtype=torch.bfloat16,
             collect_layers: bool = False, use_kernels: bool = True):
    """Embedding, n_layer blocks, final norm. Returns the working-frame
    hidden states ``[S*B, L, d]``; with ``collect_layers`` also the list of
    each block's residual-stream input (in ``dtype``)."""
    cfg = model.cfg
    residual = embed_residual(model, input_ids, dtype)
    per_layer = []
    for layer in model.layers:
        p = layer.params()
        if collect_layers:
            per_layer.append(residual.to(dtype))
        normed = _norm(residual.to(dtype), p["norm_weight"], cfg)
        out = mamba_mixer(p, normed, cfg, use_kernels=use_kernels)
        residual = residual + out.to(residual.dtype)
    final = _norm(residual.to(dtype), model.norm_f_weight, cfg)
    return (final, per_layer) if collect_layers else final


def readout_hidden(h_work: torch.Tensor, cfg: CaduceusConfig) -> torch.Tensor:
    """Working frame ``[S*B, L, d]`` -> HF-contract hidden states: with rcps
    ``[B, L, 2d]`` whose channels ``d:`` are the RC stream in its stored
    frame (length and channels flipped)."""
    if not cfg.rcps:
        return h_work
    B = h_work.shape[0] // 2
    return torch.cat([h_work[:B], h_work[B:].flip(1).flip(2)], dim=-1)


def lm_logits(model: Caduceus, h_work: torch.Tensor) -> torch.Tensor:
    """MLM head. RCPS head: forward logits plus the time-flipped,
    complement-permuted RC logits."""
    cfg = model.cfg
    W = (model.lm_head if model.lm_head is not None else model.embedding).to(h_work.dtype)
    logits = h_work @ W.T                                       # [SB, L, V]
    if not cfg.rcps:
        return logits
    B = logits.shape[0] // 2
    out = logits[:B] + logits[B:].flip(1)[..., model.cmap]
    if cfg.lm_head_strategy == "mean":
        out = out * 0.5
    return out


def forward(model: Caduceus, input_ids: torch.Tensor, dtype=torch.bfloat16,
            output_hidden_states: bool = False, all_hidden_states: bool = False,
            use_kernels: bool = True) -> Dict[str, torch.Tensor]:
    """Masked-LM forward: ``logits [B, L, V]``, optionally ``hidden_states``
    (final layer) and ``all_hidden_states [n_layer+1, B, L, hidden]`` (entry
    k = block k's input, last = ``hidden_states``)."""
    h_work = backbone(model, input_ids, dtype, collect_layers=all_hidden_states,
                      use_kernels=use_kernels)
    per_layer = None
    if all_hidden_states:
        h_work, per_layer = h_work
    out = {"logits": lm_logits(model, h_work)}
    if output_hidden_states or all_hidden_states:
        out["hidden_states"] = readout_hidden(h_work, model.cfg)
    if all_hidden_states:
        out["all_hidden_states"] = torch.stack(
            [readout_hidden(h, model.cfg) for h in per_layer] + [out["hidden_states"]])
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
