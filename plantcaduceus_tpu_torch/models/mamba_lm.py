"""Autoregressive Mamba language model with recurrent O(1)-per-token decode.

Counterpart of ``plantcaduceus_tpu.models.mamba_lm``: a plain
unidirectional Mamba LM head model, embedding -> n_layer x (RMSNorm ->
mixer -> residual) -> norm -> tied LM head, in either SSM variant, with the
JAX package's parameter layout (block leaves stacked on n_layer) and dtype
flow (weights float32, compute in the forward's ``dtype``, float32
residual stream).

Forward (training and prefill):

* Mamba-1 (:func:`mixer`): in_proj, the causal conv and x_proj in PyTorch,
  then kernel K1 (``ops.cuda_scan.scan_fwd``) with dt given at full width,
  one direction; under training ``cuda_scan.selective_scan`` (K1 with
  chunk-entry states, K3 in the backward). dt is projected outside the
  kernel in the compute dtype, as JAX does, and the scan's inputs are
  cast up to float32 (exact): JAX keeps B and C in float32, and K1 reads
  x, dt, B and C in one dtype.
* Mamba-2 (:func:`mixer2`): the in-projections and convs in PyTorch, then
  the SSD chunk scan — kernel K4 (``ops.cuda_ssd.ssd_dir``; under training
  ``ssd_dir_train``: K4 with chunk-entry states, K6 in plain mode) where
  JAX's ``pallas_ssd.supported`` takes the shapes (P, N and the chunk
  multiples of 128, the chunk dividing L), and ``ops.ssd.ssd_chunked``
  elsewhere. K4 and K6 take only P = N = chunk = 128, so on the card the
  other multiples of 128 raise.

``MambaLmConfig.scan_impl`` picks as in JAX: ``"auto"`` and ``"pallas"``
run the kernels, ``"associative"`` and ``"sequential"`` the plain path
(``ssd_chunked`` for Mamba-2).

Decode (:func:`step`, :func:`generate`) runs no kernel, as in JAX: a
per-layer cache of the conv tails and the float32 SSM state, advanced one
token at a time. Sampling draws from an explicit ``torch.Generator``: the
distribution of ``jax.random.categorical``, not its numbers.

On CPU tensors the kernel wrappers run their plain versions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from plantcaduceus_tpu_torch.models.caduceus import (CaduceusLayer, _dt_bias_init,
                                                     _linear_init, _param, _training,
                                                     _uniform, layer_keys)
from plantcaduceus_tpu_torch.ops.conv import causal_conv1d
from plantcaduceus_tpu_torch.ops.cuda_scan import scan_fwd, scan_fwd_plain, selective_scan
from plantcaduceus_tpu_torch.ops.cuda_ssd import ssd_dir, ssd_dir_plain, ssd_dir_train
from plantcaduceus_tpu_torch.ops.norms import rms_norm
from plantcaduceus_tpu_torch.ops.selective_scan import softplus
from plantcaduceus_tpu_torch.ops.ssd import ssd_chunked


SCAN_IMPLS = ("auto", "pallas", "associative", "sequential")


@dataclasses.dataclass
class MambaLmConfig:
    d_model: int = 256
    n_layer: int = 4
    vocab_size: int = 256
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None
    norm_epsilon: float = 1e-5
    tie_word_embeddings: bool = True
    # auto | pallas (the kernels) | associative | sequential (the plain path)
    scan_impl: str = "auto"
    # "mamba1" (selective scan) or "mamba2" (SSD, scalar decay per head).
    ssm_variant: str = "mamba1"
    head_dim: int = 64     # mamba2: d_inner = n_heads * head_dim
    n_groups: int = 1      # mamba2: B/C groups shared across heads
    chunk_size: int = 64   # mamba2: SSD chunk length (L % chunk_size == 0)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or math.ceil(self.d_model / 16)

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def kernels(self) -> bool:
        """Whether ``scan_impl`` asks for the kernels."""
        return self.scan_impl in ("auto", "pallas")

    def __post_init__(self):
        if self.scan_impl not in SCAN_IMPLS:
            raise ValueError(f"unknown scan_impl {self.scan_impl!r}; one of {SCAN_IMPLS}")
        if self.ssm_variant not in ("mamba1", "mamba2"):
            raise ValueError(f"unknown ssm_variant {self.ssm_variant!r}")
        if self.ssm_variant == "mamba2":
            if self.d_inner % self.head_dim:
                raise ValueError(
                    f"d_inner={self.d_inner} not divisible by "
                    f"head_dim={self.head_dim}")
            if self.n_heads % self.n_groups:
                raise ValueError(
                    f"n_heads={self.n_heads} not divisible by "
                    f"n_groups={self.n_groups}")


# ---------------------------------------------------------------------------
# Initialisation (the distributions of the JAX init_params)
# ---------------------------------------------------------------------------


def init_params(cfg: MambaLmConfig, generator: Optional[torch.Generator] = None,
                seed: int = 0) -> dict:
    """Parameter dict in the JAX layout (block leaves stacked on a leading
    n_layer axis), float32 on the CPU, drawn from ``generator`` (default: a
    new one seeded with ``seed``). The numbers differ from JAX's for the
    same seed; the distributions are the same."""
    gen = generator if generator is not None else torch.Generator().manual_seed(seed)
    d, di, N, K, nl = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.d_conv, cfg.n_layer
    in_proj = _linear_init(gen, d, (nl, d, 2 * di))
    out_proj = _linear_init(gen, di, (nl, di, d)) / math.sqrt(2 * nl)
    if cfg.ssm_variant == "mamba2":
        H, NGN = cfg.n_heads, cfg.n_groups * cfg.d_state
        blocks = {
            "norm_weight": torch.ones((nl, d)),
            "in_proj_x": in_proj[..., :di].contiguous(),
            "in_proj_z": in_proj[..., di:].contiguous(),
            "in_proj_B": _linear_init(gen, d, (nl, d, NGN)),
            "in_proj_C": _linear_init(gen, d, (nl, d, NGN)),
            "in_proj_dt": _linear_init(gen, d, (nl, d, H)),
            "conv_x_w": _linear_init(gen, K, (nl, di, K)),
            "conv_x_b": _linear_init(gen, K, (nl, di)),
            "conv_B_w": _linear_init(gen, K, (nl, NGN, K)),
            "conv_B_b": torch.zeros((nl, NGN)),
            "conv_C_w": _linear_init(gen, K, (nl, NGN, K)),
            "conv_C_b": torch.zeros((nl, NGN)),
            "mixer_norm_weight": torch.ones((nl, di)),
            "out_proj": out_proj,
            "dt_bias": _dt_bias_init(gen, (nl, H)),
            "A_log": torch.log(_uniform(gen, (nl, H), 1.0, 16.0)),
            "D": torch.ones((nl, H)),
        }
    else:
        R = cfg.dt_rank_
        x_proj = _linear_init(gen, di, (nl, di, R + 2 * N))
        blocks = {
            "norm_weight": torch.ones((nl, d)),
            "in_proj_x": in_proj[..., :di].contiguous(),
            "in_proj_z": in_proj[..., di:].contiguous(),
            "out_proj": out_proj,
            "conv_w": _linear_init(gen, K, (nl, di, K)),
            "conv_b": _linear_init(gen, K, (nl, di)),
            "x_proj_dt": x_proj[..., :R].contiguous(),
            "x_proj_B": x_proj[..., R:R + N].contiguous(),
            "x_proj_C": x_proj[..., R + N:].contiguous(),
            "dt_proj_w": _uniform(gen, (nl, R, di), -(R ** -0.5), R ** -0.5),
            "dt_proj_b": _dt_bias_init(gen, (nl, di)),
            "A_log": torch.log(torch.arange(1, N + 1, dtype=torch.float32)
                               .expand(nl, di, N).contiguous()),
            "D": torch.ones((nl, di)),
        }
    params = {"embedding": 0.02 * torch.randn((cfg.vocab_size, d), generator=gen),
              "blocks": blocks, "norm_f_weight": torch.ones((d,))}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = 0.02 * torch.randn((cfg.vocab_size, d), generator=gen)
    return params


class MambaLm(nn.Module):
    """The AR Mamba LM's weights (float32, frozen; ``requires_grad_()``
    makes them train), per layer under the JAX leaf names."""

    def __init__(self, cfg: MambaLmConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.embedding = _param(params["embedding"])
        self.norm_f_weight = _param(params["norm_f_weight"])
        self.lm_head = _param(params["lm_head"]) if "lm_head" in params else None
        keys = layer_keys(cfg)
        blocks = params["blocks"]
        self.layers = nn.ModuleList(CaduceusLayer({k: blocks[k][i] for k in keys}, keys)
                                    for i in range(cfg.n_layer))

    def forward(self, input_ids: torch.Tensor, dtype=torch.bfloat16,
                use_kernels: bool = True) -> Dict[str, torch.Tensor]:
        return forward(self, input_ids, dtype=dtype, use_kernels=use_kernels)


# ---------------------------------------------------------------------------
# Parallel (training / prefill) forward
# ---------------------------------------------------------------------------


def mixer(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: MambaLmConfig,
          use_kernels: bool = True) -> torch.Tensor:
    """One causal Mamba mixer over ``x [B, L, d_model]`` (post-norm input;
    JAX ``_mixer``). ``use_kernels=False`` (or a plain ``scan_impl``) runs
    K1's plain version, differentiated by autograd."""
    cd = x.dtype
    xi = x @ p["in_proj_x"].to(cd)
    z = x @ p["in_proj_z"].to(cd)
    xg = causal_conv1d(xi, p["conv_w"].to(cd), p["conv_b"].to(cd), activation="silu")
    dt_lr = xg @ p["x_proj_dt"].to(cd)
    Bm = (xg @ p["x_proj_B"].to(cd)).float()
    Cm = (xg @ p["x_proj_C"].to(cd)).float()
    dt = (dt_lr @ p["dt_proj_w"].to(cd)).float()  # rounded to cd first, as JAX
    A = -torch.exp(p["A_log"].float())
    if not (use_kernels and cfg.kernels):
        scan = scan_fwd_plain
    else:
        scan = selective_scan if _training(p, x) else scan_fwd
    y = scan(xg.float(), dt, A, Bm, Cm, p["D"], p["dt_proj_b"]).to(cd)
    y = (y.float() * F.silu(z.float())).to(cd)
    return y @ p["out_proj"].to(cd)


def ssd_supported(cfg: MambaLmConfig, L: int) -> bool:
    """Whether JAX takes its SSD kernel for this model at sequence length L
    (``pallas_ssd.supported``): head_dim, d_state and ``min(chunk, L)``
    multiples of 128, the chunk dividing L."""
    T = min(cfg.chunk_size, L)
    return (cfg.head_dim % 128 == 0 and cfg.d_state % 128 == 0 and T % 128 == 0
            and L % T == 0)


def mixer2(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: MambaLmConfig,
           use_kernels: bool = True) -> torch.Tensor:
    """One causal SSD (Mamba-2) mixer over ``x [B, L, d_model]`` (JAX
    ``_mixer2``): conv of x, B and C, the chunked SSD, gated RMSNorm,
    out_proj. Where :func:`ssd_supported` holds the SSD is K4
    (``use_kernels=False``: its plain version), which raises on the card for
    shapes it lacks; elsewhere, or with a plain ``scan_impl``,
    ``ssd_chunked``."""
    Bn, L = x.shape[:2]
    H, N, NG, P = cfg.n_heads, cfg.d_state, cfg.n_groups, cfg.head_dim
    cd = x.dtype

    def conv(v, name):
        return causal_conv1d(v, p[f"conv_{name}_w"].to(cd), p[f"conv_{name}_b"].to(cd),
                             activation="silu")

    xi = x @ p["in_proj_x"].to(cd)
    z = x @ p["in_proj_z"].to(cd)
    dt = x @ p["in_proj_dt"].to(cd)
    xg = conv(xi, "x")
    Bc = conv(x @ p["in_proj_B"].to(cd), "B")
    Cc = conv(x @ p["in_proj_C"].to(cd), "C")
    A = -torch.exp(p["A_log"].float())
    if cfg.kernels and ssd_supported(cfg, L):
        if not use_kernels:
            ssd = ssd_dir_plain
        else:
            ssd = ssd_dir_train if _training(p, x) else ssd_dir
        y = ssd(xg, dt, A, Bc.reshape(Bn, L, NG, N), Cc.reshape(Bn, L, NG, N), p["D"],
                p["dt_bias"], cfg.chunk_size, False)
    else:
        y = ssd_chunked(xg.reshape(1, Bn, L, H, P), dt[None], A[None],
                        Bc.reshape(1, Bn, L, NG, N), Cc.reshape(1, Bn, L, NG, N),
                        p["D"][None], dt_bias=p["dt_bias"][None],
                        chunk=cfg.chunk_size).reshape(Bn, L, H * P)
    u = y.to(cd) * F.silu(z)
    out = rms_norm(u, p["mixer_norm_weight"].to(cd), cfg.norm_epsilon)
    return out @ p["out_proj"].to(cd)


def _embed(model: MambaLm, ids: torch.Tensor, dtype) -> torch.Tensor:
    table = model.embedding.to(dtype)
    if torch.is_grad_enabled() and model.embedding.requires_grad:
        # a one-hot product: the same rows, and a gradient that sums in a
        # fixed order (no scatter-add)
        return F.one_hot(ids, table.shape[0]).to(dtype) @ table
    return table[ids]


def _head(model: MambaLm, res: torch.Tensor, dtype):
    h = rms_norm(res.to(dtype), model.norm_f_weight, model.cfg.norm_epsilon)
    dec = (model.lm_head if model.lm_head is not None else model.embedding).to(dtype)
    return h @ dec.T, h


def forward(model: MambaLm, input_ids: torch.Tensor, dtype=torch.bfloat16,
            use_kernels: bool = True) -> Dict[str, torch.Tensor]:
    """input_ids [B, L] -> {"logits": [B, L, V], "hidden_states": [B, L, d]};
    logits[t] predicts token t+1."""
    cfg = model.cfg
    mix = mixer2 if cfg.ssm_variant == "mamba2" else mixer
    res = _embed(model, input_ids, dtype).float()
    for layer in model.layers:
        p = layer.params()
        h = rms_norm(res.to(dtype), p["norm_weight"], cfg.norm_epsilon)
        res = res + mix(p, h, cfg, use_kernels=use_kernels).float()
    logits, h = _head(model, res, dtype)
    return {"logits": logits, "hidden_states": h}


def nll_loss(model: MambaLm, input_ids: torch.Tensor, dtype=torch.bfloat16,
             use_kernels: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy in nats (bits/dim = nll / ln 2)."""
    logits = forward(model, input_ids, dtype, use_kernels)["logits"][:, :-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, input_ids[:, 1:, None].long()).mean()


def bits_per_dim(nll_nats):
    return nll_nats / math.log(2.0)


# ---------------------------------------------------------------------------
# Recurrent decode (O(1) per token)
# ---------------------------------------------------------------------------


def init_cache(cfg: MambaLmConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
    """Per-layer decode state: the conv tails (last K-1 inputs of each conv)
    and the float32 SSM state."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    Lk, Km1 = cfg.n_layer, cfg.d_conv - 1
    if cfg.ssm_variant == "mamba2":
        NGN = cfg.n_groups * cfg.d_state
        return {"conv": zeros(Lk, batch, Km1, cfg.d_inner),
                "conv_B": zeros(Lk, batch, Km1, NGN), "conv_C": zeros(Lk, batch, Km1, NGN),
                "ssm": zeros(Lk, batch, cfg.n_heads, cfg.d_state, cfg.head_dim)}
    return {"conv": zeros(Lk, batch, Km1, cfg.d_inner),
            "ssm": zeros(Lk, batch, cfg.d_inner, cfg.d_state)}


def _conv_step(tail, new, w, b):
    """One causal conv output from the cached tail and this token's input:
    tail [B, K-1, D], new [B, D] -> (SiLU output [B, D] float32, new tail)."""
    window = torch.cat([tail, new.float()[:, None]], dim=1)
    out = torch.einsum("bkd,dk->bd", window, w.float())
    return F.silu(out + b.float()), window[:, 1:]


def _layer_step1(p, cfg, hcur, tail, h, dtype):
    xi = hcur @ p["in_proj_x"].to(dtype)
    z = hcur @ p["in_proj_z"].to(dtype)
    xg, tail = _conv_step(tail, xi, p["conv_w"], p["conv_b"])
    xg_c = xg.to(dtype)
    dt_lr = xg_c @ p["x_proj_dt"].to(dtype)
    Bv = (xg_c @ p["x_proj_B"].to(dtype)).float()
    Cv = (xg_c @ p["x_proj_C"].to(dtype)).float()
    dt = (dt_lr @ p["dt_proj_w"].to(dtype)).float()
    dtp = softplus(dt + p["dt_proj_b"])                        # [B, di]
    a = torch.exp(dtp[..., None] * -torch.exp(p["A_log"])[None])  # [B, di, N]
    h = a * h + (dtp * xg)[..., None] * Bv[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, Cv) + p["D"][None] * xg
    y = (y * F.silu(z.float())).to(dtype)
    return y @ p["out_proj"].to(dtype), (tail, h)


def _layer_step2(p, cfg, hcur, xt, Bt, Ct, S, dtype):
    H, N, NG = cfg.n_heads, cfg.d_state, cfg.n_groups
    xi = hcur @ p["in_proj_x"].to(dtype)
    z = hcur @ p["in_proj_z"].to(dtype)
    dt = (hcur @ p["in_proj_dt"].to(dtype)).float()
    xg, xt = _conv_step(xt, xi, p["conv_x_w"], p["conv_x_b"])
    Bv, Bt = _conv_step(Bt, hcur @ p["in_proj_B"].to(dtype), p["conv_B_w"], p["conv_B_b"])
    Cv, Ct = _conv_step(Ct, hcur @ p["in_proj_C"].to(dtype), p["conv_C_w"], p["conv_C_b"])
    dtp = softplus(dt + p["dt_bias"])                          # [B, H]
    a = torch.exp(dtp * -torch.exp(p["A_log"]))                # [B, H]
    xh = xg.reshape(xg.shape[0], H, cfg.head_dim)              # [B, H, P]
    Bh = Bv.reshape(-1, NG, N).repeat_interleave(H // NG, dim=1)  # [B, H, N]
    Ch = Cv.reshape(-1, NG, N).repeat_interleave(H // NG, dim=1)
    S = a[..., None, None] * S + torch.einsum("bhn,bhp->bhnp", Bh * dtp[..., None], xh)
    y = torch.einsum("bhn,bhnp->bhp", Ch, S) + p["D"][..., None] * xh
    u = y.reshape(xg.shape).to(dtype) * F.silu(z)
    out = rms_norm(u, p["mixer_norm_weight"].to(dtype), cfg.norm_epsilon)
    return out @ p["out_proj"].to(dtype), (xt, Bt, Ct, S)


def step(model: MambaLm, cache: Dict[str, torch.Tensor], token: torch.Tensor,
         dtype=torch.bfloat16) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Advance one token: token [B] -> (logits [B, V], new cache). The math of
    :func:`forward` at every position: the conv over the cached tail, the
    scan recurrence in float32."""
    cfg = model.cfg
    res = model.embedding.to(dtype)[token].float()
    names = (("conv", "conv_B", "conv_C", "ssm") if cfg.ssm_variant == "mamba2"
             else ("conv", "ssm"))
    layer_step = _layer_step2 if cfg.ssm_variant == "mamba2" else _layer_step1
    new = {k: [] for k in names}
    for i, layer in enumerate(model.layers):
        p = layer.params()
        hcur = rms_norm(res.to(dtype), p["norm_weight"], cfg.norm_epsilon)
        out, state = layer_step(p, cfg, hcur, *(cache[k][i] for k in names), dtype)
        res = res + out.float()
        for k, v in zip(names, state):
            new[k].append(v)
    logits, _ = _head(model, res, dtype)
    return logits, {k: torch.stack(v) for k, v in new.items()}


def _pick(logits: torch.Tensor, generator: Optional[torch.Generator], temperature: float,
          top_k: Optional[int]) -> torch.Tensor:
    logits = logits.float()
    if generator is None or temperature == 0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(model: MambaLm, prompt_ids: torch.Tensor, n_new: int,
             generator: Optional[torch.Generator] = None, temperature: float = 1.0,
             top_k: Optional[int] = None, dtype=torch.bfloat16) -> torch.Tensor:
    """Autoregressive sampling: prompt [B, Lp] -> continuation [B, n_new].
    ``generator=None`` or ``temperature=0`` decodes greedily (argmax);
    otherwise temperature / top-k sampling from ``generator`` (on the
    model's device). Prefill runs :func:`step` over the prompt."""
    cache = init_cache(model.cfg, prompt_ids.shape[0], device=prompt_ids.device)
    for t in range(prompt_ids.shape[1]):
        logits, cache = step(model, cache, prompt_ids[:, t], dtype)
    toks = []
    for i in range(n_new):
        toks.append(_pick(logits, generator, temperature, top_k))
        if i + 1 < n_new:
            logits, cache = step(model, cache, toks[-1], dtype)
    return torch.stack(toks, dim=1).to(prompt_ids.dtype)
