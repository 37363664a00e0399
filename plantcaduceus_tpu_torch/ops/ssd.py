"""SSD (Mamba-2 / state-space duality) recurrence — plain PyTorch versions.

Counterpart of ``plantcaduceus_tpu.ops.ssd``. These are the CPU oracles of
the CUDA kernels K4 (:mod:`.cuda_ssd`) and K5 (:mod:`.cuda_mixer2`).

Semantics (per head h with head dim P, state size N, B/C shared per group):

    dt'   = softplus(dt + dt_bias)                  [.., L, H]
    a[t]  = exp(dt'[t,h] * A[h])                    scalar per (t, h)
    S[t]  = a[t] * S[t-1] + dt'[t] * B[t] ⊗ x[t]    S: [H, N, P]
    y[t]  = C[t]ᵀ S[t] + D[h] * x[t]                [.., L, H, P]

Chunked form (chunk length T; everything is a matrix product):

    within chunk:  scores[t,s] = (C[t]·B[s]) * exp(cum[t]-cum[s]) * dt'[s]
                   Y_intra = scores @ X
    chunk state:   states = (B * dt' * decay_to_end)ᵀ @ X
    across chunks: S[c] = exp(Σ la_c) * S[c-1] + states[c]
    inter:         Y_inter[t] = (C[t] @ S_prev) * exp(cum[t])

The reverse (anticausal) direction is native, with no flipped copy of any
``[.., L, ..]`` tensor: the in-chunk mask transposes, the cumulative decays
become exclusive/suffix sums and the chunk-state pass runs from the last
chunk to the first.

Decays, the inter-chunk state and every accumulation are float32. With
bfloat16 inputs the matrix-product operands (scores, x, B, C, the boundary
states) are rounded to bfloat16 and multiplied in float32, which is what the
TPU's bf16 MXU products with float32 accumulation compute. The tensor of
segment sums is masked before the exponent (``exp(where(mask, seg,
-inf))``): masked-out entries can be large and positive, and exponentiating
them first would give ``inf * 0 = nan``.

Shapes (group axis G = scan directions, as in ``ops/selective_scan.py``):

    x       [G, B, L, H, P]
    dt      [G, B, L, H]
    A       [G, H]                (negative reals; pass -exp(A_log))
    Bm, Cm  [G, B, L, NG, N]      (NG groups; H % NG == 0)
    Dskip   [G, H]
    dt_bias [G, H]
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from plantcaduceus_tpu_torch.ops.selective_scan import softplus


def fit_chunk(chunk: int, L: int) -> int:
    """The chunk length for a sequence of ``L`` steps: ``min(chunk, L)``,
    which must divide ``L`` (a non-dividing chunk would leave the tail
    steps out of every chunk)."""
    T = min(chunk, L)
    if T <= 0 or L % T:
        raise ValueError(f"SSD chunk {T} does not divide the sequence length {L}")
    return T


def _prep(x, dt, A, Bm, Cm, Dskip, dt_bias, dt_softplus):
    x, dt, A, Bm, Cm, Dskip = (t.float() for t in (x, dt, A, Bm, Cm, Dskip))
    if dt_bias is not None:
        dt = dt + dt_bias.float()[:, None, None, :]
    if dt_softplus:
        dt = softplus(dt)
    return x, dt, A, Bm, Cm, Dskip


def ssd_sequential(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    Dskip: torch.Tensor,
    dt_bias: Optional[torch.Tensor] = None,
    dt_softplus: bool = True,
    directions: Sequence[bool] = (False,),
) -> torch.Tensor:
    """Ground-truth recurrence: a Python loop over time. ``directions[g]``
    True runs group g right to left (flip, causal scan, flip)."""
    out_dtype = x.dtype
    x, dt, A, Bm, Cm, Dskip = _prep(x, dt, A, Bm, Cm, Dskip, dt_bias, dt_softplus)
    G, B, L, H, P = x.shape
    NG, N = Bm.shape[-2:]
    hg = H // NG
    ys = []
    for g in range(G):
        rev = bool(directions[g]) if g < len(directions) else False
        S = x.new_zeros((B, H, N, P))
        yg = [None] * L
        for t in (range(L - 1, -1, -1) if rev else range(L)):
            a = torch.exp(dt[g, :, t] * A[g])                       # [B, H]
            Bh = Bm[g, :, t].repeat_interleave(hg, dim=1)           # [B, H, N]
            Ch = Cm[g, :, t].repeat_interleave(hg, dim=1)
            S = a[..., None, None] * S + torch.einsum(
                "bhn,bhp->bhnp", Bh * dt[g, :, t, :, None], x[g, :, t])
            yg[t] = torch.einsum("bhn,bhnp->bhp", Ch, S)
        ys.append(torch.stack(yg, dim=1))
    y = torch.stack(ys) + Dskip[:, None, None, :, None] * x
    return y.to(out_dtype)


def _mm(a: torch.Tensor, b: torch.Tensor, mm_dtype) -> torch.Tensor:
    """``a @ b`` with both operands rounded to ``mm_dtype``, multiplied and
    summed in float32."""
    return a.to(mm_dtype).float() @ b.to(mm_dtype).float()


def chunk_scan(xg, dtg, Ag, Bg, Cg, chunk: int, rev: bool,
               mm_dtype=torch.float32, emit_fentry: bool = False):
    """One direction of the chunked SSD (JAX ``_chunk_group``). xg [B, L, H,
    P] float32, dtg [B, L, H] (softplus applied), Ag [H], Bg/Cg [B, L, NG,
    N]. Returns y [B, L, H, P] float32 without the D-skip; with
    ``emit_fentry`` also the float32 state each chunk starts from, in the
    layout of the TPU kernel's ``emit_fentry`` output: ``[B, L/T, N, H*P]``
    by chunk index (for ``rev``, the state that enters from the chunk's
    end)."""
    B, L, H, P = xg.shape
    NG, N = Bg.shape[-2:]
    hg = H // NG
    T = fit_chunk(chunk, L)
    nc = L // T

    # Head-major layout: every product is a batched matmul over the two
    # minor axes.
    xh = xg.reshape(B, nc, T, NG, hg, P).permute(0, 1, 3, 4, 2, 5)     # [B,nc,NG,hg,T,P]
    dth = dtg.reshape(B, nc, T, NG, hg).permute(0, 1, 3, 4, 2)         # [B,nc,NG,hg,T]
    Bh = Bg.reshape(B, nc, T, NG, N).permute(0, 1, 3, 2, 4)            # [B,nc,NG,T,N]
    Ch = Cg.reshape(B, nc, T, NG, N).permute(0, 1, 3, 2, 4)

    la = dth * Ag.float().reshape(NG, hg, 1)   # log-decay (negative)
    cum = torch.cumsum(la, dim=-1)
    idx = torch.arange(T, device=xg.device)
    if not rev:
        # decay(t <- s) = exp(cum[t] - cum[s]) for s <= t
        seg = cum[..., :, None] - cum[..., None, :]
        mask = idx[:, None] >= idx[None, :]
        into = cum                       # chunk start -> t, applied to S_prev
        outof = cum[..., -1:] - cum      # t -> chunk end
    else:
        # h[t] = a[t] h[t+1] + b[t]: exclusive cumsum e, decay(t <- s) =
        # exp(e[s] - e[t]) for s >= t; the boundary state enters from the
        # chunk end and leaves to the chunk start.
        e = cum - la
        seg = e[..., None, :] - e[..., :, None]
        mask = idx[:, None] <= idx[None, :]
        into = cum[..., -1:] - e
        outof = e
    segexp = torch.exp(torch.where(mask, seg, torch.full_like(seg, -torch.inf)))

    GBC = _mm(Ch, Bh.transpose(-1, -2), mm_dtype)                      # [B,nc,NG,T,T]
    scores = GBC[:, :, :, None] * segexp * dth[..., None, :]
    y_intra = _mm(scores, xh, mm_dtype)                                # [B,nc,NG,hg,T,P]

    w = Bh[:, :, :, None] * (dth * torch.exp(outof))[..., None]       # [B,nc,NG,hg,T,N]
    states = _mm(w.transpose(-1, -2), xh, mm_dtype)                    # [B,nc,NG,hg,N,P]

    total = torch.exp(la.sum(dim=-1))                                  # [B,nc,NG,hg]
    S = torch.zeros((B, NG, hg, N, P), dtype=torch.float32, device=xg.device)
    S_prev = [None] * nc
    for c in (range(nc - 1, -1, -1) if rev else range(nc)):
        S_prev[c] = S
        S = total[:, c, ..., None, None] * S + states[:, c]
    S_prev = torch.stack(S_prev, dim=1)                                # [B,nc,NG,hg,N,P]

    y_inter = _mm(Ch[:, :, :, None], S_prev, mm_dtype) * torch.exp(into)[..., None]
    y = (y_intra + y_inter).permute(0, 1, 4, 2, 3, 5)                  # [B,nc,T,NG,hg,P]
    y = y.reshape(B, L, H, P)
    if emit_fentry:
        return y, S_prev.permute(0, 1, 4, 2, 3, 5).reshape(B, nc, N, H * P)
    return y


def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    Dskip: torch.Tensor,
    dt_bias: Optional[torch.Tensor] = None,
    dt_softplus: bool = True,
    chunk: int = 128,
    directions: Sequence[bool] = (False,),
) -> torch.Tensor:
    """Chunked (matrix-product) SSD. bfloat16 inputs keep bfloat16 product
    operands; float32 inputs compute in float32 throughout."""
    out_dtype = x.dtype
    mm_dtype = torch.bfloat16 if out_dtype == torch.bfloat16 else torch.float32
    x, dt, A, Bm, Cm, Dskip = _prep(x, dt, A, Bm, Cm, Dskip, dt_bias, dt_softplus)
    ys = [chunk_scan(x[g], dt[g], A[g], Bm[g], Cm[g], chunk,
                     bool(directions[g]) if g < len(directions) else False, mm_dtype)
          for g in range(x.shape[0])]
    y = torch.stack(ys) + Dskip[:, None, None, :, None] * x
    return y.to(out_dtype)
