"""SSD (Mamba-2) adjoint of one direction — plain PyTorch.

Counterpart of ``plantcaduceus_tpu.ops.pallas_ssd._ssd_dir_bwd_kernel_call``
(the TPU kernel K6, ``_bwd_kernel``), and the plain version of the CUDA
kernel ``csrc/ssd_bwd.cu`` (:func:`.cuda_ssd.ssd_dir_bwd`), which is held to
it on the card. It mirrors ``ops/scan_bwd.py``, the plain version of K3.

Per head, with x̃ = dt'·x and Q[t,s] = (C[t]·B[s]) decay(t←s) (g[t]·x̃[s])
over the pairs of the forward's mask (s ≤ t; s ≥ t for the reverse
direction):

    dx̃[s]  = Σ_t (C[t]·B[s]) decay(t←s) g[t]        dx = dt'·dx̃ + D·g
    dB[s]  = Σ_h Σ_t decay(t←s) (g[t]·x̃[s]) C[t]     dC[t] likewise over s
    mass[r] = ∂L/∂(dt'[r]·A) = Σ of Q over the pairs whose decay spans r
    ddt_raw = sigmoid(dt + dt_bias) · (Σ_p x·dx̃ + mass·A)

computed chunk by chunk as the kernel does. Within a chunk (batched over
rows, chunks and heads): C·Bᵀ, g·x̃ᵀ, the masked decays, and from them the
chunk-local parts of dx̃, dB, dC and of the mass, whose sum over the pairs
(t, s) of the chunk that span r is a difference of prefix sums of Q's
column and row sums (no T×T×T product). Across chunks: the cotangent state
Rv [N, P] per head, carried from the last processed chunk to the first,
against the forward's chunk-entry states F (``fentry``), gives the
boundary parts: exp2(outof)·B·Rv into dx̃, exp2(outof)·x̃·Rvᵀ into dB,
(g·exp2(into))·Fᵀ into dC, and the mass's entry, exit and entry×exit terms
(prefix sums of exp2(into)·W and exp2(outof)·V0, and exp2(total)·<Rv, F>).

``pre_silu`` (the fused mixer's training backward): x, Bm and Cm hold the
pre-SiLU conv accumulators. SiLU is applied here, the returned dx, dB and
dC are cotangents of the accumulators (SiLU' chained on), and two more
outputs come back: gx = Σ_P g·x (for dD) and dtp = dt' (for dA).

Numerics: every output float32. With bfloat16 inputs the product operands
are rounded to bfloat16 and multiplied in float32, as the kernel does (its
products on the tensor cores): C, B, g, x̃, the scores, the masked g·x̃ᵀ,
Rv, F and g·exp2(into). The mass sums are float32 throughout (the TPU
kernel takes its chunk-local and boundary sums as mask products with
rounded operands; the card's kernel and this version take prefix sums).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from plantcaduceus_tpu_torch.ops.selective_scan import LOG2E, softplus
from plantcaduceus_tpu_torch.ops.ssd import fit_chunk


def silu_grad(a: torch.Tensor) -> torch.Tensor:
    """d silu(a) / da = sigmoid(a) · (1 + a·(1 − sigmoid(a)))."""
    s = torch.sigmoid(a)
    return s * (1 + a * (1 - s))


def _suffix(v: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix sums along the last axis."""
    return v.flip(-1).cumsum(-1).flip(-1)


def ssd_dir_bwd(x, dt, A, Bm, Cm, Dskip, dt_bias, fentry, g, chunk: int, reverse: bool,
                pre_silu: bool = False):
    """Adjoint of :func:`.cuda_ssd.ssd_dir` for one direction.

    x [R, L, H*P], dt [R, L, H] raw, Bm/Cm [R, L, NG, N], all of one dtype
    (with ``pre_silu``, the pre-SiLU accumulators of x, B and C); A, Dskip,
    dt_bias [H]; fentry [R, L/T, N, H*P] float32, the forward's chunk-entry
    states; g [R, L, H*P] the output's cotangent. Returns ``(dx, dB, dC,
    ddt_raw, dmass)`` — [R, L, H*P], [R, L, NG, N] twice, [R, L, H] twice —
    and with ``pre_silu`` also ``gx`` and ``dtp`` [R, L, H]; all float32."""
    R, L, HP = x.shape
    H = dt.shape[-1]
    P = HP // H
    NG, N = Bm.shape[-2:]
    hg = H // NG
    T = fit_chunk(chunk, L)
    nc = L // T
    mm = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32

    def rnd(t):  # a product operand, rounded to the product type
        return t.to(mm).float()

    def heads(t, width):  # [R, L, H*W] -> [R, nc, H, T, W]
        return t.reshape(R, nc, T, H, width).permute(0, 1, 3, 2, 4)

    def groups(t):  # [R, L, NG, N] -> [R, nc, H, T, N] (each group's rows per head)
        t = t.reshape(R, nc, T, NG, N).permute(0, 1, 3, 2, 4)
        return t.repeat_interleave(hg, dim=2)

    acc_x, acc_B, acc_C = x.float(), Bm.float(), Cm.float()
    xv, Bv, Cv = ((F.silu(a) for a in (acc_x, acc_B, acc_C)) if pre_silu
                  else (acc_x, acc_B, acc_C))
    dt_in = dt.float() + dt_bias.float()
    dtp = softplus(dt_in)                                       # [R, L, H]
    dtph = dtp.reshape(R, nc, T, H).permute(0, 1, 3, 2)          # [R, nc, H, T]
    la = dtph * (A.float()[:, None] * LOG2E)
    cum = la.cumsum(-1)
    total = cum[..., -1:]
    if not reverse:
        segb, into, outof = cum, cum, total - cum
    else:
        e = cum - la
        segb, into, outof = -e, total - e, e
    idx = torch.arange(T, device=x.device)
    mask = (idx[:, None] >= idx[None, :]) if not reverse else (idx[:, None] <= idx[None, :])
    seg = segb[..., :, None] - segb[..., None, :]
    segexp = torch.exp2(torch.where(mask, seg, torch.full_like(seg, -torch.inf)))
    into_e, scale, tote = torch.exp2(into), torch.exp2(outof), torch.exp2(total)

    xh = heads(xv, P)                                           # [R, nc, H, T, P]
    gh = heads(g.float(), P)
    xt = xh * dtph[..., None]                                   # x̃
    Bh, Ch = groups(Bv), groups(Cv)                             # [R, nc, H, T, N]

    # --- within each chunk --------------------------------------------------
    GBC = rnd(Ch) @ rnd(Bh).transpose(-1, -2)                   # [.., T(t), T(s)]
    GXG = rnd(gh) @ rnd(xt).transpose(-1, -2)
    scores, M = GBC * segexp, GXG * segexp
    Q = GBC * M
    colsum, rowsum = Q.sum(-2), Q.sum(-1)                       # over t; over s
    if not reverse:  # pairs s <= r <= t
        m_intra = colsum.cumsum(-1) - (rowsum.cumsum(-1) - rowsum)
    else:            # pairs t <= r <= s
        m_intra = rowsum.cumsum(-1) - (colsum.cumsum(-1) - colsum)
    dxt = rnd(scores).transpose(-1, -2) @ rnd(gh)               # [.., T(s), P]
    dBh = rnd(M).transpose(-1, -2) @ rnd(Ch)                    # [.., T(s), N]
    dCh = rnd(M) @ rnd(Bh)                                      # [.., T(t), N]

    # --- across chunks: the cotangent state, last processed chunk first ------
    Fe = fentry.float().reshape(R, nc, N, H, P).permute(0, 1, 3, 2, 4)   # [R, nc, H, N, P]
    gi = rnd(gh * into_e[..., None])                            # g · exp2(into)
    xRv, BRv, gF = torch.empty_like(dBh), torch.empty_like(dxt), torch.empty_like(dCh)
    scal = torch.empty_like(total)
    Rv = x.new_zeros((R, H, N, P), dtype=torch.float32)
    for c in (range(nc) if reverse else range(nc - 1, -1, -1)):
        Rvr = rnd(Rv)
        xRv[:, c] = rnd(xt[:, c]) @ Rvr.transpose(-1, -2)
        BRv[:, c] = rnd(Bh[:, c]) @ Rvr
        gF[:, c] = gi[:, c] @ rnd(Fe[:, c]).transpose(-1, -2)
        scal[:, c, :, 0] = (Rv * Fe[:, c]).sum((-1, -2))
        Rv = tote[:, c, :, :, None] * Rv + rnd(Ch[:, c]).transpose(-1, -2) @ gi[:, c]

    dxt = dxt + scale[..., None] * BRv
    dBh = dBh + scale[..., None] * xRv
    dCh = dCh + gF
    w_in = (Ch * gF).sum(-1)                                    # exp2(into)·W
    v_out = scale * (Bh * xRv).sum(-1)                          # exp2(outof)·V0
    if not reverse:
        sum_up, sum_dn = _suffix(w_in), v_out.cumsum(-1)
    else:
        sum_up, sum_dn = w_in.cumsum(-1), _suffix(v_out)
    ddirect = (xh * dxt).sum(-1)                                # [R, nc, H, T]
    xdx = (xt * dxt).sum(-1)
    mass = m_intra + sum_up + sum_dn + tote * scal - xdx
    ddtp = ddirect + mass * A.float()[:, None]

    def flat(t):  # [R, nc, H, T(, W)] -> [R, L, H(*W)]
        if t.dim() == 4:
            return t.permute(0, 1, 3, 2).reshape(R, L, H)
        return t.permute(0, 1, 3, 2, 4).reshape(R, L, H * t.shape[-1])

    dx = flat(dtph[..., None] * dxt + Dskip.float()[:, None, None] * gh)
    # per-head parts summed over the group's heads, in head order
    dB = flat(dBh).reshape(R, L, NG, hg, N).sum(3)
    dC = flat(dCh).reshape(R, L, NG, hg, N).sum(3)
    dmass = flat(mass)
    ddt_raw = torch.sigmoid(dt_in) * flat(ddtp)
    if not pre_silu:
        return dx, dB, dC, ddt_raw, dmass
    dx = dx * silu_grad(acc_x)
    dB = dB * silu_grad(acc_B)
    dC = dC * silu_grad(acc_C)
    gx = (g.float() * xv).reshape(R, L, H, P).sum(-1)
    return dx, dB, dC, ddt_raw, dmass, gx, dtp
