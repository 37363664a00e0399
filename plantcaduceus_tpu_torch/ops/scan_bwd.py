"""Selective-scan backward with chunked recomputation — plain PyTorch.

Counterpart of ``plantcaduceus_tpu.ops.scan_bwd.selective_scan_grads``: the
reference gradient that recomputes states chunk-locally from the boundary
states, so live memory is O(chunk · D · N) instead of O(L · D · N):

  forward recurrence   h[t] = a[t] h[t-1] + b[t]
  adjoint recurrence   g[t] = C[t]⊗gy[t] + a[t+1] g[t+1]   (reverse scan)

  dx   = (Σ_n g·B) · dt'            + gy · D
  dB   = Σ_d g · dt'·x              dC = Σ_d gy · h
  ddt' = Σ_n g·h[t-1]·a·A + (Σ_n g·B) · x
  dA   = Σ_t g·h[t-1]·a·dt'         dD = Σ_t gy·x

with the softplus / dt-bias chain on top. It is the independent reference
that the plain K3 (``ops.selective_scan.scan_direction_bwd``, which the
kernel is held to on the card) is tested against, beside torch autograd;
the group-axis layout ``[G, B, L, D]``, the forward-only direction and the
natural ``exp`` are the JAX function's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def selective_scan_grads(
    x: torch.Tensor,        # [G, B, L, D]
    dt_raw: torch.Tensor,   # [G, B, L, D] pre-softplus (post low-rank projection)
    A: torch.Tensor,        # [G, D, N]
    Bm: torch.Tensor,       # [G, B, L, N]
    Cm: torch.Tensor,
    Dskip: torch.Tensor,    # [G, D]
    dt_bias: torch.Tensor,  # [G, D]
    gy: torch.Tensor,       # [G, B, L, D]
    hb: Optional[torch.Tensor] = None,   # [G*B, nl, D, N] forward boundary states
    chunk: int = 128,
) -> Tuple[torch.Tensor, ...]:
    """Returns (dx, ddt_raw, dA, dBm, dCm, dDskip, ddt_bias), all float32."""
    x, dt_raw, Bm, Cm, gy, A = (t.float() for t in (x, dt_raw, Bm, Cm, gy, A))
    G, B, L, D = x.shape
    N = A.shape[-1]
    chunk = min(chunk, L)
    while L % chunk:
        chunk //= 2
    nl = L // chunk
    pre = dt_raw + dt_bias.float()[:, None, None, :]
    dtp = F.softplus(pre)
    a_all = torch.exp(dtp[..., None] * A[:, None, None])      # [G, B, L, D, N]
    b_all = (dtp * x)[..., None] * Bm[:, :, :, None, :]

    if hb is not None and hb.shape[1] == nl:
        h_ins = hb.float().reshape(G, B, nl, D, N).unbind(2)
    else:  # boundary states not available at this chunking: recompute serially
        h, h_ins = x.new_zeros((G, B, D, N)), []
        for c in range(nl):
            h_ins.append(h)
            for t in range(c * chunk, (c + 1) * chunk):
                h = a_all[:, :, t] * h + b_all[:, :, t]

    dx, ddtp = torch.empty_like(x), torch.empty_like(x)
    dBm, dCm = torch.empty_like(Bm), torch.empty_like(Cm)
    dA = torch.zeros_like(A)
    g_next = x.new_zeros((G, B, D, N))
    for c in reversed(range(nl)):
        t0 = c * chunk
        hs, h = [], h_ins[c]
        for t in range(t0, t0 + chunk):
            h = a_all[:, :, t] * h + b_all[:, :, t]
            hs.append(h)
        g = g_next
        for k in reversed(range(chunk)):
            t = t0 + k
            g = Cm[:, :, t, None, :] * gy[:, :, t, :, None] + g
            h_prev = hs[k - 1] if k else h_ins[c]
            da_scaled = g * h_prev * a_all[:, :, t]
            sum_gB = torch.einsum("gbdn,gbn->gbd", g, Bm[:, :, t])
            ddtp[:, :, t] = torch.einsum("gbdn,gdn->gbd", da_scaled, A) + sum_gB * x[:, :, t]
            dx[:, :, t] = sum_gB * dtp[:, :, t]
            dBm[:, :, t] = torch.einsum("gbdn,gbd->gbn", g, dtp[:, :, t] * x[:, :, t])
            dCm[:, :, t] = torch.einsum("gbd,gbdn->gbn", gy[:, :, t], hs[k])
            dA += torch.einsum("gbdn,gbd->gdn", da_scaled, dtp[:, :, t])
            g = a_all[:, :, t] * g
        g_next = g

    dx = dx + gy * Dskip.float()[:, None, None, :]
    dDskip = torch.einsum("gbld,gbld->gd", gy, x)
    ddt_raw = ddtp * torch.sigmoid(pre)
    ddt_bias = ddt_raw.sum((1, 2))
    return dx, ddt_raw, dA, dBm, dCm, dDskip, ddt_bias
