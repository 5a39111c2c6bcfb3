"""Plain PyTorch SSD chunk scan, mirroring the shared-B/C branch of
``repro.models.ssm.ssd_chunked`` (ssm.py:109-149), which is the Pallas
kernel's arithmetic (``repro/kernels/ssd_scan/kernel.py``).  Per (b, h),
over chunks of Q = min(chunk, S) steps in order, with cum = cumsum(a)
inside the chunk and total = cum[-1]:

    y = e^{cum} (C h^T) + ((C B^T) o e^{cum_q - cum_k} [k <= q]) x
    h <- e^{total} h + (B e^{total - cum})^T x

The decay is taken as the exponential of a difference, masked to -1e30
above the diagonal before the exponential: e^{cum_q} e^{-cum_k} would
overflow float32 once -cum passes ~88.  All arithmetic in float32; y in
x's type, the state in float32.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def ssd_scan_ref(x: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                 cmat: torch.Tensor, h0: torch.Tensor, *,
                 chunk: int = 128):
    """x (B,S,H,P); a (B,S,H) log-decay; bmat, cmat (B,S,N) shared
    across heads; h0 (B,H,P,N).  S must be a multiple of min(chunk, S).
    Returns y (B,S,H,P) in x's type and h_final (B,H,P,N) float32."""
    B, S, H, P = x.shape
    N = bmat.shape[-1]
    Q = min(chunk, S)
    assert S % Q == 0
    nc = S // Q
    xc = x.reshape(B, nc, Q, H, P)
    ac = a.reshape(B, nc, Q, H)
    bc = bmat.reshape(B, nc, Q, N)
    cc = cmat.reshape(B, nc, Q, N)
    idx = torch.arange(Q, device=x.device)
    tri = idx[:, None] >= idx[None, :]                    # (Q, Q) k <= q
    h = h0.float()
    ys = []
    for c in range(nc):
        b_, c_, x32 = bc[:, c].float(), cc[:, c].float(), xc[:, c].float()
        cum = torch.cumsum(ac[:, c].float(), dim=1)        # (B,Q,H) inclusive
        total = cum[:, -1]                                 # (B,H)
        # off-diagonal: contribution of the incoming state
        y_off = torch.einsum("bqn,bhpn->bqhp", c_, h) \
            * torch.exp(cum)[..., None]
        # intra-chunk quadratic with masked decays
        scores = torch.einsum("bqn,bkn->bqk", c_, b_)[..., None]
        logdec = cum[:, :, None, :] - cum[:, None, :, :]   # (B,Q,Q,H)
        logdec = torch.where(tri[None, :, :, None], logdec, NEG_INF)
        y_diag = torch.einsum("bqkh,bkhp->bqhp", scores * torch.exp(logdec),
                              x32)
        # state update
        w = torch.exp(total[:, None] - cum)                # (B,Q,H)
        h = h * torch.exp(total)[..., None, None] \
            + torch.einsum("bqhp,bqn,bqh->bhpn", x32, b_, w)
        ys.append((y_off + y_diag).to(x.dtype))
    return torch.stack(ys, dim=1).reshape(B, S, H, P), h
