"""Mamba2: SSD (state-space duality) blocks.

Counterpart of ``repro.models.ssm``.  The chunked SSD form of the
recurrence

    h_t = exp(dt_t A_h) h_{t-1} + dt_t B_t x_tᵀ ,    y_t = C_t h_t + D x_t

is, within a chunk of Q tokens, a masked quadratic "attention" (scores
``(C_i . B_j) decay(i, j) dt_j``), and across chunks a small (H, N, P)
state carried from chunk to chunk.  The intra-chunk part and each
chunk's local end state come from :func:`repro_torch.kernels.ssd_chunk.
ssd_intra_chunk_grouped`: the hand-written kernel on the card, its plain
version on the CPU, with a hand-written backward of each (the
reference's ``_segsum_decay`` helper of that part has no counterpart
here).  The scan over chunks is a Python loop, differentiated by
autograd.

One deliberate departure from the reference: its ``_segsum_decay``
takes ``exp`` of every pair's difference and drops the masked ones with
a ``where``.  A masked difference is positive and passes ``exp``'s range
(88.7) at mamba2's decays over 128 tokens, so the reference's gradient
is NaN there (0 · inf); the port never forms that infinity and its
gradients stay finite.  The values are the same.

Single-token decode keeps O(1) state per sequence: the (B, H, N, P)
SSM state and a (K-1)-deep causal-conv window.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..kernels.ssd_chunk import ssd_intra_chunk_grouped
from .common import rms_norm
from .linear import linear


class SSMState(NamedTuple):
    """Decode-time recurrent state of a stack of Mamba2 layers."""
    ssm: torch.Tensor    # (L, B, H, N, P) fp32
    conv: torch.Tensor   # (L, B, K-1, conv_channels)

    @staticmethod
    def alloc(layers, batch, heads, state, head_dim, conv_k, conv_ch, *,
              dtype=torch.float32, device=None) -> "SSMState":
        return SSMState(
            ssm=torch.zeros((layers, batch, heads, state, head_dim),
                            dtype=torch.float32, device=device),
            conv=torch.zeros((layers, batch, conv_k - 1, conv_ch),
                             dtype=dtype, device=device))


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, S, Ch); w: (K, Ch); b: (Ch,)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    # sum_k x[t - (K-1) + k] * w[k]
    out = sum(xp[:, k:k + S, :] * w[k] for k in range(K))
    return out + b


def causal_conv1d_step(x_new: torch.Tensor, conv_state: torch.Tensor,
                       w: torch.Tensor, b: torch.Tensor):
    """One-token conv update.  x_new: (B, Ch); conv_state: (B, K-1, Ch).
    Returns (out (B, Ch), new conv_state)."""
    window = torch.cat([conv_state, x_new[:, None, :]], dim=1)   # (B,K,Ch)
    out = torch.einsum("bkc,kc->bc", window, w) + b
    return out, window[:, 1:, :]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                chunk: int = 128, init_state: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """Chunked SSD scan.

    x: (B, S, H, P) f32; dt: (B, S, H) f32 (already softplus'd, > 0);
    a_log: (H,) with A = -exp(a_log); b, c: (B, S, G, N); d_skip: (H,).
    ``S`` must be a multiple of ``Q = min(chunk, S)``, as in the
    reference (no padding).  Returns y (B, S, H, P) [+ final state
    (B, H, N, P)].
    """
    B, S, H, P = x.shape
    G, N = b.shape[-2], b.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"ssd_chunked: sequence {S} is not a multiple of "
                         f"the chunk {Q}")
    nc = S // Q

    a = -torch.exp(a_log.float())                        # (H,) negative
    da = dt * a                                          # (B, S, H)
    # b and c per group: one group reaches the kernel as a head broadcast
    # of stride 0, with no copy
    y_intra, s_local = ssd_intra_chunk_grouped(
        x.contiguous().reshape(B * nc, Q, H, P),
        dt.contiguous().reshape(B * nc, Q, H),
        da.contiguous().reshape(B * nc, Q, H),
        b.contiguous().reshape(B * nc, Q, G, N),
        c.contiguous().reshape(B * nc, Q, G, N))
    y_intra = y_intra.reshape(B, nc, Q, H, P)
    s_local = s_local.reshape(B, nc, H, N, P)

    # ---- inter-chunk state recurrence ----
    clog = torch.cumsum(da.reshape(B, nc, Q, H), dim=2)  # (B, nc, Q, H)
    decay_chunk = torch.exp(clog[:, :, -1, :])           # (B, nc, H)
    s = init_state if init_state is not None \
        else torch.zeros((B, H, N, P), dtype=s_local.dtype, device=x.device)
    s_in = []
    for k in range(nc):
        s_in.append(s)                                   # state before chunk
        s = decay_chunk[:, k, :, None, None] * s + s_local[:, k]
    s_in = torch.stack(s_in, dim=1)                      # (B, nc, H, N, P)

    ch = c.expand(B, S, H, N) if G == 1 else \
        torch.repeat_interleave(c, H // G, dim=2)        # (B, S, H, N)
    y_inter = torch.einsum("bcqhn,bcqh,bchnp->bcqhp",
                           ch.reshape(B, nc, Q, H, N), torch.exp(clog), s_in)
    y = (y_intra + y_inter).reshape(B, S, H, P) + \
        x * d_skip[None, None, :, None]
    if return_state:
        return y, s
    return y


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                    state: torch.Tensor):
    """One-token SSD update.

    x: (B, H, P); dt: (B, H); b, c: (B, G, N); state: (B, H, N, P) f32.
    Returns (y (B, H, P), new state).
    """
    H = x.shape[1]
    rep = H // b.shape[-2]
    bh = torch.repeat_interleave(b, rep, dim=1) if rep > 1 else b
    ch = torch.repeat_interleave(c, rep, dim=1) if rep > 1 else c
    a = -torch.exp(a_log.float())
    dec = torch.exp(dt * a)                              # (B, H)
    new_state = dec[..., None, None] * state + \
        torch.einsum("bhn,bhp,bh->bhnp", bh, x, dt)
    y = torch.einsum("bhn,bhnp->bhp", ch, new_state) + \
        x * d_skip[None, :, None]
    return y, new_state


# ---------------------------------------------------------------------------
# Full Mamba2 block (in_proj -> conv -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------

def mamba2_mixer(h: torch.Tensor, p: dict, cfg, *,
                 ssm_state: Optional[torch.Tensor] = None,
                 conv_state: Optional[torch.Tensor] = None,
                 decode: bool = False, want_state: bool = False):
    """Apply one Mamba2 mixer.

    h: (B, S, d) (S == 1 when decoding).  ``p`` keys: in_proj, conv_w,
    conv_b, a_log, d_skip, dt_bias, norm, out_proj.  Returns (out,
    (new_ssm_state, new_conv_state)); the states are None unless
    decoding or ``want_state``.  The conv state is the last K-1 pre-conv
    channel rows (zeros before the prompt's start).
    """
    B, S, _ = h.shape
    d_in = cfg.ssm_d_inner
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    G = max(1, cfg.ssm_groups)
    conv_ch = d_in + 2 * G * N

    zxbcdt = linear(h, p["in_proj"])
    z, xbc, dt_raw = torch.split(zxbcdt, [d_in, conv_ch, H], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())     # (B, S, H)

    new_conv = None
    if decode:
        xbc_c, new_conv = causal_conv1d_step(
            xbc[:, 0, :], conv_state, p["conv_w"], p["conv_b"])
        xbc_c = xbc_c[:, None, :]
    else:
        xbc_c = causal_conv1d(xbc, p["conv_w"], p["conv_b"])
        if want_state:
            K = cfg.ssm_conv_dim
            new_conv = F.pad(xbc, (0, 0, K - 1, 0))[:, -(K - 1):, :]
    xbc_c = F.silu(xbc_c)
    x, bmat, cmat = torch.split(xbc_c, [d_in, G * N, G * N], dim=-1)
    x = x.reshape(B, S, H, P).float()
    bmat = bmat.reshape(B, S, G, N).float()
    cmat = cmat.reshape(B, S, G, N).float()

    new_ssm = None
    if decode:
        y, new_ssm = ssd_decode_step(
            x[:, 0], dt[:, 0], p["a_log"], bmat[:, 0], cmat[:, 0],
            p["d_skip"], ssm_state)
        y = y[:, None]
    elif want_state:
        y, new_ssm = ssd_chunked(x, dt, p["a_log"], bmat, cmat, p["d_skip"],
                                 chunk=cfg.ssd_chunk, return_state=True)
    else:
        y = ssd_chunked(x, dt, p["a_log"], bmat, cmat, p["d_skip"],
                        chunk=cfg.ssd_chunk)

    y = y.reshape(B, S, d_in).to(h.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return linear(y, p["out_proj"]), (new_ssm, new_conv)
