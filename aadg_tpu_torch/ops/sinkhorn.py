"""Entropic OT (debiased Sinkhorn divergence) with the K1 softmin kernel.

Port of ``aadg_tpu/ops/sinkhorn.py:29-133``: log-domain symmetric Sinkhorn
with epsilon annealing (geomloss defaults blur 0.05, scaling 0.5, debias)
on the cosine cost. Every function is batched over a leading problem
dimension, and every softmin goes through ``softmin``: the CUDA kernel
``csrc/softmin.cu`` on the card, which replaces
``aadg_tpu/ops/sinkhorn_pallas.py::_softmin_kernel``. The xy, xx and yy
problems of all divergences run in one launch per half-step, so a search
step's rewards (M policies x 3 domain pairs x 3) take 26 launches.

The softmin takes the Pallas kernel's form: rows are normalized once,
z_j = log w_j + g_j / eps is formed outside, and padded or zero-weight
columns carry -1e30.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Optional

import numpy as np
import torch

from .. import _build

_NEG_INF = -1e30


@functools.lru_cache(maxsize=None)
def _softmin_fn():
    fn = _build.load("softmin").softmin_launch
    fn.argtypes = [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cosine_cost(x: torch.Tensor, y: torch.Tensor,
                eps: float = 1e-8) -> torch.Tensor:
    """C[..., i, j] = 1 - <x_i, y_j> / (|x_i| |y_j|)."""
    return 1.0 - normalize_rows(x, eps) @ normalize_rows(y, eps).transpose(
        -1, -2)


def normalize_rows(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=eps)


def _eps_schedule(diameter: float, blur: float, scaling: float,
                  extra_iters: int) -> List[float]:
    """Annealed temperatures from diameter down to blur, then
    ``extra_iters`` more at blur; f32 values like the JAX schedule's."""
    n_anneal = max(1, int(math.ceil(
        math.log(blur / diameter) / math.log(scaling))))
    scales = [diameter * (scaling ** k) for k in range(n_anneal)]
    scales += [blur] * (extra_iters + 1)
    return [float(s) for s in np.asarray(scales, dtype=np.float32)]


def softmin_plain(eps: float, xn: torch.Tensor, yn: torch.Tensor,
                  zb: torch.Tensor) -> torch.Tensor:
    """f[p, i] = -eps * LSE_j(zb[p, j] - (1 - <xn[p, i], yn[p, j]>) / eps)
    for row-normalized xn (P, N, D), yn (P, M, D) and zb (P, M)."""
    eps = float(np.float32(eps))
    inv_eps = float(np.float32(1.0) / np.float32(eps))
    cost = 1.0 - torch.bmm(xn, yn.transpose(1, 2))
    z = zb[:, None, :] + (-cost) * inv_eps
    m = torch.amax(z, dim=-1, keepdim=True)
    s = torch.sum(torch.exp(z - m), dim=-1)
    return -eps * (m[..., 0] + torch.log(torch.clamp(s, min=1e-30)))


def softmin(eps: float, xn: torch.Tensor, yn: torch.Tensor,
            zb: torch.Tensor) -> torch.Tensor:
    """Batched log-domain softmin, (P, N, D), (P, M, D), (P, M) -> (P, N)
    f32. On the card this is one launch of K1; the plain version runs for
    CPU tensors only."""
    p, n, d = xn.shape
    m = yn.shape[1]
    if (xn.dtype != torch.float32 or yn.dtype != torch.float32
            or zb.dtype != torch.float32):
        raise ValueError("softmin takes float32 tensors")
    if tuple(yn.shape) != (p, m, d) or tuple(zb.shape) != (p, m):
        raise ValueError(f"shape mismatch: xn {tuple(xn.shape)}, "
                         f"yn {tuple(yn.shape)}, zb {tuple(zb.shape)}")
    if not (xn.device == yn.device == zb.device):
        raise ValueError("softmin inputs must be on one device")
    if xn.device.type == "cpu":
        return softmin_plain(eps, xn, yn, zb)
    if xn.device.type != "cuda" or not (
            xn.is_contiguous() and yn.is_contiguous() and zb.is_contiguous()):
        raise ValueError("softmin needs contiguous CPU or CUDA tensors")
    if p > 65535:
        raise ValueError("at most 65535 problems per launch")
    out = torch.empty((p, n), dtype=torch.float32, device=xn.device)
    _build.check(_softmin_fn()(eps, xn.data_ptr(),
                               yn.data_ptr(), zb.data_ptr(), out.data_ptr(),
                               p, n, m, d,
                               torch.cuda.current_stream().cuda_stream),
                 "softmin")
    softmin.launches += 1
    return out


softmin.launches = 0


def _ot_dual(xn, yn, log_p, log_q, p, q, eps_list):
    """Symmetric annealed Sinkhorn over a batch of problems; returns
    <p, f> + <q, g> (P,)."""
    f = torch.zeros_like(log_p)
    g = torch.zeros_like(log_q)
    for eps in eps_list:
        f_new = softmin(eps, xn, yn, log_q + g / eps)
        g_new = softmin(eps, yn, xn, log_p + f / eps)
        f = 0.5 * (f + f_new)
        g = 0.5 * (g + g_new)
    eps = eps_list[-1]
    f = softmin(eps, xn, yn, log_q + g / eps)
    g = softmin(eps, yn, xn, log_p + f / eps)
    return torch.sum(p * f, dim=-1) + torch.sum(q * g, dim=-1)


def _pad_cloud(pts, w, length):
    """Normalize rows and pad a (P, n, D) cloud to ``length`` points: padded
    points are zero with weight 0 and log-weight -1e30."""
    n = pts.shape[1]
    pts = torch.nn.functional.pad(normalize_rows(pts.float()),
                                  (0, 0, 0, length - n))
    logw = torch.nn.functional.pad(torch.log(torch.clamp(w, min=1e-30)),
                                   (0, length - n), value=_NEG_INF)
    return pts.contiguous(), logw, torch.nn.functional.pad(w, (0, length - n))


def sinkhorn_divergence(x: torch.Tensor, y: torch.Tensor,
                        w_x: Optional[torch.Tensor] = None,
                        w_y: Optional[torch.Tensor] = None,
                        blur: float = 0.05, scaling: float = 0.5,
                        debias: bool = True, extra_iters: int = 5,
                        diameter: float = 2.0) -> torch.Tensor:
    """Debiased Sinkhorn divergences of P pairs of clouds, x (P, N, D),
    y (P, M, D), optional weights (P, N) / (P, M) -> (P,):
    S = OT(a, b) - OT(a, a)/2 - OT(b, b)/2, clipped at 0."""
    n_prob, n, m = x.shape[0], x.shape[1], y.shape[1]
    a = (torch.full((n_prob, n), 1.0 / n, device=x.device) if w_x is None
         else w_x / torch.sum(w_x, dim=-1, keepdim=True))
    b = (torch.full((n_prob, m), 1.0 / m, device=y.device) if w_y is None
         else w_y / torch.sum(w_y, dim=-1, keepdim=True))
    length = max(n, m)
    xn, log_a, ap = _pad_cloud(x, a, length)
    yn, log_b, bp = _pad_cloud(y, b, length)
    eps_list = _eps_schedule(diameter, blur, scaling, extra_iters)
    if not debias:
        return _ot_dual(xn, yn, log_a, log_b, ap, bp, eps_list)
    # xy, xx and yy problems share every launch
    ot = _ot_dual(torch.cat([xn, xn, yn]), torch.cat([yn, xn, yn]),
                  torch.cat([log_a, log_a, log_b]),
                  torch.cat([log_b, log_a, log_b]),
                  torch.cat([ap, ap, bp]), torch.cat([bp, ap, bp]), eps_list)
    ot_xy, ot_xx, ot_yy = ot.reshape(3, n_prob)
    return torch.clamp(ot_xy - 0.5 * ot_xx - 0.5 * ot_yy, min=0.0)


def pairwise_domain_ot(features: torch.Tensor, blur: float = 0.05,
                       scaling: float = 0.5, debias: bool = True,
                       extra_iters: int = 5,
                       diameter: float = 2.0) -> torch.Tensor:
    """Sum of Sinkhorn divergences over all unordered domain pairs.
    features (..., D, B, F) -> (...,): every pair of every leading index is
    one problem of the same launches."""
    lead, d = features.shape[:-3], features.shape[-3]
    pi, pj = torch.triu_indices(d, d, offset=1)
    flat = features.reshape(-1, *features.shape[-3:])
    xs = flat[:, pi].reshape(-1, *features.shape[-2:])
    ys = flat[:, pj].reshape(-1, *features.shape[-2:])
    div = sinkhorn_divergence(xs, ys, blur=blur, scaling=scaling,
                              debias=debias, extra_iters=extra_iters,
                              diameter=diameter)
    return torch.sum(div.reshape(*lead, pi.shape[0]), dim=-1)
