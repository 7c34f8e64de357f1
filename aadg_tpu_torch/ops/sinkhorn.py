"""Entropic OT (debiased Sinkhorn divergence) on two CUDA kernels.

Port of ``aadg_tpu/ops/sinkhorn.py:29-133``: log-domain symmetric Sinkhorn
with epsilon annealing (geomloss defaults blur 0.05, scaling 0.5, debias)
on the cosine cost. Every function is batched over a leading problem
dimension. ``sinkhorn_divergence`` routes by shape (``divergence_route``):

- clouds of up to ``SOLVE_MAX_POINTS`` points of up to ``SOLVE_MAX_DIM``
  features on the card take ``sinkhorn_solve``: one launch of
  ``csrc/sinkhorn_solve.cu`` runs every divergence's whole epsilon
  schedule with its cost matrices in shared memory. The search step's
  rewards (M policies x 3 domain pairs) are one such launch;
- larger clouds on the card take one launch of K1 (``softmin``,
  ``csrc/softmin.cu``, which replaces
  ``aadg_tpu/ops/sinkhorn_pallas.py::_softmin_kernel``) per half-step, with
  the xy, xx and yy problems of all divergences in each launch;
- CPU tensors take the plain version, the same loop over ``softmin_plain``.

The softmin takes the Pallas kernel's form: rows are normalized once,
z_j = log w_j + g_j / eps is formed outside, and padded columns carry
-1e30.
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

# sinkhorn_solve's limits, from the dynamic shared memory of one Hopper
# block: both clouds staged whole (rows padded to a multiple of 4, + 4),
# three L x L cost matrices (rows padded to an odd stride), the
# double-buffered potentials and offsets, the weights and the task table.
# SOLVE_MAX_DIM is the widest feature taken (twice the discriminator's
# 128); SOLVE_MAX_POINTS is the largest L that fits at that width (74).
# The main path is L=8 at D=128.
SOLVE_SMEM_BYTES = 232448
SOLVE_MAX_DIM = 256
SOLVE_MAX_EPS = 256          # longest epsilon schedule the kernel takes


def solve_smem_bytes(n: int, m: int, d: int, problems: int = 3) -> int:
    """Shared memory of one sinkhorn_solve block; mirrors ``smem_floats``
    in ``csrc/sinkhorn_solve.cu``."""
    length = max(n, m)
    kl = problems * length
    return 4 * ((n + m) * ((d + 3) // 4 * 4 + 4) + kl * (length | 1)
                + 12 * kl + 4 * length + 4)


SOLVE_MAX_POINTS = max(
    n for n in range(1, 129)
    if solve_smem_bytes(n, n, SOLVE_MAX_DIM) <= SOLVE_SMEM_BYTES)


@functools.lru_cache(maxsize=None)
def _solve_fn():
    fn = _build.load("sinkhorn_solve").sinkhorn_solve_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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


def _ot_dual(softmin_fn, xn, yn, log_p, log_q, p, q, eps_list):
    """Symmetric annealed Sinkhorn over a batch of problems, each softmin
    through ``softmin_fn``; returns <p, f> + <q, g> (P,)."""
    f = torch.zeros_like(log_p)
    g = torch.zeros_like(log_q)
    for eps in eps_list:
        f_new = softmin_fn(eps, xn, yn, log_q + g / eps)
        g_new = softmin_fn(eps, yn, xn, log_p + f / eps)
        f = 0.5 * (f + f_new)
        g = 0.5 * (g + g_new)
    eps = eps_list[-1]
    f = softmin_fn(eps, xn, yn, log_q + g / eps)
    g = softmin_fn(eps, yn, xn, log_p + f / eps)
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


def sinkhorn_loop(softmin_fn, x: torch.Tensor, y: torch.Tensor,
                  eps_list: List[float], w_x: Optional[torch.Tensor] = None,
                  w_y: Optional[torch.Tensor] = None,
                  debias: bool = True) -> torch.Tensor:
    """Divergences (P,) of x (P, N, D) and y (P, M, D), one ``softmin_fn``
    call per half-step over the xy, xx and yy problems of all P at once."""
    n_prob, n, m = x.shape[0], x.shape[1], y.shape[1]
    a = (torch.full((n_prob, n), 1.0 / n, device=x.device) if w_x is None
         else w_x / torch.sum(w_x, dim=-1, keepdim=True))
    b = (torch.full((n_prob, m), 1.0 / m, device=y.device) if w_y is None
         else w_y / torch.sum(w_y, dim=-1, keepdim=True))
    length = max(n, m)
    xn, log_a, ap = _pad_cloud(x, a, length)
    yn, log_b, bp = _pad_cloud(y, b, length)
    if not debias:
        return _ot_dual(softmin_fn, xn, yn, log_a, log_b, ap, bp, eps_list)
    ot = _ot_dual(softmin_fn, torch.cat([xn, xn, yn]),
                  torch.cat([yn, xn, yn]), torch.cat([log_a, log_a, log_b]),
                  torch.cat([log_b, log_a, log_b]),
                  torch.cat([ap, ap, bp]), torch.cat([bp, ap, bp]), eps_list)
    ot_xy, ot_xx, ot_yy = ot.reshape(3, n_prob)
    return torch.clamp(ot_xy - 0.5 * ot_xx - 0.5 * ot_yy, min=0.0)


def sinkhorn_solve_plain(x: torch.Tensor, y: torch.Tensor,
                         eps_list: List[float],
                         w_x: Optional[torch.Tensor] = None,
                         w_y: Optional[torch.Tensor] = None,
                         debias: bool = True) -> torch.Tensor:
    """The plain version of ``sinkhorn_solve``: the half-step loop over
    ``softmin_plain``."""
    return sinkhorn_loop(softmin_plain, x, y, eps_list, w_x, w_y, debias)


def sinkhorn_solve(x: torch.Tensor, y: torch.Tensor, eps_list: List[float],
                   w_x: Optional[torch.Tensor] = None,
                   w_y: Optional[torch.Tensor] = None,
                   debias: bool = True) -> torch.Tensor:
    """Divergences (P,) of raw clouds x (P, N, D) and y (P, M, D) with
    optional weights (P, N) / (P, M) over the schedule ``eps_list``. On the
    card this is one launch of ``csrc/sinkhorn_solve.cu`` (one block per
    divergence); the plain version runs for CPU tensors only."""
    p, n, d = x.shape
    m = y.shape[1]
    given = [t for t in (x, y, w_x, w_y) if t is not None]
    if any(t.dtype != torch.float32 for t in given):
        raise ValueError("sinkhorn_solve takes float32 tensors")
    if (tuple(y.shape) != (p, m, d)
            or (w_x is not None and tuple(w_x.shape) != (p, n))
            or (w_y is not None and tuple(w_y.shape) != (p, m))):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, "
                         f"y {tuple(y.shape)}")
    if len({t.device for t in given}) != 1:
        raise ValueError("sinkhorn_solve inputs must be on one device")
    if not all(t.is_contiguous() for t in given):
        raise ValueError("sinkhorn_solve takes contiguous tensors")
    if min(p, n, m, d) < 1 or max(n, m) > SOLVE_MAX_POINTS or (
            d > SOLVE_MAX_DIM):
        raise ValueError(f"sinkhorn_solve takes 1..{SOLVE_MAX_POINTS} points "
                         f"of 1..{SOLVE_MAX_DIM} features, got {n}, {m}, {d}")
    if not 1 <= len(eps_list) <= SOLVE_MAX_EPS:
        raise ValueError(f"epsilon schedule of {len(eps_list)} values; "
                         f"1..{SOLVE_MAX_EPS} allowed")
    if x.device.type == "cpu":
        return sinkhorn_solve_plain(x, y, eps_list, w_x, w_y, debias)
    if x.device.type != "cuda":
        raise ValueError("sinkhorn_solve needs CPU or CUDA tensors")
    out = torch.empty((p,), dtype=torch.float32, device=x.device)
    eps = (ctypes.c_float * len(eps_list))(*eps_list)
    _build.check(_solve_fn()(
        x.data_ptr(), y.data_ptr(), 0 if w_x is None else w_x.data_ptr(),
        0 if w_y is None else w_y.data_ptr(), eps, len(eps_list),
        int(debias), out.data_ptr(), p, n, m, d,
        torch.cuda.current_stream().cuda_stream), "sinkhorn_solve")
    sinkhorn_solve.launches += 1
    return out


sinkhorn_solve.launches = 0


def divergence_route(device_type: str, n: int, m: int, d: int) -> str:
    """Which path ``sinkhorn_divergence`` takes for clouds of n and m points
    of d features: "plain" on the CPU, "solve" (one ``sinkhorn_solve``
    launch) for CUDA clouds within its limits, else "softmin" (one K1
    launch per half-step)."""
    if device_type == "cpu":
        return "plain"
    if max(n, m) <= SOLVE_MAX_POINTS and d <= SOLVE_MAX_DIM:
        return "solve"
    return "softmin"


def sinkhorn_divergence(x: torch.Tensor, y: torch.Tensor,
                        w_x: Optional[torch.Tensor] = None,
                        w_y: Optional[torch.Tensor] = None,
                        blur: float = 0.05, scaling: float = 0.5,
                        debias: bool = True, extra_iters: int = 5,
                        diameter: float = 2.0) -> torch.Tensor:
    """Debiased Sinkhorn divergences of P pairs of clouds, x (P, N, D),
    y (P, M, D), optional weights (P, N) / (P, M) -> (P,):
    S = OT(a, b) - OT(a, a)/2 - OT(b, b)/2, clipped at 0."""
    eps_list = _eps_schedule(diameter, blur, scaling, extra_iters)
    route = divergence_route(x.device.type, x.shape[1], y.shape[1],
                             x.shape[2])
    if route == "plain":
        return sinkhorn_solve_plain(x, y, eps_list, w_x, w_y, debias)
    if route == "softmin":
        return sinkhorn_loop(softmin, x, y, eps_list, w_x, w_y, debias)
    prep = lambda t: None if t is None else t.float().contiguous()
    return sinkhorn_solve(prep(x), prep(y), eps_list, prep(w_x), prep(w_y),
                          debias)


def pairwise_domain_ot(features: torch.Tensor, blur: float = 0.05,
                       scaling: float = 0.5, debias: bool = True,
                       extra_iters: int = 5,
                       diameter: float = 2.0) -> torch.Tensor:
    """Sum of Sinkhorn divergences over all unordered domain pairs.
    features (..., D, B, F) -> (...,): every pair of every leading index is
    one problem of one ``sinkhorn_divergence`` call. The pair indices are
    made on the features' device, so the call never waits for the host."""
    lead, d = features.shape[:-3], features.shape[-3]
    pairs = torch.triu_indices(d, d, offset=1, device=features.device)
    # one gather: (2, pairs, leading, B, F), x side then y side
    sel = features.reshape(-1, *features.shape[-3:]).transpose(0, 1)[pairs]
    xs = sel[0].reshape(-1, *features.shape[-2:])
    ys = sel[1].reshape(-1, *features.shape[-2:])
    div = sinkhorn_divergence(xs, ys, blur=blur, scaling=scaling,
                              debias=debias, extra_iters=extra_iters,
                              diameter=diameter)
    return torch.sum(div.reshape(pairs.shape[1], *lead), dim=0)
