"""SO(3) machinery for the equivariant GNNs (NequIP, EquiformerV2/eSCN)
(counterpart of :mod:`repro.models.so3`).

Self-contained (no e3nn): real spherical harmonics via associated-Legendre
recurrences, Wigner-D matrices for the real basis via the J-matrix
decomposition ``D(Rz(a) Ry(b) Rz(g)) = Xz(a) J Xz(b) J Xz(g)`` (the J
constants are solved once numerically per degree), and real
Clebsch-Gordan coefficients from the complex Racah formula + the
complex->real change of basis.

Basis convention: for degree ``l`` components are ordered
``m = -l, ..., 0, ..., +l`` (e3nn order).

The numpy half (every ``*_np`` function, ``_rot_*``, ``_J_matrices``,
``tp_paths``, ``irrep_slices``) is the reference's code, copied so that
its float64 constants come out bit for bit the same.  The torch half
evaluates the same formulas on tensors, differentiably; the J and CG
constants are computed once per degree and kept as tensors per
``(device, dtype)``, made on the input's device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

L_MAX_SUPPORTED = 8


# ---------------------------------------------------------------------------
# real spherical harmonics (numpy reference + torch evaluation)
# ---------------------------------------------------------------------------

def _assoc_legendre_np(l_max, z):
    """P_l^m(z) for 0 <= m <= l <= l_max, Condon-Shortley included.
    Returns dict[(l, m)] of arrays shaped like z."""
    z = np.asarray(z, np.float64)
    s = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    P = {}
    P[(0, 0)] = np.ones_like(z)
    for m in range(1, l_max + 1):
        P[(m, m)] = -(2 * m - 1) * s * P[(m - 1, m - 1)]
    for m in range(0, l_max):
        P[(m + 1, m)] = (2 * m + 1) * z * P[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            P[(l, m)] = (((2 * l - 1) * z * P[(l - 1, m)]
                          - (l + m - 1) * P[(l - 2, m)]) / (l - m))
    return P


def real_sph_harm_np(xyz, l_max):
    """Real orthonormal SH evaluated at unit vectors. xyz (..., 3) ->
    (..., (l_max+1)^2), ordered l-major then m = -l..l."""
    xyz = np.asarray(xyz, np.float64)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    phi = np.arctan2(y, x)
    P = _assoc_legendre_np(l_max, z)
    out = np.zeros(xyz.shape[:-1] + ((l_max + 1) ** 2,), np.float64)
    for l in range(l_max + 1):
        base = l * l
        for m in range(0, l + 1):
            N = math.sqrt((2 * l + 1) / (4 * math.pi)
                          * math.factorial(l - m) / math.factorial(l + m))
            if m == 0:
                out[..., base + l] = N * P[(l, 0)]
            else:
                out[..., base + l + m] = (math.sqrt(2) * N * P[(l, m)]
                                          * np.cos(m * phi))
                out[..., base + l - m] = (math.sqrt(2) * N * P[(l, m)]
                                          * np.sin(m * phi))
    return out


def real_sph_harm(xyz, l_max):
    """Torch version of :func:`real_sph_harm_np` (same basis and order),
    in ``xyz``'s dtype.  Divisions are by tensors: CUDA turns a division
    by a Python scalar into a reciprocal multiply."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    phi = torch.atan2(y, x)
    s2 = torch.maximum(1.0 - z * z, z.new_zeros(()))
    s = torch.sqrt(s2)
    # associated Legendre via the same recurrences, unrolled
    P = {(0, 0): torch.ones_like(z)}
    for m in range(1, l_max + 1):
        P[(m, m)] = -(2 * m - 1) * s * P[(m - 1, m - 1)]
    for m in range(0, l_max):
        P[(m + 1, m)] = (2 * m + 1) * z * P[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            P[(l, m)] = (((2 * l - 1) * z * P[(l - 1, m)]
                          - (l + m - 1) * P[(l - 2, m)])
                         / z.new_full((), l - m))
    comps = []
    for l in range(l_max + 1):
        row = [None] * (2 * l + 1)
        for m in range(0, l + 1):
            N = math.sqrt((2 * l + 1) / (4 * math.pi)
                          * math.factorial(l - m) / math.factorial(l + m))
            if m == 0:
                row[l] = N * P[(l, 0)]
            else:
                row[l + m] = math.sqrt(2) * N * P[(l, m)] * torch.cos(m * phi)
                row[l - m] = math.sqrt(2) * N * P[(l, m)] * torch.sin(m * phi)
        comps.extend(row)
    return torch.stack(comps, dim=-1)


# ---------------------------------------------------------------------------
# Wigner-D for the real basis
# ---------------------------------------------------------------------------

def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _rot_y(b):
    c, s = np.cos(b), np.sin(b)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _rot_x(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def wigner_from_rotation_np(l, R):
    """Ground-truth D^l(R) for the real basis, solved by least squares over
    sample directions: Y(R p) = D Y(p). Used for the J constants and as a
    test oracle."""
    rng = np.random.default_rng(1234 + l)
    pts = rng.normal(size=(max(8 * (2 * l + 1), 64), 3))
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    Y = real_sph_harm_np(pts, l)[..., l * l:(l + 1) * (l + 1)]
    Yr = real_sph_harm_np(pts @ R.T, l)[..., l * l:(l + 1) * (l + 1)]
    D, *_ = np.linalg.lstsq(Y, Yr, rcond=None)
    return D.T


@functools.lru_cache(maxsize=None)
def _J_matrices(l):
    """Constants (D^l(Rx(-pi/2)), D^l(Rx(+pi/2))): since
    Ry(b) = Rx(-pi/2) Rz(b) Rx(+pi/2), a y-rotation block is
    Jm @ Xz(b) @ Jp with these two fixed matrices."""
    return (wigner_from_rotation_np(l, _rot_x(-np.pi / 2.0)),
            wigner_from_rotation_np(l, _rot_x(np.pi / 2.0)))


def _xz_np(l, angle):
    """Z-rotation block for real degree-l: mixes (m, -m) pairs."""
    D = np.zeros((2 * l + 1, 2 * l + 1))
    D[l, l] = 1.0
    for m in range(1, l + 1):
        c, s = np.cos(m * angle), np.sin(m * angle)
        D[l + m, l + m] = c
        D[l - m, l - m] = c
        D[l + m, l - m] = -s
        D[l - m, l + m] = s
    return D


def wigner_euler_np(l, alpha, beta, gamma):
    """D^l(Rz(alpha) Ry(beta) Rz(gamma)) via the J decomposition."""
    Jm, Jp = _J_matrices(l)
    return (_xz_np(l, alpha) @ Jm @ _xz_np(l, beta) @ Jp @ _xz_np(l, gamma))


@functools.lru_cache(maxsize=None)
def _xz_index(l):
    """For each entry of the flattened ``(2l+1, 2l+1)`` z-rotation block,
    its column in ``[0, 1, cos(m a) for m = 1..l, sin(m a) for m = 1..l,
    -sin(m a) for m = 1..l]``: a gather builds the block, so autograd
    sees copies of the cos and sin values, as ``.at[].set`` writes
    them."""
    idx = np.zeros((2 * l + 1, 2 * l + 1), np.int64)
    idx[l, l] = 1
    for m in range(1, l + 1):
        cos, sin, neg = 1 + m, 1 + l + m, 1 + 2 * l + m
        idx[l + m, l + m] = cos
        idx[l - m, l - m] = cos
        idx[l + m, l - m] = neg
        idx[l - m, l + m] = sin
    return idx.reshape(-1)


@functools.lru_cache(maxsize=None)
def _constant(key, device, dtype):
    """The numpy constant ``key`` names (``("J", l)``, ``("xz", l)`` or
    ``("cg", l1, l2, l3)``) as a tensor on ``device``, made once per
    ``(device, dtype)``; the index ``("xz", l)`` is int64."""
    kind, *ls = key
    if kind == "xz":
        return torch.as_tensor(_xz_index(*ls), device=device)
    arr = (np.stack(_J_matrices(*ls)) if kind == "J"
           else clebsch_gordan_real_np(*ls))
    return torch.tensor(arr, dtype=dtype, device=device)


def _xz(l, angle):
    """Torch z-rotation block; ``angle`` may be batched (...,).  Returns
    (..., 2l+1, 2l+1) in ``angle``'s dtype."""
    one = torch.ones_like(angle)[..., None]
    if l == 0:
        return one[..., None]
    m = torch.arange(1, l + 1, dtype=angle.dtype, device=angle.device)
    ma = m * angle[..., None]
    c, s = torch.cos(ma), torch.sin(ma)
    vals = torch.cat([torch.zeros_like(one), one, c, s, -s], dim=-1)
    idx = _constant(("xz", l), angle.device, None)
    return vals[..., idx].unflatten(-1, (2 * l + 1, 2 * l + 1))


def wigner_euler(l, alpha, beta, gamma):
    """Batched torch D^l(Rz(a) Ry(b) Rz(g)); angles broadcastable tensors
    of one dtype."""
    J = _constant(("J", l), alpha.device, alpha.dtype)
    Jm, Jp = J[0], J[1]
    Xa = _xz(l, alpha)
    Xb = _xz(l, beta)
    Xg = _xz(l, gamma)
    return Xa @ Jm @ Xb @ Jp @ Xg


def edge_alignment_angles(vec):
    """Euler angles (alpha, beta) of unit edge vectors: the rotation
    Ry(-beta) Rz(-alpha) maps the edge direction onto +z (eSCN frame)."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    alpha = torch.atan2(y, x)
    beta = torch.arccos(torch.minimum(torch.maximum(z, z.new_full((), -1.0)),
                                      z.new_full((), 1.0)))
    return alpha, beta


def wigner_align_to_z(l, alpha, beta):
    """D^l of the rotation taking direction (alpha, beta) to +z."""
    # R = Ry(-beta) @ Rz(-alpha)  ->  euler (0, -beta, -alpha)
    return wigner_euler(l, torch.zeros_like(alpha), -beta, -alpha)


# ---------------------------------------------------------------------------
# Clebsch-Gordan for the real basis
# ---------------------------------------------------------------------------

def _cg_complex_np(l1, l2, l3):
    """Complex CG <l1 m1 l2 m2 | l3 m3> via the Racah formula.
    Returns (2l1+1, 2l2+1, 2l3+1) indexed by (m1+l1, m2+l2, m3+l3)."""
    f = math.factorial
    C = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return C
    pref_l = math.sqrt(
        (2 * l3 + 1) * f(l3 + l1 - l2) * f(l3 - l1 + l2) * f(l1 + l2 - l3)
        / f(l1 + l2 + l3 + 1))
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) > l3:
                continue
            pref_m = math.sqrt(
                f(l3 + m3) * f(l3 - m3)
                * f(l1 - m1) * f(l1 + m1) * f(l2 - m2) * f(l2 + m2))
            s = 0.0
            for k in range(0, l1 + l2 - l3 + 1):
                d1 = l1 + l2 - l3 - k
                d2 = l1 - m1 - k
                d3 = l2 + m2 - k
                d4 = l3 - l2 + m1 + k
                d5 = l3 - l1 - m2 + k
                if min(d1, d2, d3, d4, d5) < 0:
                    continue
                s += ((-1.0) ** k
                      / (f(k) * f(d1) * f(d2) * f(d3) * f(d4) * f(d5)))
            C[m1 + l1, m2 + l2, m3 + l3] = pref_l * pref_m * s
    return C


def _complex_to_real_np(l):
    """Unitary U with Y_real = U @ Y_complex (complex m ordered -l..l)."""
    U = np.zeros((2 * l + 1, 2 * l + 1), np.complex128)
    U[l, l] = 1.0
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    for m in range(1, l + 1):
        cs = (-1.0) ** m  # Condon-Shortley
        # real cosine-type (index l+m) and sine-type (index l-m)
        U[l + m, l + m] = cs * inv_sqrt2
        U[l + m, l - m] = inv_sqrt2
        U[l - m, l + m] = -1j * cs * inv_sqrt2
        U[l - m, l - m] = 1j * inv_sqrt2
    return U


@functools.lru_cache(maxsize=None)
def clebsch_gordan_real_np(l1, l2, l3):
    """Real-basis CG tensor C with  (x1 (x) x2)_l3 = einsum('ijk,i,j->k').

    Transformed from the complex CG; the result is purely real or purely
    imaginary depending on (l1+l2+l3) parity — the nonzero branch is
    returned as a real array. Normalized so that
    sum over (m1, m2) of C[:, :, m3]^2 == 1 for every m3 (path-normalized).
    """
    Cc = _cg_complex_np(l1, l2, l3)
    U1 = _complex_to_real_np(l1)
    U2 = _complex_to_real_np(l2)
    U3 = _complex_to_real_np(l3)
    # complex CG indexed (m1, m2, m3): real_C = U1 U2 conj(U3) Cc
    Cr = np.einsum("ai,bj,ck,ijk->abc", U1, U2, np.conj(U3), Cc)
    real, imag = np.real(Cr), np.imag(Cr)
    C = real if np.abs(real).max() >= np.abs(imag).max() else imag
    norm = np.sqrt((C ** 2).sum())
    if norm > 0:
        C = C * math.sqrt(2 * l3 + 1) / norm
    return C


def cg_real(l1, l2, l3, *, device=None, dtype=torch.float32):
    """:func:`clebsch_gordan_real_np` as a ``dtype`` tensor on ``device``
    (the CPU unless given), made once per ``(device, dtype)``."""
    return _constant(("cg", l1, l2, l3), torch.device(device or "cpu"),
                     dtype)


def tp_paths(l_in_max, l_filter_max, l_out_max):
    """All (l1, l2, l3) tensor-product paths within the given caps."""
    paths = []
    for l1 in range(l_in_max + 1):
        for l2 in range(l_filter_max + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_out_max) + 1):
                paths.append((l1, l2, l3))
    return paths


def irrep_slices(l_max):
    """Slice per degree into a flat (l_max+1)^2 feature dim."""
    return [slice(l * l, (l + 1) * (l + 1)) for l in range(l_max + 1)]
