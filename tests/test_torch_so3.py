"""The port's SO(3) machinery (:mod:`repro_torch.models.so3`) against the
reference's (:mod:`repro.models.so3`): twins of every test in
``tests/test_so3.py``, run on the torch functions, and the copied numpy
constants held equal bit for bit.

Tolerances: the numpy constants (``_J_matrices``, the real CG tensors,
``real_sph_harm_np``, ``wigner_euler_np``) equal; float32 torch values
at the reference tests' own bars (2e-4 for the harmonics against numpy,
1e-4 for Wigner blocks); against the reference's jnp functions on the
same float32 inputs at ``JNP_ATOL`` (measured here: harmonics within
3.0e-7 at l_max 6, Wigner blocks within 1.8e-7 at l = 6 on the same
angles; ``atan2`` / ``arccos`` differ by up to 2.4e-7, which moves a
block at l = 6 by up to 1.6e-6); float64 torch values at the
reference's float64 bars (1e-8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import so3 as ref_so3
from repro_torch.models import so3

JNP_ATOL = 2e-6


def unit_vectors(seed, n):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3))
    return pts / np.linalg.norm(pts, axis=-1, keepdims=True)


@pytest.mark.parametrize("l", range(7))
def test_j_matrices_bit_equal(l):
    for got, want in zip(so3._J_matrices(l), ref_so3._J_matrices(l)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("caps", [(2, 2, 2), (6, 6, 6)])
def test_clebsch_gordan_bit_equal(caps):
    paths = so3.tp_paths(*caps)
    assert paths == ref_so3.tp_paths(*caps)
    for path in paths:
        np.testing.assert_array_equal(so3.clebsch_gordan_real_np(*path),
                                      ref_so3.clebsch_gordan_real_np(*path))
    assert so3.irrep_slices(caps[0]) == ref_so3.irrep_slices(caps[0])


def test_numpy_half_equal():
    """``real_sph_harm_np`` and ``wigner_euler_np`` give the reference's
    float64 values bit for bit."""
    pts = unit_vectors(2, 64)
    np.testing.assert_array_equal(so3.real_sph_harm_np(pts, 6),
                                  ref_so3.real_sph_harm_np(pts, 6))
    for l in range(7):
        np.testing.assert_array_equal(so3.wigner_euler_np(l, 0.3, -1.2, 2.5),
                                      ref_so3.wigner_euler_np(l, 0.3, -1.2,
                                                              2.5))


def test_sph_harm_orthonormal():
    # Monte-Carlo orthonormality check of the torch SH basis up to l=4
    pts = torch.from_numpy(unit_vectors(0, 200_000))
    Y = so3.real_sph_harm(pts, 4).numpy()
    gram = (Y.T @ Y) / pts.shape[0] * (4 * np.pi)
    np.testing.assert_allclose(gram, np.eye(Y.shape[1]), atol=0.05)


@pytest.mark.parametrize("l_max", [2, 6])
def test_sph_harm_matches_np_and_reference(l_max):
    pts = unit_vectors(1, 512)
    p32 = pts.astype(np.float32)
    got = so3.real_sph_harm(torch.from_numpy(p32), l_max).numpy()
    np.testing.assert_allclose(got, so3.real_sph_harm_np(pts, l_max),
                               atol=2e-4)
    np.testing.assert_allclose(
        got, np.asarray(ref_so3.real_sph_harm(jnp.asarray(p32), l_max)),
        rtol=0, atol=JNP_ATOL)
    got64 = so3.real_sph_harm(torch.from_numpy(pts), l_max).numpy()
    np.testing.assert_allclose(got64, so3.real_sph_harm_np(pts, l_max),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("l", [1, 2, 3, 6])
def test_wigner_euler_matches_lstsq(l):
    rng = np.random.default_rng(l)
    for _ in range(3):
        a, b, g = rng.uniform(-np.pi, np.pi, 3)
        R = so3._rot_z(a) @ so3._rot_y(b) @ so3._rot_z(g)
        want = so3.wigner_from_rotation_np(l, R)
        angles = [torch.tensor(v, dtype=torch.float32) for v in (a, b, g)]
        got = so3.wigner_euler(l, *angles).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4)
        ref = np.asarray(ref_so3.wigner_euler(l, *(np.float32(v)
                                                   for v in (a, b, g))))
        np.testing.assert_allclose(got, ref, rtol=0, atol=JNP_ATOL)
        got64 = so3.wigner_euler(l, *(torch.tensor(v, dtype=torch.float64)
                                      for v in (a, b, g))).numpy()
        np.testing.assert_allclose(got64, want, atol=1e-8)


@pytest.mark.parametrize("l", [0, 1, 2, 4])
def test_wigner_align_to_z(l):
    # D(align(r)) Y(r) must equal Y(z) (the north pole)
    vec = unit_vectors(10 + l, 16)
    alpha, beta = so3.edge_alignment_angles(
        torch.from_numpy(vec.astype(np.float32)))
    D = so3.wigner_align_to_z(l, alpha, beta).numpy()
    Y = so3.real_sph_harm_np(vec, l)[:, l * l:(l + 1) ** 2]
    Yz = so3.real_sph_harm_np(np.array([[0.0, 0.0, 1.0]]), l)[
        0, l * l:(l + 1) ** 2]
    got = np.einsum("nij,nj->ni", D, Y)
    np.testing.assert_allclose(got, np.broadcast_to(Yz, got.shape), atol=1e-4)
    ra, rb = ref_so3.edge_alignment_angles(jnp.asarray(vec, jnp.float32))
    np.testing.assert_allclose(alpha.numpy(), np.asarray(ra), rtol=0,
                               atol=5e-7)
    np.testing.assert_allclose(beta.numpy(), np.asarray(rb), rtol=0,
                               atol=5e-7)
    np.testing.assert_allclose(D, np.asarray(ref_so3.wigner_align_to_z(
        l, ra, rb)), rtol=0, atol=JNP_ATOL)


@pytest.mark.parametrize("l1,l2,l3", [(1, 1, 0), (1, 1, 1), (1, 1, 2),
                                      (2, 1, 1), (2, 2, 2), (2, 2, 0)])
def test_cg_real_equivariance(l1, l2, l3):
    # C must intertwine: C (D1 x) (D2 y) = D3 (C x y), in torch float64
    C = so3.cg_real(l1, l2, l3, dtype=torch.float64)
    assert float(C.abs().max()) > 0
    torch.testing.assert_close(
        so3.cg_real(l1, l2, l3),
        torch.from_numpy(np.array(ref_so3.cg_real(l1, l2, l3))),
        rtol=0, atol=0)
    rng = np.random.default_rng(l1 * 100 + l2 * 10 + l3)
    for _ in range(3):
        angles = [torch.tensor(v, dtype=torch.float64)
                  for v in rng.uniform(-np.pi, np.pi, 3)]
        D1, D2, D3 = (so3.wigner_euler(l, *angles) for l in (l1, l2, l3))
        lhs = torch.einsum("ijk,ia,jb->abk", C, D1, D2)
        rhs = torch.einsum("ijc,ck->ijk", C, D3.T)
        torch.testing.assert_close(lhs, rhs, rtol=0, atol=1e-8)


def test_cg_l1_l1_l0_is_dot_product():
    C = so3.cg_real(1, 1, 0, dtype=torch.float64)[:, :, 0].numpy()
    # proportional to the identity (dot product up to scale)
    off = C - np.diag(np.diag(C))
    assert np.abs(off).max() < 1e-10
    d = np.diag(C)
    np.testing.assert_allclose(d, d[0] * np.ones(3), atol=1e-10)


def test_wigner_blocks_are_differentiable():
    """The z-rotation blocks are gathered from their cos / sin values, so
    autograd differentiates a Wigner block in its angles (float64
    ``gradcheck``) and the constants follow the input's dtype."""
    angles = tuple(torch.tensor(v, dtype=torch.float64, requires_grad=True)
                   for v in (0.4, -1.1, 2.0))
    for l in (0, 1, 3):
        assert torch.autograd.gradcheck(
            lambda a, b, g, l=l: so3.wigner_euler(l, a, b, g), angles)
    assert so3.cg_real(2, 2, 2, dtype=torch.float64).dtype == torch.float64
    x = torch.from_numpy(unit_vectors(4, 8)).requires_grad_()
    assert torch.autograd.gradcheck(lambda v: so3.real_sph_harm(v, 3), (x,))
