import numpy as np
import jax.numpy as jnp

from se3_icp.ops import eigh3


def random_sym(rng, n, scale=1.0):
    A = rng.normal(size=(n, 3, 3)) * scale
    return (A + A.transpose(0, 2, 1)) / 2


def test_eigvals_match_numpy(rng):
    A = random_sym(rng, 256)
    vals = np.asarray(eigh3.eigvalsh3(jnp.asarray(A)))
    ref = np.linalg.eigvalsh(A)
    np.testing.assert_allclose(vals, ref, atol=1e-10)


def test_eigh_reconstructs(rng):
    A = random_sym(rng, 256)
    vals, vecs = eigh3.eigh3(jnp.asarray(A))
    vals, vecs = np.asarray(vals), np.asarray(vecs)
    # columns orthonormal
    gram = np.einsum("nij,nik->njk", vecs, vecs)
    np.testing.assert_allclose(gram, np.tile(np.eye(3), (256, 1, 1)),
                               atol=1e-9)
    # A v = lambda v
    recon = np.einsum("nik,nk,njk->nij", vecs, vals, vecs)
    np.testing.assert_allclose(recon, A, atol=1e-9)
    # ascending
    assert (np.diff(vals, axis=1) >= -1e-12).all()


def test_eigh_degenerate_cases():
    mats = np.stack([
        np.eye(3),                          # triple eigenvalue
        np.diag([1.0, 1.0, 2.0]),           # low double
        np.diag([1.0, 2.0, 2.0]),           # high double
        np.diag([0.0, 0.0, 0.0]),           # zero
        np.diag([1e-12, 1.0, 1.0]),         # near-degenerate
    ])
    vals, vecs = eigh3.eigh3(jnp.asarray(mats))
    vals, vecs = np.asarray(vals), np.asarray(vecs)
    for A, lam, V in zip(mats, vals, vecs):
        np.testing.assert_allclose(np.sort(np.linalg.eigvalsh(A)), lam,
                                   atol=1e-9)
        np.testing.assert_allclose(A @ V, V * lam, atol=1e-8)
        np.testing.assert_allclose(V.T @ V, np.eye(3), atol=1e-9)


def test_eigh_extreme_scales(rng):
    for scale in [1e-18, 1e-6, 1.0, 1e6, 1e18]:
        A = random_sym(rng, 64, scale)
        vals, vecs = eigh3.eigh3(jnp.asarray(A))
        recon = np.einsum("nik,nk,njk->nij", np.asarray(vecs),
                          np.asarray(vals), np.asarray(vecs))
        np.testing.assert_allclose(recon, A, atol=1e-9 * scale)


def test_eigh_float32_accuracy(rng):
    A = random_sym(rng, 512).astype(np.float32)
    vals, vecs = eigh3.eigh3(jnp.asarray(A))
    ref = np.linalg.eigvalsh(A.astype(np.float64))
    np.testing.assert_allclose(np.asarray(vals), ref, atol=2e-5)
    recon = np.einsum("nik,nk,njk->nij", np.asarray(vecs),
                      np.asarray(vals), np.asarray(vecs))
    np.testing.assert_allclose(recon, A, atol=2e-5)


def test_smallest_eigvec_planar_patch(rng):
    # near-planar neighborhoods: the normal must be recovered accurately
    n = 128
    normals = rng.normal(size=(n, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    covs = []
    for nv in normals:
        U = np.linalg.svd(np.eye(3) - np.outer(nv, nv))[0][:, :2]
        pts = (U @ rng.normal(size=(2, 200))).T
        pts += 1e-4 * rng.normal(size=(200, 1)) * nv
        covs.append(pts.T @ pts / 200)
    covs = np.stack(covs)
    v = np.asarray(eigh3.smallest_eigvec3(jnp.asarray(covs)))
    dots = np.abs(np.einsum("ni,ni->n", v, normals))
    assert dots.min() > 1.0 - 1e-5


def test_inv_sqrt_sym3(rng):
    A = random_sym(rng, 64)
    A = np.einsum("nij,nkj->nik", A, A) + 0.1 * np.eye(3)  # PD
    W = np.asarray(eigh3.inv_sqrt_sym3(jnp.asarray(A)))
    np.testing.assert_allclose(np.einsum("nij,njk,nkl->nil", W, A, W),
                               np.tile(np.eye(3), (64, 1, 1)), atol=1e-8)
    # symmetric
    np.testing.assert_allclose(W, W.transpose(0, 2, 1), atol=1e-9)
