"""Neighbor search: device brute-force must agree with the host tree."""

import numpy as np

import wlsqm_tpu as wt
from wlsqm_tpu.utils import neighbors


def test_knn_backends_agree(rng):
    pts = rng.uniform(-1, 1, (500, 2))
    q = rng.uniform(-1, 1, (40, 2))
    idx_t, d2_t = neighbors.knn(pts, q, k=8, backend="device")
    idx_h, d2_h = neighbors.knn(pts, q, k=8, backend="host")
    # index sets may be permuted among equal distances; compare distances
    np.testing.assert_allclose(
        np.sort(np.asarray(d2_t), axis=1), np.sort(d2_h, axis=1), atol=1e-10)
    # and the actual nearest index agrees
    np.testing.assert_array_equal(np.asarray(idx_t)[:, 0], idx_h[:, 0])


def test_build_neighborhoods_end_to_end(rng):
    """Cloud -> neighborhoods -> fit: recovers a polynomial field."""
    def f(xy):
        x, y = xy[..., 0], xy[..., 1]
        return 1.0 + 2.0 * x + 3.0 * y + 4.0 * x * y + 5.0 * x**2 + 6.0 * y**2

    pts = rng.uniform(-1, 1, (2000, 2))
    vals = f(pts)
    centers = rng.uniform(-0.5, 0.5, (64, 2))
    xk, fk, nk = neighbors.build_neighborhoods(pts, vals, centers, k=20)
    res = wt.fit_many(xk, fk, centers, nk=nk, order=2)
    fi = np.asarray(res.fi)
    qx, qy = centers[:, 0], centers[:, 1]
    np.testing.assert_allclose(fi[:, wt.i2_F], f(centers), atol=1e-9)
    np.testing.assert_allclose(
        fi[:, wt.i2_X], 2.0 + 4.0 * qy + 10.0 * qx, atol=1e-8)


def test_radius_neighbors(rng):
    pts = rng.uniform(-1, 1, (300, 2))
    q = np.zeros((1, 2))
    lists = neighbors.radius_neighbors(pts, q, r=0.3)
    d = np.linalg.norm(pts - q, axis=1)
    expected = set(np.nonzero(d <= 0.3)[0])
    assert set(lists[0]) == expected


def test_native_kdtree_matches_scipy(rng):
    from wlsqm_tpu import native
    if not native.available():
        import pytest
        pytest.skip("no native toolchain")
    import scipy.spatial
    pts = rng.uniform(-1, 1, (3000, 3))
    q = rng.uniform(-1, 1, (100, 3))
    t = native.KDTree(pts)
    ref = scipy.spatial.cKDTree(pts)
    d, i = t.query(q, k=6)
    dr, ir = ref.query(q, k=6)
    np.testing.assert_allclose(np.sort(d, 1), np.sort(dr, 1), atol=1e-12)
    lists = t.query_ball_point(q[:20], 0.3)
    rl = ref.query_ball_point(q[:20], 0.3)
    assert all(sorted(a) == sorted(b) for a, b in zip(lists, rl))


def test_host_tree_interface(rng):
    """host_tree exposes query/query_ball_point and matches brute force."""
    from wlsqm_tpu.utils.neighbors import host_tree

    pts = rng.uniform(-1, 1, (200, 2))
    tree = host_tree(pts)
    q = rng.uniform(-1, 1, (7, 2))
    d, idx = tree.query(q, k=3)
    d2 = ((q[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    want = np.argsort(d2, axis=1)[:, :3]
    np.testing.assert_array_equal(np.sort(idx, 1), np.sort(want, 1))

    ball = tree.query_ball_point(q[0], 0.5)
    want_ball = np.nonzero(d2[0] <= 0.5 ** 2)[0]
    assert set(map(int, ball)) == set(map(int, want_ball))
