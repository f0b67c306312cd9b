"""Ports of the reference's math unit tests, plus batched-shape checks.

Each test cites the reference test it mirrors (src/linalg.zig).  These are
the conformance spec for the batched math layer: exact values, same tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from zig_raytracing_contest_tpu.ops import linalg


def vec3(x, y, z):
    return jnp.asarray([x, y, z], dtype=jnp.float32)


class TestCrossAndLength:
    def test_cross_product(self):
        # reference: "cross product" src/linalg.zig:231-236
        a = vec3(1, -8, 12)
        b = vec3(4, 6, 3)
        np.testing.assert_array_equal(
            np.asarray(linalg.cross(a, b)), np.asarray([-96, 45, 38], np.float32)
        )

    def test_vector_length(self):
        # reference: "vector length" src/linalg.zig:238-241
        v = vec3(1.5, 100.0, -21.1)
        assert float(linalg.length(v)) == pytest.approx(102.21281720019266, abs=1e-4)

    def test_cross_batched(self):
        a = jnp.tile(vec3(1, -8, 12), (5, 1))
        b = jnp.tile(vec3(4, 6, 3), (5, 1))
        out = linalg.cross(a, b)
        assert out.shape == (5, 3)
        np.testing.assert_array_equal(
            np.asarray(out), np.tile([-96, 45, 38], (5, 1)).astype(np.float32)
        )


class TestBboxRayIntersection:
    # reference: "bbox rayIntersection 1-4" src/linalg.zig:352-405

    def _isect(self, bmin, bmax, orig, direction):
        hit, t = linalg.ray_bbox_intersection(
            vec3(*orig), vec3(*direction), vec3(*bmin), vec3(*bmax)
        )
        return bool(hit), float(t)

    def test_axis_aligned_entry(self):
        hit, t = self._isect((-1, -1, -1), (1, 1, 1), (0, 0, 5), (0, 0, -1))
        assert hit
        assert t == pytest.approx(4.0, abs=1e-4)

    def test_diagonal_entry(self):
        d = np.asarray([1, 1, 1]) / np.sqrt(3)
        hit, t = self._isect((1, 1, 1), (2, 2, 2), (0, 0, 0), tuple(d))
        assert hit
        assert t == pytest.approx(np.sqrt(3), abs=1e-4)

    def test_origin_inside_gives_negative_t(self):
        d = np.asarray([1, 1, 0]) / np.sqrt(2)
        hit, t = self._isect((-1, -1, -1), (3, 3, 3), (0, 0, 0), tuple(d))
        assert hit
        assert t == pytest.approx(-np.sqrt(2), abs=1e-4)

    def test_miss(self):
        d = np.asarray([1, 1, 0]) / np.sqrt(2)
        hit, _ = self._isect((-1, -1, -1), (3, 3, 3), (5, 5, 5), tuple(d))
        assert not hit

    def test_batched(self):
        orig = jnp.asarray([[0, 0, 5], [5, 5, 5]], jnp.float32)
        d = jnp.asarray([[0, 0, -1], [1 / np.sqrt(2), 1 / np.sqrt(2), 0]], jnp.float32)
        hit, t = linalg.ray_bbox_intersection(
            orig, d, vec3(-1, -1, -1), vec3(1, 1, 1)
        )
        assert bool(hit[0]) and not bool(hit[1])
        assert float(t[0]) == pytest.approx(4.0, abs=1e-4)


class TestMollerTrumbore:
    def _tri(self, p0, p1, p2):
        return linalg.make_mt_triangles(vec3(*p0), vec3(*p1), vec3(*p2))

    def test_front_face_hit(self):
        # CCW triangle in z=0 plane seen from +z with ray dir -z:
        # e1 x e2 points toward +z; det = dot(e1, cross(dir, e2)) > 0.
        v0, e1, e2 = self._tri((0, 0, 0), (1, 0, 0), (0, 1, 0))
        valid, t, u, v = linalg.moller_trumbore(
            vec3(0.25, 0.25, 3), vec3(0, 0, -1), v0, e1, e2
        )
        assert bool(valid)
        assert float(t) == pytest.approx(3.0, abs=1e-6)
        assert float(u) == pytest.approx(0.25, abs=1e-6)
        assert float(v) == pytest.approx(0.25, abs=1e-6)

    def test_back_face_culled(self):
        # Same triangle from -z: det < epsilon => miss (src/linalg.zig:705)
        v0, e1, e2 = self._tri((0, 0, 0), (1, 0, 0), (0, 1, 0))
        valid, _, _, _ = linalg.moller_trumbore(
            vec3(0.25, 0.25, -3), vec3(0, 0, 1), v0, e1, e2
        )
        assert not bool(valid)

    def test_outside_barycentrics(self):
        v0, e1, e2 = self._tri((0, 0, 0), (1, 0, 0), (0, 1, 0))
        valid, _, _, _ = linalg.moller_trumbore(
            vec3(0.9, 0.9, 3), vec3(0, 0, -1), v0, e1, e2
        )
        assert not bool(valid)

    def test_parallel_ray_no_nan_poison(self):
        v0, e1, e2 = self._tri((0, 0, 0), (1, 0, 0), (0, 1, 0))
        valid, _, _, _ = linalg.moller_trumbore(
            vec3(0.25, 0.25, 3), vec3(1, 0, 0), v0, e1, e2
        )
        assert not bool(valid)

    def test_negative_t_still_reports_valid(self):
        # The reference's MT returns true for hits behind the origin; the
        # t>0 filter lives in the caller (src/stage3.zig:174).
        v0, e1, e2 = self._tri((0, 0, 0), (1, 0, 0), (0, 1, 0))
        valid, t, _, _ = linalg.moller_trumbore(
            vec3(0.25, 0.25, -3), vec3(0, 0, -1), v0, e1, e2
        )
        assert bool(valid)
        assert float(t) == pytest.approx(-3.0, abs=1e-6)


class TestToRGB:
    def test_gamma_encode(self):
        # x^(1/2.2) * 256 truncated (src/linalg.zig:150-159)
        c = vec3(0.5, 1.0, 0.0)
        out = np.asarray(linalg.vec3_to_rgb(c))
        expected = np.trunc(
            np.minimum(np.asarray([0.5, 1.0, 0.0]) ** (1 / 2.2), 0.999999) * 256
        ).astype(np.uint8)
        np.testing.assert_array_equal(out, expected)

    def test_upper_clamp_only_like_reference(self):
        # >=1 radiance clamps to 255, negatives clip to 0 (safety extension).
        out = np.asarray(linalg.vec3_to_rgb(vec3(5.0, -1.0, 1.0)))
        assert out[0] == 255 and out[1] == 0 and out[2] == 255


class TestEnvColor:
    def test_sky_gradient(self):
        # src/stage3.zig:144-150
        up = np.asarray(linalg.env_color(vec3(0, 1, 0)))
        np.testing.assert_allclose(up, [0.5, 0.7, 1.0], atol=1e-6)
        down = np.asarray(linalg.env_color(vec3(0, -1, 0)))
        np.testing.assert_allclose(down, [1.0, 1.0, 1.0], atol=1e-6)
