"""glTF parser + camera/material/geometry loader tests (procedural scenes)."""

import numpy as np
import pytest

from zig_raytracing_contest_tpu.scene import procedural
from zig_raytracing_contest_tpu.scene.camera import load_camera
from zig_raytracing_contest_tpu.scene.geometry import load_geometry
from zig_raytracing_contest_tpu.scene.gltf import GltfError, load_gltf
from zig_raytracing_contest_tpu.scene.materials import INT32_MAX, INT32_MIN, load_materials


@pytest.fixture(scope="module")
def box_gltf(tmp_path_factory):
    d = tmp_path_factory.mktemp("scenes")
    return load_gltf(procedural.cornell_like_box(d / "box.gltf"))


def make_single_quad(tmp_path, glb=False, **mesh_kwargs):
    b = procedural.SceneBuilder()
    m = b.add_material(base_color_factor=(1, 0, 0, 1))
    p, i, n, t = procedural.quad((0, 0, 0), (1, 0, 0), (0, 1, 0))
    b.add_mesh_node(p, i, m, normals=n, texcoords=t, **mesh_kwargs)
    b.add_camera_node((0, 0, 3), (0, 0, 0), yfov=0.8, name="cam")
    path = b.write_glb(tmp_path / "q.glb") if glb else b.write_gltf(tmp_path / "q.gltf")
    return load_gltf(path)


class TestParser:
    def test_gltf_external_bin(self, tmp_path):
        g = make_single_quad(tmp_path)
        geo = load_geometry(g)
        assert geo.num_triangles == 2
        # quad spans [-1,1]^2 at z=0
        np.testing.assert_allclose(geo.positions.min(), -1.0)
        np.testing.assert_allclose(geo.positions.max(), 1.0)

    def test_glb_embedded_buffer(self, tmp_path):
        g = make_single_quad(tmp_path, glb=True)
        geo = load_geometry(g)
        assert geo.num_triangles == 2

    def test_u32_indices_superset(self, tmp_path):
        g = make_single_quad(tmp_path, index_dtype=np.uint32)
        assert load_geometry(g).num_triangles == 2

    def test_strided_interleaved_accessors(self, tmp_path):
        plain = load_geometry(make_single_quad(tmp_path))
        inter = load_geometry(make_single_quad(tmp_path, interleave=True))
        np.testing.assert_array_equal(plain.positions, inter.positions)
        np.testing.assert_array_equal(plain.normals, inter.normals)

    def test_node_transform_applied(self, tmp_path):
        g = make_single_quad(tmp_path, translation=[5, 0, 0], scale=[2, 2, 2])
        geo = load_geometry(g)
        np.testing.assert_allclose(geo.positions[..., 0].min(), 3.0, atol=1e-6)
        np.testing.assert_allclose(geo.positions[..., 0].max(), 7.0, atol=1e-6)
        # normals transformed by the 3x3 then renormalized: scale cancels
        np.testing.assert_allclose(
            np.linalg.norm(geo.normals, axis=-1), 1.0, atol=1e-6
        )

    def test_rotation_trs(self, tmp_path):
        # 90° about z: +x → +y  (quaternion xyzw)
        q = [0, 0, np.sin(np.pi / 4), np.cos(np.pi / 4)]
        g = make_single_quad(tmp_path, rotation=q)
        geo = load_geometry(g)
        # quad was in xy-plane; rotation about z keeps it there, normal stays +z
        np.testing.assert_allclose(geo.normals[0, 0], [0, 0, 1], atol=1e-6)


class TestCamera:
    def test_loads_named_camera(self, box_gltf):
        cam = load_camera(box_gltf, "Camera 1", width=64, height=64)
        assert (cam.width, cam.height) == (64, 64)
        np.testing.assert_allclose(cam.origin, [0, 0, 3.4], atol=1e-6)
        # looking down -z: fwd=(0,0,-1) ⇒ right=(1,0,0), up=(0,-1,0) world-down
        np.testing.assert_allclose(cam.right, [1, 0, 0], atol=1e-6)
        np.testing.assert_allclose(cam.up, [0, -1, 0], atol=1e-6)
        # lower_left = fwd*focal - right*w/2 - up*h/2 (src/stage1.zig:359-361)
        focal = (64 / 2) / np.tan(0.7 / 2)
        np.testing.assert_allclose(
            cam.lower_left_corner, [-32, 32, -focal], atol=1e-3
        )

    def test_unknown_name_errors(self, box_gltf):
        with pytest.raises(GltfError, match="CameraNotFound"):
            load_camera(box_gltf, "nope", width=4, height=4)

    def test_no_size_errors(self, box_gltf):
        with pytest.raises(GltfError, match="OutputImgSizeIsNotSpecified"):
            load_camera(box_gltf)

    def test_one_dim_without_aspect_errors(self, box_gltf):
        with pytest.raises(GltfError, match="CameraHasntAspectRatio"):
            load_camera(box_gltf, height=64)

    def test_aspect_ratio_resolves_width(self, tmp_path):
        b = procedural.SceneBuilder()
        m = b.add_material()
        p, i, n, t = procedural.quad((0, 0, 0), (1, 0, 0), (0, 1, 0))
        b.add_mesh_node(p, i, m, normals=n)
        b.add_camera_node((0, 0, 3), (0, 0, 0), yfov=0.8, aspect_ratio=16 / 9)
        g = load_gltf(b.write_gltf(tmp_path / "a.gltf"))
        cam = load_camera(g, height=90)
        assert (cam.width, cam.height) == (160, 90)
        with pytest.raises(GltfError, match="CameraHasAspectRatio"):
            load_camera(g, width=10, height=10)


class TestMaterials:
    def test_factor_dummies(self, box_gltf):
        bank = load_materials(box_gltf)
        assert bank.num_materials == 4
        # material 1 = red wall: 1x1 dummy base color texture holding factor,
        # opacity 1.0 in the alpha channel (opaque material)
        desc = bank.color_desc[bank.mat_base[1]]
        assert tuple(desc[1:3]) == (1, 1)
        # atol = one u16 quantization step (texels are baked as
        # u16 x per-texture scale since r2; see materials._quantize_bank)
        np.testing.assert_allclose(
            bank.color_data[desc[0]], [0.65, 0.05, 0.05, 1.0], atol=1.0 / 65535
        )
        # the quantization twins reconstruct the f32 bank EXACTLY
        scale = bank.color_scale[bank.mat_base[1]]
        np.testing.assert_array_equal(
            bank.color_data[desc[0]],
            bank.color_u16[desc[0]].astype(np.float32) * scale,
        )

    def test_texture_gamma_decode_and_wrap(self, tmp_path):
        # 2x1 texture: black and 128-gray; clamp on S, repeat on T
        b = procedural.SceneBuilder()
        img = b.add_image_png(
            np.asarray([[[0, 0, 0, 255], [128, 128, 128, 255]]], np.uint8)
        )
        smp = b.add_sampler(wrap_s=33071, wrap_t=10497)
        tex = b.add_texture(img, smp)
        m = b.add_material(base_color_texture=tex)
        p, i, n, t = procedural.quad((0, 0, 0), (1, 0, 0), (0, 1, 0))
        b.add_mesh_node(p, i, m, normals=n, texcoords=t)
        b.add_camera_node((0, 0, 3), (0, 0, 0), yfov=0.8, name="c")
        g = load_gltf(b.write_gltf(tmp_path / "t.gltf"))
        bank = load_materials(g)
        desc = bank.color_desc[bank.mat_base[0]]
        offset, w, h = int(desc[0]), int(desc[1]), int(desc[2])
        assert (w, h) == (2, 1)
        # stb ldr_to_hdr: (128/255)^2.2 on RGB; opaque => alpha channel 1.0
        # (atol = one u16 quantization step of the r2 texel bake)
        np.testing.assert_allclose(
            bank.color_data[offset + 1],
            [(128 / 255) ** 2.2] * 3 + [1.0],
            atol=1.0 / 65535,
        )
        # clamp_to_edge on S: [0, w-1]; repeat on T: full int32 range
        assert (int(desc[3]), int(desc[4])) == (0, 1)
        assert (int(desc[5]), int(desc[6])) == (INT32_MIN, INT32_MAX)

    def test_mask_alpha_thresholding(self, tmp_path):
        b = procedural.SceneBuilder()
        img = b.add_image_png(
            np.asarray([[[255, 0, 0, 10], [255, 0, 0, 200]]], np.uint8)
        )
        tex = b.add_texture(img)
        m = b.add_material(
            base_color_texture=tex, alpha_mode="MASK", alpha_cutoff=0.5
        )
        p, i, n, t = procedural.quad((0, 0, 0), (1, 0, 0), (0, 1, 0))
        b.add_mesh_node(p, i, m, normals=n, texcoords=t)
        b.add_camera_node((0, 0, 3), (0, 0, 0), yfov=0.8, name="c")
        g = load_gltf(b.write_gltf(tmp_path / "m.gltf"))
        bank = load_materials(g)
        desc = bank.color_desc[bank.mat_base[0]]
        offset = int(desc[0])
        # MASK thresholding baked per-texel into the alpha channel
        np.testing.assert_array_equal(
            bank.color_data[offset : offset + 2, 3], [0.0, 1.0]
        )

    def test_blend_alpha_linear(self, tmp_path):
        b = procedural.SceneBuilder()
        img = b.add_image_png(np.asarray([[[255, 0, 0, 51]]], np.uint8))
        tex = b.add_texture(img)
        m = b.add_material(base_color_texture=tex, alpha_mode="BLEND")
        p, i, n, t = procedural.quad((0, 0, 0), (1, 0, 0), (0, 1, 0))
        b.add_mesh_node(p, i, m, normals=n, texcoords=t)
        b.add_camera_node((0, 0, 3), (0, 0, 0), yfov=0.8, name="c")
        g = load_gltf(b.write_gltf(tmp_path / "b.gltf"))
        bank = load_materials(g)
        desc = bank.color_desc[bank.mat_base[0]]
        np.testing.assert_allclose(
            bank.color_data[int(desc[0]), 3], 0.2, atol=1e-6
        )

    def test_opaque_rgb_texture_gets_dummy_alpha(self, tmp_path):
        # BLEND mode but 3-channel source image (actual_c=3): dummy 1.0
        # (src/stage1.zig:452 — requires actual_c 4 or 2).
        b = procedural.SceneBuilder()
        img = b.add_image_png(np.asarray([[[255, 0, 0]]], np.uint8))
        tex = b.add_texture(img)
        m = b.add_material(base_color_texture=tex, alpha_mode="BLEND")
        p, i, n, t = procedural.quad((0, 0, 0), (1, 0, 0), (0, 1, 0))
        b.add_mesh_node(p, i, m, normals=n, texcoords=t)
        b.add_camera_node((0, 0, 3), (0, 0, 0), yfov=0.8, name="c")
        g = load_gltf(b.write_gltf(tmp_path / "o.gltf"))
        bank = load_materials(g)
        desc = bank.color_desc[bank.mat_base[0]]
        # 3-channel source (actual_c=3): opacity constant 1.0 despite BLEND
        assert bank.color_data[int(desc[0]), 3] == 1.0


class TestNodeHierarchy:
    """Parent-chain transform composition (zgltf getGlobalTransform)."""

    def _hierarchy_scene(self, tmp_path, camera_under_parent=False):
        b = procedural.SceneBuilder()
        m = b.add_material(base_color_factor=(1, 1, 1, 1))
        p, i, n, t = procedural.quad((0, 0, 0), (1, 0, 0), (0, 1, 0))
        child = b.add_mesh_node(p, i, m, normals=n, translation=[1, 0, 0])
        cam_node = b.add_camera_node((0, 0, 5), (0, 0, 0), yfov=0.8, name="c")
        # parent both under a translated+scaled group node
        parent = {"children": [child] + ([cam_node] if camera_under_parent else []),
                  "translation": [0, 10, 0], "scale": [2, 2, 2]}
        b.nodes.append(parent)
        # keep only the parent (and maybe camera) as roots
        path = b.write_gltf(tmp_path / "h.gltf")
        return load_gltf(path)

    def test_mesh_under_transformed_parent(self, tmp_path):
        g = self._hierarchy_scene(tmp_path)
        geo = load_geometry(g)
        # parent scale 2 then child translation [1,0,0] (scaled to 2) and
        # parent translation [0,10,0]: quad spans x ∈ [0,4], y ∈ [8,12]
        np.testing.assert_allclose(geo.positions[..., 0].min(), 0.0, atol=1e-5)
        np.testing.assert_allclose(geo.positions[..., 0].max(), 4.0, atol=1e-5)
        np.testing.assert_allclose(geo.positions[..., 1].min(), 8.0, atol=1e-5)
        np.testing.assert_allclose(geo.positions[..., 1].max(), 12.0, atol=1e-5)

    def test_camera_under_transformed_parent(self, tmp_path):
        g = self._hierarchy_scene(tmp_path, camera_under_parent=True)
        cam = load_camera(g, "c", width=8, height=8)
        # camera position (0,0,5) scaled by 2 plus parent translation
        np.testing.assert_allclose(cam.origin, [0, 10, 10], atol=1e-4)


class TestMalformedPrimitives:
    def test_missing_position_is_typed_error(self, tmp_path):
        """Missing POSITION: the reference's Accessor maps a missing
        accessor to a zero-length sentinel read (src/stage1.zig:122-147)
        and then reads undefined memory for an indexed primitive; we pin
        the malformed case to a typed GltfError instead.
        """
        g = make_single_quad(tmp_path)
        del g.doc["meshes"][0]["primitives"][0]["attributes"]["POSITION"]
        with pytest.raises(GltfError, match="POSITION"):
            load_geometry(g)


class TestDebugChecks:
    def test_debug_checks_rejects_nonfinite_geometry(self, tmp_path):
        from zig_raytracing_contest_tpu.config import Config
        from zig_raytracing_contest_tpu.render.pipeline import prepare_scene

        b = procedural.SceneBuilder()
        m = b.add_material(base_color_factor=(1, 1, 1, 1))
        p, i, n, t = procedural.quad((0, 0, 0), (1, 0, 0), (0, 1, 0))
        p = np.asarray(p, np.float32).copy()
        p[0, 0] = np.nan
        b.add_mesh_node(p, i, m, normals=n, texcoords=t)
        b.add_camera_node((0, 0, 3), (0, 0, 0), yfov=0.8, name="cam")
        path = b.write_gltf(tmp_path / "nan.gltf")
        cfg = Config(debug_checks=True)
        with pytest.raises(FloatingPointError, match="positions"):
            prepare_scene(str(path), cfg, camera_name="cam", width=8, height=8)

    def test_debug_checks_clean_render_passes(self, tmp_path):
        from zig_raytracing_contest_tpu.config import Config
        from zig_raytracing_contest_tpu.render.pipeline import (
            prepare_scene, render_scene,
        )

        path = procedural.cornell_like_box(tmp_path / "box.gltf")
        cfg = Config(num_samples=1, max_bounce=2, debug_checks=True)
        scene, camera, _ = prepare_scene(
            str(path), cfg, camera_name=None, width=16, height=16
        )
        img, stats = render_scene(scene, camera, cfg)
        assert img.shape == (16, 16, 3)
        assert stats.segments > 0
