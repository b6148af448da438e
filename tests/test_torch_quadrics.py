"""rs_pbrt_tpu_torch's cylinders, disks and their area lights against the
JAX package's on the same inputs: the object-space tests
(ops/intersect.py), scene intersection of a scene of triangles, a sphere,
a clipped cylinder and an annulus (ops/scene_intersect.py), the builder's
tables, and light sampling, its pdf and photon emission on disk and
cylinder lights (models/lights.py); and the disk light's closed-form
irradiance on the port alone (tests/test_quadric_lights.py:37-50's oracle).

Tolerances (in-process JAX, whose XLA contracts FMAs): the object-space
tests valid equal, t rtol 1e-5; scene intersection ids equal, t rtol 1e-5,
p, p_error, ng, ns, uv, dpdu within 1e-4 (test_torch_intersect.py's);
the tables allclose 1e-6 (test_torch_scene.py's); sample_li, pdf_li_area
and sample_le rtol 1e-4 with atol 1e-5 (a transformed normal and a pdf
divide by a distance squared, each off by ulps); the irradiance within 3%
of the closed form (the JAX test's bound, 4,096 samples).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_pbrt_tpu.models import lights as jlt
from rs_pbrt_tpu.ops import intersect as jisect
from rs_pbrt_tpu.ops import scene_intersect as jsi
from rs_pbrt_tpu.scene.builder import SceneBuilder as JaxBuilder
from rs_pbrt_tpu.utils import transform as jtr
from rs_pbrt_tpu_torch.models import lights as lt
from rs_pbrt_tpu_torch.ops import intersect as isect
from rs_pbrt_tpu_torch.ops import scene_intersect as si
from rs_pbrt_tpu_torch.scene import arrays as sa
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
from rs_pbrt_tpu_torch.utils import transform as tr
from test_torch_scene import TABLES, assert_tables_equal, bridge

torch.set_num_threads(2)

# object +z along world +y
Z_UP = np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0], [0, 0, 0, 1]], np.float32)


def _rays(n, seed, lo=-2.0, hi=2.0):
    """Origins in [lo, hi]^3, half the rays aimed at a point of the unit
    cube about the origin, the rest in random directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[::2] = rng.uniform(-1.0, 1.0, (n // 2, 3)) - o[::2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rng.uniform(size=n) < 0.2, 1.5, 1e30).astype(np.float32)
    return o, d, t_max


@pytest.mark.parametrize("shape", ["cylinder", "disk", "annulus"])
def test_object_space_tests_match_jax(shape):
    """Rays from a box around the shape: the cylinder of radius 0.7, z in
    [-0.5, 0.8], phi_max 4; the disk of radius 0.9 at height 0.3, phi_max
    5; the annulus of radii 0.3 and 0.9 over the whole circle."""
    o, d, t_max = _rays(4096, seed=3)
    if shape == "cylinder":
        args, fn, jfn = (0.7, -0.5, 0.8, 4.0), isect.intersect_cylinder, jisect.intersect_cylinder
    else:
        inner, phi_max = (0.0, 5.0) if shape == "disk" else (0.3, 2 * np.pi)
        args, fn, jfn = (0.3, 0.9, inner, phi_max), isect.intersect_disk, jisect.intersect_disk
    got = fn(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max),
             *(torch.tensor(a, dtype=torch.float32) for a in args))
    want = jfn(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
               *(jnp.float32(a) for a in args))
    v = np.asarray(want.valid)
    assert 0.05 < v.mean() < 0.95
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5)
    np.testing.assert_allclose(got.p_obj.numpy()[v], np.asarray(want.p_obj)[v], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.phi.numpy()[v], np.asarray(want.phi)[v], rtol=1e-5, atol=1e-6)


def build_quadrics(builder_cls, lights: bool):
    """A matte floor of two triangles, a sphere, an upright cylinder clipped
    to 270 degrees, an annulus facing down and a small disk turned by a
    mirror transform; with lights, the annulus and a two-sided cylinder
    emit.  Both builders take the same calls."""
    xf = jtr if builder_cls is JaxBuilder else tr
    b = builder_cls()
    m = b.add_matte(kd=(0.5, 0.4, 0.3))
    b.add_triangle_mesh([[0, 1, 2], [0, 2, 3]],
                        np.asarray([[-4, 0, -4], [4, 0, -4], [4, 0, 4], [-4, 0, 4]], np.float32),
                        material=m)
    b.add_sphere(xf.translate([1.2, 0.5, 0.0]), radius=0.5, material=m)
    b.add_cylinder(xf.compose(xf.translate([-1.0, 0.0, 0.3]), xf.from_matrix(Z_UP)), radius=0.4,
                   z_min=0.0, z_max=1.5, phi_max=270.0, material=m)
    light = dict(L=(6.0, 5.0, 4.0)) if lights else None
    b.add_disk(xf.compose(xf.translate([0.0, 2.5, 0.0]), xf.from_matrix(Z_UP)), radius=0.8,
               inner_radius=0.25, material=m, area_light=light, reverse_orientation=True)
    mirror = np.diag([1.0, 1.0, -1.0, 1.0]).astype(np.float32)
    b.add_disk(xf.compose(xf.translate([0.3, 1.0, -1.5]), xf.from_matrix(mirror)), height=0.2,
               radius=0.3, phi_max=300.0, material=m)
    b.add_cylinder(xf.translate([0.0, 1.8, 1.0]), radius=0.1, z_min=-0.3, z_max=0.3,
                   material=m, area_light=dict(L=(2.0, 3.0, 4.0), two_sided=True) if lights
                   else None)
    return b


@pytest.mark.parametrize("lights", [False, True])
def test_builder_tables_equal_jax(lights):
    scene = build_quadrics(SceneBuilder, lights).finalize("cpu")
    jscene = build_quadrics(JaxBuilder, lights).finalize()
    assert_tables_equal(scene, jscene)
    np.testing.assert_allclose(scene.sph_attr.numpy(), np.asarray(jscene.sph_attr), rtol=1e-6,
                               atol=1e-6)
    assert scene.quad_kind_mask == jscene.quad_kind_mask == 7
    assert scene.has_quadric_lights == jscene.has_quadric_lights == lights
    bridged = bridge(jscene)
    for k in TABLES + ("sph_attr",):
        assert torch.equal(getattr(bridged, k), torch.tensor(np.asarray(getattr(jscene, k)))), k
    assert (bridged.quad_kind_mask, bridged.has_quadric_lights) == (7, lights)


@pytest.mark.parametrize("seed", [5, 6])
def test_scene_intersect_matches_jax(seed):
    """Closest hit and shadow query on rays from above the floor."""
    jscene = build_quadrics(JaxBuilder, True).finalize()
    scene = bridge(jscene)
    o, d, t_max = _rays(4096, seed, lo=-2.5, hi=2.5)
    o[:, 1] = np.abs(o[:, 1]) + 0.05
    args = (torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max))
    it = si.scene_intersect(scene, *args)
    jit = jsi.scene_intersect(jscene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    v = np.asarray(jit.valid)
    prim = np.asarray(jit.prim)
    kinds = np.round(np.asarray(jscene.sph_attr)[:, sa.SP_KIND]).astype(int)
    hit_kinds = set(kinds[prim[v & (prim >= 2)] - 2])
    assert hit_kinds == {sa.QK_SPHERE, sa.QK_CYLINDER, sa.QK_DISK}
    for k in ("valid", "mat", "light", "prim"):
        np.testing.assert_array_equal(getattr(it, k).numpy(), np.asarray(getattr(jit, k)), k)
    np.testing.assert_allclose(it.t.numpy(), np.asarray(jit.t), rtol=1e-5)
    for k in ("p", "p_error", "ng", "ns", "uv", "wo", "dpdu"):
        np.testing.assert_allclose(getattr(it, k).numpy()[v], np.asarray(getattr(jit, k))[v],
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    occ = si.scene_intersect_p(scene, *args).numpy()
    jocc = np.asarray(jsi.scene_intersect_p(jscene, jnp.asarray(o), jnp.asarray(d),
                                            jnp.asarray(t_max)))
    np.testing.assert_array_equal(occ, jocc)


def _light_inputs(n, seed):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    ref[:, 1] = rng.uniform(0.1, 1.5, n)
    return ref, rng.random((n, 2), np.float32), rng.random((n, 2), np.float32)


def test_quadric_lights_match_jax():
    """sample_li, pdf_li_area at the sampled point and sample_le on the
    annulus (light 0) and the two-sided cylinder (light 1)."""
    jscene = build_quadrics(JaxBuilder, True).finalize()
    scene = bridge(jscene)
    n = 2048
    ref, u2, u3 = _light_inputs(n, seed=9)
    idx = np.arange(n, dtype=np.int32) % 2
    ls = lt.sample_li(scene, torch.as_tensor(idx), torch.as_tensor(ref), torch.as_tensor(u2))
    jls = jlt.sample_li(jscene, jnp.asarray(idx), jnp.asarray(ref), jnp.asarray(u2))
    assert (np.asarray(jls.pdf) > 0).mean() > 0.3
    close = dict(rtol=1e-4, atol=1e-5)
    for k in ("wi", "li", "pdf", "p_target", "n_light"):
        np.testing.assert_allclose(getattr(ls, k).numpy(), np.asarray(getattr(jls, k)), **close,
                                   err_msg=k)
    assert not ls.is_delta.any()
    pdf = lt.pdf_li_area(scene, torch.as_tensor(idx), torch.as_tensor(ref), ls.p_target,
                         ls.n_light)
    jpdf = jlt.pdf_li_area(jscene, jnp.asarray(idx), jnp.asarray(ref), jls.p_target, jls.n_light)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), **close)
    le = lt.sample_le(scene, torch.as_tensor(idx), torch.as_tensor(u2), torch.as_tensor(u3))
    jle = jlt.sample_le(jscene, jnp.asarray(idx), jnp.asarray(u2), jnp.asarray(u3))
    for k in ("o", "d", "n_light", "le", "pdf_pos", "pdf_dir"):
        np.testing.assert_allclose(getattr(le, k).numpy(), np.asarray(getattr(jle, k)), **close,
                                   err_msg=k)


def test_disk_light_closed_form_irradiance():
    """A point at distance h below a Lambertian disk of radius R facing it:
    E = pi L R^2 / (R^2 + h^2)."""
    R, h, L, n = 0.5, 1.0, 4.0, 4096
    b = SceneBuilder()
    b.add_disk(height=h, radius=R, area_light={"L": (L, L, L)}, reverse_orientation=True)
    scene = b.finalize("cpu")
    u2 = torch.as_tensor(np.random.default_rng(0).random((n, 2), np.float32))
    ls = lt.sample_li(scene, torch.zeros(n, dtype=torch.int32), torch.zeros((n, 3)), u2)
    w = torch.where(ls.pdf > 0, torch.clamp(ls.wi[:, 2], min=0.0) / torch.clamp(ls.pdf, min=1e-12),
                    0.0)
    E = float((ls.li[:, 0] * w).mean())
    np.testing.assert_allclose(E, np.pi * L * R * R / (R * R + h * h), rtol=0.03)


def test_scene_aabb_bounds_quadrics_as_jax():
    """The spatial light distribution's box takes each quadric's radius,
    scaled, about its centre, for cylinders and disks as for spheres (the
    JAX package's lightdistrib.scene_aabb)."""
    from rs_pbrt_tpu.models import lightdistrib as jld
    from rs_pbrt_tpu_torch.models import lightdistrib as ld

    jscene = build_quadrics(JaxBuilder, True).finalize()
    for scene in (bridge(jscene), build_quadrics(SceneBuilder, True).finalize("cpu")):
        for got, want in zip(ld.scene_aabb(scene), jld.scene_aabb(jscene)):
            np.testing.assert_array_equal(got, want)
