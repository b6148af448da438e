"""rs_pbrt_tpu_torch's other BxDFs (ops/bsdf.py: plastic, metal,
substrate, uber, translucent, Disney, mix and Fourier), against the JAX
package on the same inputs.

For each material set (one material type with matte, which needs 2, 4 or 6
lobe slots, and all of them together) both builders take the same calls
with parameters drawn from one seed; then per lane, on 2,048 seeded
directions: make_bsdf_from_mat's slots, kinds and parameters, bsdf_f,
bsdf_pdf and bsdf_sample.  Tolerances: kinds and the sample's flags equal;
parameters rtol 1e-5; f, pdf and the sample rtol 2e-3, atol 1e-5 (the same
formulas; float association and XLA's fused multiply-adds differ in ulps,
which the microfacet lobes' peaks amplify).  The Beckmann distribution on
its own as tests/test_bsdf_trans.py holds the JAX one, and per lane against
it at rtol 1e-4.  White furnaces in the pattern of
tests/test_furnace_bxdf.py, test_disney.py, test_mix_material.py and
test_bsdf_trans.py: the albedo estimated by the port's sampling stays below
1 (plus its Monte Carlo noise) and above each family's floor.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_pbrt_tpu.ops import bsdf as jbx
from rs_pbrt_tpu.scene.builder import SceneBuilder as JaxBuilder
from rs_pbrt_tpu_torch.ops import bsdf as bx
from rs_pbrt_tpu_torch.ops import fourier_bsdf as fb
from rs_pbrt_tpu_torch.scene import arrays as sa
from rs_pbrt_tpu_torch.scene.builder import SceneBuilder
from rs_pbrt_tpu_torch.tools import material_scenes as ms

torch.set_num_threads(2)

N = 2048
SETS = ("plastic", "metal", "substrate", "fourier", "translucent", "uber", "disney", "mix",
        "all")
SLOTS = dict(plastic=2, metal=2, substrate=2, fourier=2, translucent=4, uber=6, disney=6, mix=6,
             all=6)
FOURIER_TABLE = fb.make_fourier_table(ms.glossy_fourier_table(n_mu=10))


def _add(b, name, rng):
    """Three materials of set `name` on builder b, parameters from rng."""
    u = lambda lo=0.05, hi=0.95, n=3: tuple(float(x) for x in rng.uniform(lo, hi, n))
    r = lambda lo=0.02, hi=0.6: float(rng.uniform(lo, hi))
    out = []
    for i in range(3):
        if name == "plastic":
            out.append(b.add_plastic(kd=u(), ks=u(), roughness=r(), remap=bool(i % 2)))
        elif name == "metal":
            out.append(b.add_metal(roughness=r(), remap=bool(i % 2)) if i == 0 else
                       b.add_metal(eta3=u(0.2, 2.0), k3=u(1.0, 4.0), roughness=r()))
        elif name == "substrate":
            out.append(b.add_substrate(kd=u(), ks=u(0.02, 0.3), roughness=r(), remap=bool(i % 2)))
        elif name == "fourier":
            out.append(b.add_fourier(table=FOURIER_TABLE))
        elif name == "translucent":
            out.append(b.add_translucent(kd=u(), reflect=u(), transmit=u()) if i else
                       b.add_translucent(kd=u(), reflect=(0.0,) * 3, transmit=u()))
        elif name == "uber":
            out.append(b.add_uber(kd=u(), ks=u(), kr=u() if i != 1 else (0, 0, 0),
                                  kt=u() if i != 2 else (0, 0, 0), roughness=r(),
                                  eta=r(1.2, 1.8), opacity=u(0.3, 1.0) if i else (1, 1, 1)))
        elif name == "disney":
            out.append(b.add_disney(
                color=u(), metallic=r(0, 1), roughness=r(0.05, 0.9), sheen=r(0, 1) * (i != 1),
                clearcoat=r(0, 1) * (i != 2), eta=r(1.2, 1.8), spec_tint=r(0, 1),
                anisotropic=r(0, 0.9), spec_trans=r(0, 1) * (i == 1), clearcoat_gloss=r(0, 1),
                sheen_tint=r(0, 1), thin=i == 2, flatness=r(0, 1), diff_trans=r(0, 1)))
        elif name == "mix":
            a = b.add_plastic(kd=u(), ks=u(), roughness=r())
            c = [lambda: b.add_metal(roughness=r()), lambda: b.add_matte(kd=u(), sigma=20.0),
                 lambda: b.add_glass(roughness=r())][i]()
            out.append(b.add_mix(a, c, amount=u()))
    return out


def scenes(name):
    """(port scene, JAX scene, the set's material ids) of set `name`."""
    made = []
    for cls in (SceneBuilder, JaxBuilder):
        rng = np.random.default_rng(SETS.index(name))
        b = cls()
        b.add_matte(kd=(0.3, 0.6, 0.2), sigma=25.0)
        names = SETS[:-1] if name == "all" else (name,)
        mats = [m for n in names for m in _add(b, n, rng)]
        b.add_triangle_mesh([[0, 1, 2]], [[0, 0, 0], [1, 0, 0], [0, 1, 0]])
        made.append((b.finalize("cpu") if cls is SceneBuilder else b.finalize(), mats))
    (scene, mats), (jscene, _) = made
    return scene, jscene, [0, 1] + mats


def unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module", params=SETS)
def lanes(request):
    name = request.param
    scene, jscene, mats = scenes(name)
    rng = np.random.default_rng(100 + SETS.index(name))
    mat = rng.choice(mats, N).astype(np.int32)
    b = bx.make_bsdf_at(scene, SimpleNamespace(mat=torch.as_tensor(mat)))
    jb = jbx.make_bsdf_at(jscene, SimpleNamespace(mat=jnp.asarray(mat), uv=jnp.zeros((N, 2)),
                                                  p=jnp.zeros((N, 3))))
    return SimpleNamespace(name=name, b=b, jb=jb, wo=unit(rng, N), wi=unit(rng, N),
                           reflect=rng.uniform(size=N) < 0.7,
                           u2=rng.uniform(size=(N, 2)).astype(np.float32),
                           uc=rng.uniform(size=N).astype(np.float32))


def close(got, want, what, rtol=2e-3, atol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def test_make_bsdf(lanes):
    b, jb = lanes.b, lanes.jb
    slots = [k for k in ("kind2", "kind4") if getattr(b, k) is not None]
    assert 2 + 2 * len(slots) == SLOTS[lanes.name]
    for k in ("kind0", "kind1", "kind2", "kind3", "kind4", "kind5"):
        got, want = getattr(b, k), getattr(jb, k)
        assert (got is None) == (want is None), k
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=k)
    # the alphas exist where a microfacet lobe may (the port skips them
    # otherwise, as in the earlier slices)
    mf = [bx._has_lobe(b, k) for k in (bx.LOBE_MICROFACET_REFL, bx.LOBE_MICROFACET_TRANS)]
    alphas = ("ax", "ay", "ax2", "ay2") if any(mf) else ()
    for k in ("r0", "r1", "r2", "r3", "r4", "r5", "eta", "sigma", "eta2", "sigma2", "eta3",
              "k3", "kt") + alphas:
        got, want = getattr(b, k), getattr(jb, k)
        assert (got is None) == (want is None), k
        if got is not None:
            close(got, want, k, rtol=1e-5, atol=1e-7)
    # the port's lobe mask: J's, less the families the scene cannot hold
    # (a mix's hair or smooth glass), and every lane's lobes in it
    assert b.lobe_mask & ~jb.lobe_mask == 0
    present = {int(k) for i in range(6) if getattr(b, f"kind{i}") is not None
               for k in np.unique(getattr(b, f"kind{i}").numpy())} - {bx.LOBE_NONE}
    assert all(bx._has_lobe(b, k) for k in present), present
    kinds = set(np.unique(np.concatenate([getattr(b, f"kind{i}").numpy() for i in range(2)])))
    assert len(kinds) >= 3, kinds


def test_f_pdf(lanes):
    b, jb = lanes.b, lanes.jb
    t = lambda x: torch.as_tensor(x)
    f = bx.bsdf_f(b, t(lanes.wo), t(lanes.wi), t(lanes.reflect))
    jf = jbx.bsdf_f(jb, jnp.asarray(lanes.wo), jnp.asarray(lanes.wi), jnp.asarray(lanes.reflect))
    assert float(f.abs().sum()) > 0
    close(f, jf, "f")
    close(bx.bsdf_pdf(b, t(lanes.wo), t(lanes.wi)),
          jbx.bsdf_pdf(jb, jnp.asarray(lanes.wo), jnp.asarray(lanes.wi)), "pdf")


def test_sample(lanes):
    """Every lane's sample as the JAX one's, but the direction on lanes of
    the Fourier lobe: there the 20 bracketed Newton steps in phi have not
    converged on some lanes near the glossy peak, where an ulp of cos
    (torch's against XLA's) moves where they end.  Of those lanes' wi,
    99.4-99.6% agree within rtol 2e-3 and 94.9-95.1% within rtol 1e-5 (the
    "fourier" and "all" sets); the test asks 99% and 94%.  The peak's slope
    makes a small difference in wi a larger one in f, so every Fourier
    lane's f and pdf are held to the JAX bsdf_f and bsdf_pdf at the port's
    own wi, within 2e-3."""
    b, jb = lanes.b, lanes.jb
    got = bx.bsdf_sample(b, torch.as_tensor(lanes.wo), torch.as_tensor(lanes.u2),
                         torch.as_tensor(lanes.uc))
    want = jbx.bsdf_sample(jb, jnp.asarray(lanes.wo), jnp.asarray(lanes.u2),
                           jnp.asarray(lanes.uc))
    for k in ("is_specular", "is_transmission"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    fou = (b.kind0 == bx.LOBE_FOURIER).numpy()
    if b.kind2 is not None:
        fou |= (b.kind2 == bx.LOBE_FOURIER).numpy()
    wi, jwi = got.wi.numpy(), np.asarray(want.wi)
    agree = np.isclose(wi, jwi, rtol=2e-3, atol=1e-5).all(1)
    assert agree[~fou].all()
    for k in ("wi", "f", "pdf"):
        np.testing.assert_allclose(getattr(got, k).numpy()[~fou],
                                   np.asarray(getattr(want, k))[~fou], rtol=2e-3, atol=1e-5,
                                   err_msg=k)
    if fou.any():
        assert agree[fou].mean() >= 0.99
        assert np.isclose(wi[fou], jwi[fou], rtol=1e-5, atol=1e-6).all(1).mean() >= 0.94
        assert not got.is_specular.numpy()[fou].any()
        wo, own = jnp.asarray(lanes.wo), jnp.asarray(wi)
        jf = jbx.bsdf_f(jb, wo, own, jbx.same_hemisphere(wo, own))
        np.testing.assert_allclose(got.f.numpy()[fou], np.asarray(jf)[fou], rtol=2e-3,
                                   atol=1e-5, err_msg="f")
        np.testing.assert_allclose(got.pdf.numpy()[fou], np.asarray(jbx.bsdf_pdf(jb, wo, own))[fou],
                                   rtol=2e-3, atol=1e-5, err_msg="pdf")
    assert float((got.pdf > 0).float().mean()) > 0.3


def test_matte_scene_has_two_slots():
    """A scene of the earlier slices' materials keeps two slots, no
    parameter overrides and no new family's math: its lobe mask holds the
    matte lobes alone."""
    scene, _, mats = scenes("plastic")
    scene.mat_kind_mask = 1 << sa.MATTE
    b = bx.make_bsdf_at(scene, SimpleNamespace(mat=torch.zeros(8, dtype=torch.int32)))
    assert all(getattr(b, k) is None for k in ("kind2", "kind3", "kind4", "kind5", "ax2",
                                               "sigma2", "fou"))
    assert b.lobe_mask == (1 << bx.LOBE_LAMBERT) | (1 << bx.LOBE_ORENNAYAR)


def test_check_supported_refuses_textures():
    """Textured parameters no longer raise: a plastic whose kd is bound to
    a constant texture shades with the texture's value at hits (uv and p
    given), and with its constant without them (SPPM's deposit)."""
    from rs_pbrt_tpu_torch.ops import texture as tx

    b = SceneBuilder()
    m = b.add_plastic(kd=(0.1, 0.2, 0.3))
    b.set_material_texture(m, sa.TEX_SLOT_KD,
                           b.add_texture(tx.TEX_CONSTANT, {tx.TP_VALUE: (0.7, 0.6, 0.5)}))
    b.add_triangle_mesh([[0, 1, 2]], [[0, 0, 0], [1, 0, 0], [0, 1, 0]], material=m)
    scene = b.finalize("cpu")
    assert scene.tex_slot_mask == 1 << sa.TEX_SLOT_KD
    mat = torch.full((4,), m, dtype=torch.int32)
    textured = bx.make_bsdf_from_mat(scene, mat, torch.zeros(4, 2), torch.zeros(4, 3))
    assert torch.equal(textured.r0, torch.tensor([[0.7, 0.6, 0.5]]).expand(4, 3))
    assert torch.equal(bx.make_bsdf_from_mat(scene, mat).r0,
                       torch.tensor([[0.1, 0.2, 0.3]]).expand(4, 3))


def _dirs(n, seed, up=True):
    v = unit(np.random.default_rng(seed), n)
    v[:, 2] = np.abs(v[:, 2]) if up else v[:, 2]
    return torch.as_tensor(v)


def test_beckmann():
    """The Beckmann functions on their own: D integrates to 1 projected,
    E[D cos / pdf] = 1 under bk_sample_wh, Lambda grows with roughness; each
    per lane against the JAX functions."""
    n = 200_000
    rs = np.random.RandomState(11)
    u = rs.rand(n, 2)
    z = u[:, 0]
    r = np.sqrt(1 - z * z)
    phi = 2 * np.pi * u[:, 1]
    wh = np.stack([r * np.cos(phi), r * np.sin(phi), z], -1).astype(np.float32)
    for ax, ay in [(0.3, 0.3), (0.15, 0.4)]:
        a_t, a_j = torch.full((n,), ax), jnp.full(n, ax, jnp.float32)
        b_t, b_j = torch.full((n,), ay), jnp.full(n, ay, jnp.float32)
        d = bx.bk_d(torch.as_tensor(wh), a_t, b_t)
        close(d, jbx.bk_d(jnp.asarray(wh), a_j, b_j), "bk_d", rtol=1e-4, atol=1e-6)
        assert abs(float((d.double() * torch.as_tensor(z)).mean()) * 2 * np.pi - 1.0) < 0.05
        close(bx.bk_lambda(torch.as_tensor(wh), a_t, b_t),
              jbx.bk_lambda(jnp.asarray(wh), a_j, b_j), "bk_lambda", rtol=1e-4, atol=1e-6)
        close(bx.bk_g1(torch.as_tensor(wh), a_t, b_t), jbx.bk_g1(jnp.asarray(wh), a_j, b_j),
              "bk_g1", rtol=1e-4, atol=1e-6)
    wo = np.broadcast_to(np.asarray([0.4, 0.1, 0.91], np.float32), (n, 3))
    wo = (wo / np.linalg.norm(wo, axis=-1, keepdims=True)).astype(np.float32)
    u2 = rs.rand(n, 2).astype(np.float32)
    ax = torch.full((n,), 0.3)
    whs = bx.bk_sample_wh(torch.as_tensor(wo), torch.as_tensor(u2), ax, ax)
    jwhs = jbx.bk_sample_wh(jnp.asarray(wo), jnp.asarray(u2), jnp.full(n, 0.3, jnp.float32),
                            jnp.full(n, 0.3, jnp.float32))
    close(whs, jwhs, "bk_sample_wh", rtol=1e-4, atol=1e-5)
    pdf = bx.bk_pdf_wh(torch.as_tensor(wo), whs, ax, ax).numpy()
    d = bx.bk_d(whs, ax, ax).numpy()
    ok = pdf > 1e-9
    est = np.where(ok, d * np.abs(whs[:, 2].numpy()) / np.maximum(pdf, 1e-9), 0).mean()
    assert abs(est - 1.0) < 0.05, est
    w = torch.as_tensor(np.asarray([[0.98, 0.0, 0.199]], np.float32))
    w = w / w.norm()
    l1 = float(bx.bk_lambda(w, torch.tensor([0.1]), torch.tensor([0.1])))
    l2 = float(bx.bk_lambda(w, torch.tensor([0.5]), torch.tensor([0.5])))
    assert l2 >= l1 >= 0.0 and l2 > 0.0


def test_beckmann_bsdf_against_jax():
    """A plastic Bsdf with use_beckmann: f, pdf and samples per lane against
    the JAX Bsdf with the flag set (no render sets it, as in the JAX
    package)."""
    scene, jscene, _ = scenes("plastic")
    mat = torch.full((512,), 2, dtype=torch.int32)
    b = bx.make_bsdf_at(scene, SimpleNamespace(mat=mat))._replace(use_beckmann=True)
    jb = jbx.make_bsdf_at(jscene, SimpleNamespace(mat=jnp.asarray(mat.numpy()),
                                                  uv=jnp.zeros((512, 2)), p=jnp.zeros((512, 3))))
    jb = jb.replace(use_beckmann=True)
    wo, wi = _dirs(512, 21), _dirs(512, 22)
    u2 = torch.as_tensor(np.random.default_rng(3).uniform(size=(512, 2)).astype(np.float32))
    uc = torch.as_tensor(np.random.default_rng(4).uniform(size=512).astype(np.float32))
    j = lambda x: jnp.asarray(x.numpy())
    f = bx.bsdf_f(b, wo, wi, torch.ones(512, dtype=torch.bool))
    close(f, jbx.bsdf_f(jb, j(wo), j(wi), jnp.ones(512, bool)), "f", rtol=1e-4, atol=1e-6)
    tr_f = bx.bsdf_f(b._replace(use_beckmann=False), wo, wi, torch.ones(512, dtype=torch.bool))
    assert not torch.allclose(f, tr_f)
    close(bx.bsdf_pdf(b, wo, wi), jbx.bsdf_pdf(jb, j(wo), j(wi)), "pdf", rtol=1e-4, atol=1e-6)
    got, want = bx.bsdf_sample(b, wo, u2, uc), jbx.bsdf_sample(jb, j(wo), j(u2), j(uc))
    for k in ("wi", "f", "pdf"):
        close(getattr(got, k), getattr(want, k), k)


def _albedo(add, wo=(0.3, 0.1, 0.95), n=8192, seed=0):
    """rho(wo) of the material add(b) makes, by the port's BSDF sampling."""
    b = SceneBuilder()
    mat = add(b)
    b.add_sphere(radius=1.0, material=mat)
    scene = b.finalize("cpu")
    rs = np.random.RandomState(seed)
    bb = bx.make_bsdf_from_mat(scene, torch.full((n,), mat, dtype=torch.int32))
    wo = torch.as_tensor((np.asarray(wo) / np.linalg.norm(wo)).astype(np.float32)).expand(n, 3)
    s = bx.bsdf_sample(bb, wo.contiguous(), torch.as_tensor(rs.uniform(size=(n, 2)),
                                                             dtype=torch.float32),
                       torch.as_tensor(rs.uniform(size=n), dtype=torch.float32))
    w = s.f * s.wi[:, 2:3].abs() / torch.clamp(s.pdf, min=1e-12)[:, None]
    return torch.where((s.pdf > 0)[:, None], w, 0.0).mean(0).numpy()


FURNACES = {
    "plastic": (lambda b: b.add_plastic(kd=(0.5,) * 3, ks=(0.5,) * 3, roughness=0.1), 0.3),
    "metal": (lambda b: b.add_metal(eta3=(0.2,) * 3, k3=(3.9,) * 3, roughness=0.1), 0.5),
    "substrate": (lambda b: b.add_substrate(kd=(0.5,) * 3, ks=(0.2,) * 3, roughness=0.2), 0.3),
    "uber": (lambda b: b.add_uber(kd=(0.3,) * 3, ks=(0.2,) * 3, kr=(0.2,) * 3, kt=(0.2,) * 3,
                                  opacity=(0.7,) * 3), 0.3),
    "translucent": (lambda b: b.add_translucent(kd=(1.0,) * 3, reflect=(0.5,) * 3,
                                                transmit=(0.5,) * 3), 0.8),
    "disney": (lambda b: b.add_disney(color=(0.8,) * 3, roughness=0.4, sheen=0.5,
                                      clearcoat=0.5), 0.3),
    "disney_thin": (lambda b: b.add_disney(color=(0.8,) * 3, roughness=0.5, thin=True,
                                           diff_trans=0.6, flatness=0.5), 0.3),
    "mix": (lambda b: b.add_mix(b.add_matte(kd=(1.0,) * 3), b.add_mirror(kr=(1.0,) * 3)), 0.9),
    "fourier_lambertian": (lambda b: b.add_fourier(table=fb.synth_lambertian_table(0.9, 32)),
                           0.8),
}


@pytest.mark.parametrize("name", sorted(FURNACES))
def test_white_furnace(name):
    """No BxDF makes energy, and each keeps at least its floor."""
    add, floor = FURNACES[name]
    a = _albedo(add)
    assert (a < 1.05).all() and (a > floor).all(), a
