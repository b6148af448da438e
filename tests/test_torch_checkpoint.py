"""rs_pbrt_tpu_torch's render checkpoints (render.save_checkpoint,
load_checkpoint, render(checkpoint_path=, checkpoint_every=)) against the
JAX package's, on the Cornell box at 8x8, 4 spp, depth 3.

- The .npz keys are the JAX package's (rgb, weight, splat, next_sample).
- A JAX checkpoint of the first 2 samples resumes in the port, and a port
  checkpoint of them resumes in JAX; each resumed image within 2e-3 of the
  other package's uninterrupted render.
- The port's own resume equals its uninterrupted render bit for bit where
  both take the same batches (max_lanes one sample a pixel), and a render
  that writes a checkpoint every sample leaves the state of its last one.
"""

import numpy as np
import pytest
import torch

from _gradscene import CK, jax_jobs
from rs_pbrt_tpu_torch.models import samplers as smpl
from rs_pbrt_tpu_torch.models.integrators import render as rdr
from rs_pbrt_tpu_torch.scene import presets

torch.set_num_threads(2)

TOL = 2e-3  # the port's images against the JAX package's (the film's summation order)
KEYS = {"rgb", "weight", "splat", "next_sample"}


def setup(spp=CK["spp"]):
    scene, camera = presets.cornell_box((CK["res"], CK["res"]), device="cpu")
    cfg = rdr.RenderCfg("path", spp, CK["depth"], 1.0)
    return scene, camera, cfg, smpl.make_sampler(smpl.SOBOL, CK["spp"], camera.resolution)


@pytest.fixture(scope="module")
def ck_files(tmp_path_factory):
    """The port's checkpoint of the first half of the samples, written
    before the JAX subprocess starts, and the JAX jobs' results."""
    tmp = tmp_path_factory.mktemp("ck")
    scene, camera, cfg, scfg = setup(CK["spp"] // 2)
    port_ck = str(tmp / "port.npz")
    rdr.render(scene, camera, cfg, scfg, checkpoint_path=port_ck, checkpoint_every=1)
    jax_ck = str(tmp / "jax.npz")
    jax = jax_jobs(tmp, {"ck": ("checkpoint", dict(CK, port_ck=port_ck, jax_ck=jax_ck))})
    res = jax.results("ck")
    jax.close()
    return dict(port_ck=port_ck, jax_ck=jax_ck, **res)


def test_checkpoint_keys_and_state(tmp_path):
    scene, camera, cfg, scfg = setup()
    path = str(tmp_path / "every.npz")
    n_pix = CK["res"] ** 2
    rdr.render(scene, camera, cfg, scfg, max_lanes=n_pix, checkpoint_path=path, checkpoint_every=1)
    z = np.load(path)
    assert set(z.files) == KEYS and int(z["next_sample"]) == CK["spp"]
    film, nxt = rdr.load_checkpoint(path, "cpu")
    assert nxt == CK["spp"] and float(film.weight.min()) == CK["spp"]
    assert rdr.load_checkpoint(str(tmp_path / "none.npz"), "cpu") is None


def test_port_resume_is_bit_equal(tmp_path):
    """Half the samples, checkpointed, then resumed to all of them: the
    same bits as the uninterrupted render over the same batches."""
    scene, camera, cfg, scfg = setup()
    n_pix = CK["res"] ** 2
    path = str(tmp_path / "half.npz")
    rdr.render(scene, camera, cfg._replace(spp=CK["spp"] // 2), scfg, max_lanes=n_pix,
               checkpoint_path=path, checkpoint_every=1)
    resumed = rdr.render(scene, camera, cfg, scfg, max_lanes=n_pix, checkpoint_path=path,
                         checkpoint_every=CK["spp"])
    direct = rdr.render(scene, camera, cfg, scfg, max_lanes=n_pix)
    assert torch.equal(resumed, direct)


def test_jax_checkpoint_resumes_in_port(ck_files, tmp_path):
    z = np.load(ck_files["jax_ck"])
    assert set(z.files) == KEYS and int(z["next_sample"]) == CK["spp"] // 2
    path = str(tmp_path / "from_jax.npz")
    np.savez(path, **{k: z[k] for k in z.files})
    scene, camera, cfg, scfg = setup()
    img = rdr.render(scene, camera, cfg, scfg, checkpoint_path=path, checkpoint_every=CK["spp"])
    np.testing.assert_allclose(img.numpy(), ck_files["ck:img"], rtol=TOL, atol=TOL)


def test_port_checkpoint_resumes_in_jax(ck_files):
    z = np.load(ck_files["port_ck"])
    assert set(z.files) == KEYS
    scene, camera, cfg, scfg = setup()
    direct = rdr.render(scene, camera, cfg, scfg)
    np.testing.assert_allclose(ck_files["ck:resumed"], direct.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ck_files["ck:resumed"], ck_files["ck:img"], rtol=TOL, atol=TOL)
