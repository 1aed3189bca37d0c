"""The port's pretrained-model zoo (`models/zoo.py`) against the JAX
package's, offline: the test writes a reference-layout zip of the golden
weights (tests/golden_common.py, `checkpoints.export_reference_pth`),
patches the md5 table for it, and makes `urllib.request.urlretrieve`
fail the test if anything tries to fetch (the wrong-md5 case swaps in a
fetch that writes bytes locally). The disparities: `load_pretrained`'s
equal to `load_reference_pth`'s on the same folder, and to JAX's
`load_pretrained` on the same zip within tests/test_torch_models.py's
RTOL / ATOL (the encoder's deep features round differently)."""

import os
import urllib.request
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_common
from depthmodelhardening_tpu.models import zoo as j_zoo
from depthmodelhardening_tpu.models.wrappers import (
    predictor_from as j_predictor_from,
)
from depthmodelhardening_tpu_torch.data.synthetic import make_scene
from depthmodelhardening_tpu_torch.models import zoo
from depthmodelhardening_tpu_torch.models.convert import (
    load_reference_state_dict,
)
from depthmodelhardening_tpu_torch.models.wrappers import (
    make_monodepth2, predictor_from,
)
from depthmodelhardening_tpu_torch.training import checkpoints
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

NAME = "mono+stereo_640x192"
H, W = 64, 192
RTOL, ATOL = 5e-4, 2e-4


def _fetch_fails(url, path):
    raise AssertionError(f"tried to fetch {url}")


@pytest.fixture
def offline(monkeypatch):
    monkeypatch.setattr(urllib.request, "urlretrieve", _fetch_fails)


@pytest.fixture(scope="module")
def release_zip(tmp_path_factory):
    """(the zip's path, its md5, the golden state dict)."""
    d = tmp_path_factory.mktemp("zoo_src")
    sd = load_reference_state_dict(
        golden_common.resnet18_encoder_state_dict(seed=0),
        golden_common.depth_decoder_state_dict(seed=0))
    folder = checkpoints.export_reference_pth(str(d), 0, sd, height=192,
                                              width=640)
    path = str(d / f"{NAME}.zip")
    with zipfile.ZipFile(path, "w") as z:
        for name in ("encoder.pth", "depth.pth"):
            z.write(os.path.join(folder, name), name)
    return path, zoo._md5(path), sd


def _models_dir(tmp_path, release_zip, monkeypatch):
    """A models dir holding the zip, with both packages' md5 tables
    naming it."""
    path, md5, _ = release_zip
    for table in (zoo.DOWNLOAD_PATHS, j_zoo.DOWNLOAD_PATHS):
        monkeypatch.setitem(table, NAME, (table[NAME][0], md5))
    models = tmp_path / "models"
    models.mkdir()
    with open(path, "rb") as src, open(models / f"{NAME}.zip", "wb") as dst:
        dst.write(src.read())
    return str(models)


def test_download_paths_equal_jax():
    assert zoo.DOWNLOAD_PATHS == j_zoo.DOWNLOAD_PATHS
    assert len(zoo.DOWNLOAD_PATHS) == 9


def test_a_present_folder_is_returned_without_a_fetch(tmp_path, offline):
    folder = tmp_path / NAME
    folder.mkdir()
    (folder / "encoder.pth").write_bytes(b"")
    assert zoo.download_model_if_doesnt_exist(NAME, str(tmp_path)) == str(
        folder)


def test_the_zip_is_unpacked(tmp_path, release_zip, monkeypatch, offline):
    models = _models_dir(tmp_path, release_zip, monkeypatch)
    folder = zoo.download_model_if_doesnt_exist(NAME, models)
    assert folder == os.path.join(models, NAME)
    assert sorted(os.listdir(folder)) == ["depth.pth", "encoder.pth"]


def test_a_wrong_md5_raises(tmp_path, release_zip, monkeypatch):
    """A zip whose md5 is wrong is fetched again; a fetch that brings the
    wrong bytes raises, as JAX's does, and leaves no folder."""
    models = _models_dir(tmp_path, release_zip, monkeypatch)
    zip_path = os.path.join(models, f"{NAME}.zip")
    with open(zip_path, "ab") as f:
        f.write(b"x")
    fetched = []

    def fetch(url, path):
        fetched.append(url)
        with open(path, "wb") as f:
            f.write(b"not the checkpoint")

    monkeypatch.setattr(urllib.request, "urlretrieve", fetch)
    with pytest.raises(RuntimeError, match="md5 mismatch"):
        zoo.download_model_if_doesnt_exist(NAME, models)
    assert fetched == [zoo.DOWNLOAD_PATHS[NAME][0]]
    assert not os.path.exists(os.path.join(models, NAME))


def test_unknown_names_raise_jaxs_key_error(tmp_path, offline):
    for fn in (zoo.download_model_if_doesnt_exist,
               j_zoo.download_model_if_doesnt_exist):
        with pytest.raises(KeyError, match="unknown model"):
            fn("mono_9999x1", str(tmp_path))


def test_load_pretrained_matches_the_folder_and_jax(tmp_path, release_zip,
                                                    monkeypatch, offline):
    models = _models_dir(tmp_path, release_zip, monkeypatch)
    model, meta = zoo.load_pretrained(NAME, models, device="cpu")
    assert not model.training and meta["height"] == 192 and \
        meta["width"] == 640 and meta["use_stereo"] is True
    x = torch.from_numpy(make_scene(2, H, W, seed=4))
    disp = predictor_from(model)(x)
    sd, _ = checkpoints.load_reference_pth(os.path.join(models, NAME))
    ref = make_monodepth2()
    ref.load_state_dict(sd)
    assert torch.equal(predictor_from(ref)(x), disp)
    j_model, j_vars, j_meta = j_zoo.load_pretrained(NAME, models)
    want = jax.jit(j_predictor_from(j_model, j_vars).__call__)(
        jnp.asarray(x.numpy()))
    np.testing.assert_allclose(disp.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert int(j_meta["height"]) == meta["height"]
