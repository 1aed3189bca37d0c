"""Pretrained model zoo: fetch, check and load the Niantic checkpoints.

Counterpart of `depthmodelhardening_tpu/models/zoo.py`
(download_model_if_doesnt_exist, monodepth2/utils.py:51-114): the nine
Monodepth2 release checkpoints (URL and md5), fetched with urllib only
when the folder and a zip with the right md5 are both missing, checked,
unzipped, and loaded through `training/checkpoints.load_reference_pth`
into a `MonodepthModel` on the card.
"""

from __future__ import annotations

import hashlib
import os
import zipfile
from typing import Optional

from ..device import resolve_device

# (google cloud URL, md5) -- monodepth2/utils.py:55-87
DOWNLOAD_PATHS = {
    "mono_640x192": (
        "https://storage.googleapis.com/niantic-lon-static/research/monodepth2/mono_640x192.zip",
        "a964b8356e08a02d009609d9e3928f7c"),
    "stereo_640x192": (
        "https://storage.googleapis.com/niantic-lon-static/research/monodepth2/stereo_640x192.zip",
        "3dfb76bcff0786e4ec07ac00f658dd07"),
    "mono+stereo_640x192": (
        "https://storage.googleapis.com/niantic-lon-static/research/monodepth2/mono%2Bstereo_640x192.zip",
        "c024d69012485ed05d7eaa9617a96b81"),
    "mono_no_pt_640x192": (
        "https://storage.googleapis.com/niantic-lon-static/research/monodepth2/mono_no_pt_640x192.zip",
        "9c2f071e35027c895a4728358ffc913a"),
    "stereo_no_pt_640x192": (
        "https://storage.googleapis.com/niantic-lon-static/research/monodepth2/stereo_no_pt_640x192.zip",
        "41ec2de112905f85541ac33a854742d1"),
    "mono+stereo_no_pt_640x192": (
        "https://storage.googleapis.com/niantic-lon-static/research/monodepth2/mono%2Bstereo_no_pt_640x192.zip",
        "46c3b824f541d143a45c37df65fbab0a"),
    "mono_1024x320": (
        "https://storage.googleapis.com/niantic-lon-static/research/monodepth2/mono_1024x320.zip",
        "0ab0766efdfeea89a0d9ea8ba90e1e63"),
    "stereo_1024x320": (
        "https://storage.googleapis.com/niantic-lon-static/research/monodepth2/stereo_1024x320.zip",
        "afc2f2126d70cf3fdf26b550898b501a"),
    "mono+stereo_1024x320": (
        "https://storage.googleapis.com/niantic-lon-static/research/monodepth2/mono%2Bstereo_1024x320.zip",
        "cdc5fc9b23513c07d5b19235d9ef08f7"),
}


def _md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download_model_if_doesnt_exist(model_name: str,
                                   models_dir: str = "models") -> str:
    """The folder <models_dir>/<model_name> holding encoder.pth and
    depth.pth: as it is when present, else unzipped from
    <models_dir>/<model_name>.zip, which is fetched first unless it is
    there with the right md5. Raises KeyError for an unknown name and
    RuntimeError when the zip's md5 is wrong."""
    if model_name not in DOWNLOAD_PATHS:
        raise KeyError(f"unknown model {model_name}; options: "
                       f"{sorted(DOWNLOAD_PATHS)}")
    url, md5 = DOWNLOAD_PATHS[model_name]
    model_path = os.path.join(models_dir, model_name)
    if os.path.exists(os.path.join(model_path, "encoder.pth")):
        return model_path

    os.makedirs(models_dir, exist_ok=True)
    zip_path = model_path + ".zip"
    if not os.path.isfile(zip_path) or _md5(zip_path) != md5:
        import urllib.request

        print(f"-> Downloading {model_name} ...")
        urllib.request.urlretrieve(url, zip_path)
    if _md5(zip_path) != md5:
        raise RuntimeError(
            f"md5 mismatch for {zip_path}; delete and retry")
    with zipfile.ZipFile(zip_path) as z:
        z.extractall(model_path)
    return model_path


def load_pretrained(model_name: str, models_dir: str = "models",
                    height: Optional[int] = None,
                    width: Optional[int] = None, device=None):
    """Fetch (if needed) and load a release checkpoint. Returns (a
    Monodepth2-18 `MonodepthModel` in eval mode on `device` (default the
    card, `device.resolve_device`, which raises without one), the
    encoder's metadata: height and width as the checkpoint stores them,
    else `height` (320) and `width` (1024))."""
    from ..models.wrappers import make_monodepth2
    from ..training.checkpoints import load_reference_pth

    dev = resolve_device(device)
    sd, meta = load_reference_pth(
        download_model_if_doesnt_exist(model_name, models_dir))
    model = make_monodepth2()
    model.load_state_dict(sd)
    meta = {"height": height or 320, "width": width or 1024, **meta}
    return model.to(dev).eval(), meta
