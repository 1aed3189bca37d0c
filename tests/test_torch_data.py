"""The port's data path against the JAX package's, on files the tests
write (tests/kitti_trees.py): every array bit-equal (`np.array_equal`).

* `native/`: load_image / load_resized on RGB, RGBA and grey PNGs (PIL's
  own, with its adaptive row filters, and the trees' filter-0 ones) and
  a JPEG, on each route the port has
  here (the C library, and PIL with the numpy transcription of the C
  resampler), against the JAX package's load_image / load_resized (its
  C route); the JAX package's own numpy resize is not the yardstick: it
  lies up to 1.5e-5 from its C resampler (held below).
* `data/`: kitti_raw items from the same RandomState, collate, the odom
  and depth-benchmark paths, velodyne depth maps, export_gt_depths, the
  object scenes and their batches, the car, the split files (fetch_splits
  from a file:// base_url), pseudo_lidar, the prefetch loader's order
  and items over two epochs (tensors on the device asked for);
  `physics/calibration.py`'s file side.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

import kitti_trees as kt
from depthmodelhardening_tpu import native as j_native
from depthmodelhardening_tpu.data import kitti_object as j_kitti_object
from depthmodelhardening_tpu.data import kitti_raw as j_kitti_raw
from depthmodelhardening_tpu.data import object_images as j_object_images
from depthmodelhardening_tpu.data import pseudo_lidar as j_pseudo_lidar
from depthmodelhardening_tpu.data import splits as j_splits
from depthmodelhardening_tpu.data import velodyne as j_velodyne
from depthmodelhardening_tpu.data.loader import (
    PrefetchLoader as JPrefetchLoader,
)
from depthmodelhardening_tpu.physics import calibration as j_calibration
from depthmodelhardening_tpu_torch import native
from depthmodelhardening_tpu_torch.data import (
    kitti_object, kitti_raw, object_images, pseudo_lidar, splits, velodyne,
)
from depthmodelhardening_tpu_torch.data.loader import PrefetchLoader
from depthmodelhardening_tpu_torch.parallel.mesh import Mesh
from depthmodelhardening_tpu_torch.physics import calibration
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

ORI_H, ORI_W = 96, 320
NATIVE_H, NATIVE_W = 120, 400
SIZES = ((NATIVE_H, NATIVE_W), (ORI_H, ORI_W), (37, 53), (200, 640))


@pytest.fixture(params=["c", "pil"])
def route(request, monkeypatch):
    """The port's decoding route: its C library, or PIL with the numpy
    resampler (the C library made unavailable)."""
    if request.param == "pil":
        monkeypatch.setattr(native, "_load", lambda: None)
    else:
        assert native._load() is not None, native._build_error
    assert native.decoder().startswith(request.param)
    return request.param


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """PNGs in RGB, RGBA, grey and grey + alpha as PIL writes them (its
    adaptive row filters), the trees' RGB PNG, and a JPEG; name ->
    path."""
    d = tmp_path_factory.mktemp("images")
    rs = np.random.RandomState(0)
    out = {}
    ramp = np.add.outer(np.arange(NATIVE_H), 2 * np.arange(NATIVE_W))
    for name, mode in (("rgb", "RGB"), ("rgba", "RGBA"), ("grey", "L"),
                       ("grey_alpha", "LA")):
        c = len(mode)
        noise = rs.randint(0, 32, (NATIVE_H, NATIVE_W, c))
        img = ((ramp[..., None] + noise) % 256).astype(np.uint8)
        out[name] = str(d / f"{name}.png")
        Image.fromarray(img.squeeze(-1) if c == 1 else img, mode).save(
            out[name])
    out["tree_rgb"] = kt.write_png(str(d / "tree.png"), rs.randint(
        0, 256, (NATIVE_H, NATIVE_W, 3)).astype(np.uint8))
    jpg = rs.randint(0, 256, (NATIVE_H, NATIVE_W, 3)).astype(np.uint8)
    out["jpeg"] = str(d / "img.jpg")
    Image.fromarray(jpg).save(out["jpeg"], quality=90)
    return out


@pytest.mark.parametrize("name", ["rgb", "rgba", "grey", "grey_alpha",
                                  "tree_rgb", "jpeg"])
def test_load_image_and_resized_equal_jax(images, route, name):
    path = images[name]
    want = j_native.load_image(path)
    got = native.load_image(path)
    assert got.dtype == np.float32 and got.shape == (NATIVE_H, NATIVE_W, 3)
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(Image.open(path).convert(
        "RGB"), np.float32) / 255.0)
    for h, w in SIZES:
        assert np.array_equal(native.load_resized(path, h, w),
                              j_native.load_resized(path, h, w)), (h, w)


def test_numpy_resampler_is_the_c_one_and_jax_numpy_is_not(images):
    """`_resize_u8` equals the C resampler bit for bit; the JAX
    package's numpy resize (float64 weights, blending the [0, 1] values)
    does not: it lies up to 1.5e-5 from it (measured here)."""
    u8 = np.asarray(Image.open(images["rgb"]).convert("RGB"))
    for h, w in SIZES[1:]:
        c_route = j_native.load_resized(images["rgb"], h, w)
        assert np.array_equal(native._resize_u8(u8, h, w), c_route)
        jax_numpy = j_native._half_pixel_resize(u8 / np.float32(255), h, w)
        assert not np.array_equal(jax_numpy, c_route)
        np.testing.assert_allclose(jax_numpy, c_route, rtol=0, atol=2e-5)


def test_decoder_names_the_route_and_keeps_the_compiler_error(
        images, monkeypatch):
    assert native.decoder().startswith("c (libpng + libjpeg")
    assert native.image_dims(images["rgb"]) == (NATIVE_H, NATIVE_W)
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(native, "_build_error", "cc: png.h: No such file")
    assert native.decoder().startswith("pil (Pillow")
    assert "png.h" in native.decoder()
    assert native.image_dims(images["rgb"]) is None
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert native.decoder().startswith("none")
    with pytest.raises(ImportError, match="(?s)PIL is not installed.*png.h"):
        native.load_image(images["rgb"])


def test_c_route_builds_into_build_dir():
    path = native.library_path()
    assert path.parent.name == "native" and path.parent.parent.name == \
        "build"
    assert path.exists()
    assert "depthmodelhardening_tpu_torch" not in str(path.parent)


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("raw"))
    kt.write_raw_tree(root, 6, NATIVE_H, NATIVE_W, seed=3,
                      velodyne=range(6), points=600)
    return root, kt.DRIVE


def _lines(drive):
    return [f"{drive} {fr} {side}" for fr in (1, 2, 3, 4)
            for side in ("l", "r")]


@pytest.mark.parametrize("frame_ids", [("0", "s"), ("0", "-1", "1", "s")])
def test_raw_items_and_collate_equal_jax(raw_tree, frame_ids):
    root, drive = raw_tree
    ds = kitti_raw.KittiRawDataset(root, _lines(drive), frame_ids,
                                   ORI_H, ORI_W)
    jds = j_kitti_raw.KittiRawDataset(root, _lines(drive), frame_ids,
                                      ORI_H, ORI_W)
    items, jitems = [], []
    flips = set()
    for i in range(len(ds)):
        it = ds.get_item(i, np.random.RandomState(i), load_depth=True)
        jit = jds.get_item(i, np.random.RandomState(i), load_depth=True)
        assert it["do_flip"] == jit["do_flip"]
        assert it["side_is_l"] == jit["side_is_l"]
        flips.add(it["do_flip"])
        items.append(it)
        jitems.append(jit)
    assert flips == {True, False}
    got, want = kitti_raw.collate(items), j_kitti_raw.collate(jitems)
    assert set(got["frames"]) == set(frame_ids)
    for fid in frame_ids:
        assert got["frames"][fid].shape == (len(ds), ORI_H, ORI_W, 3)
        assert np.array_equal(got["frames"][fid], want["frames"][fid])
    for key in ("side_is_l", "do_flip", "depth_gt"):
        assert got[key].dtype == want[key].dtype
        assert np.array_equal(got[key], want[key]), key
    assert got["depth_gt"].max() > 0


def test_split_line_parse_and_readlines(tmp_path):
    for line in ("a/b 12 l", "a/b 7", "a/b"):
        assert kitti_raw.SplitLine.parse(line) == \
            kitti_raw.SplitLine(**vars(j_kitti_raw.SplitLine.parse(line)))
    p = tmp_path / "x.txt"
    p.write_text("a 1 l\n\n  \nb 2 r  \n")
    assert kitti_raw.readlines(str(p)) == j_kitti_raw.readlines(str(p))
    assert np.array_equal(kitti_raw.NORM_K, j_kitti_raw.NORM_K)


def test_odom_and_depth_paths_equal_jax(tmp_path):
    odom = kitti_raw.KittiOdomDataset(str(tmp_path), ["09 7 l"])
    j_odom = j_kitti_raw.KittiOdomDataset(str(tmp_path), ["09 7 l"])
    for args in (("09", 7, "l"), ("9", 7, "r")):
        assert odom.image_path(*args) == j_odom.image_path(*args)
    with pytest.raises(NotImplementedError, match="no depth"):
        odom.get_depth("09", 7, "l")

    gt_dir = tmp_path / "drive_x" / "proj_depth" / "groundtruth" / "image_02"
    gt_dir.mkdir(parents=True)
    arr = (np.arange(12).reshape(3, 4) * 256 + 17).astype(np.uint16)
    Image.fromarray(arr).save(gt_dir / "0000000003.png")
    ds = kitti_raw.KittiDepthDataset(str(tmp_path), ["drive_x 3 l"],
                                     ori_h=4, ori_w=6)
    jds = j_kitti_raw.KittiDepthDataset(str(tmp_path), ["drive_x 3 l"],
                                        ori_h=4, ori_w=6)
    got = ds.get_depth("drive_x", 3, "l")
    assert np.array_equal(got, jds.get_depth("drive_x", 3, "l"))
    assert got.shape == (4, 6) and got.dtype == np.float32


def test_pil_reads_raise_naming_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    ds = kitti_raw.KittiDepthDataset(str(tmp_path), ["drive_x 3 l"])
    with pytest.raises(ImportError, match="PIL"):
        ds.get_depth("drive_x", 3, "l")
    kt.write_split(str(tmp_path), "eigen_benchmark", test=["drive_x 3 l"])
    with pytest.raises(ImportError, match="PIL"):
        kitti_raw.export_gt_depths(str(tmp_path), str(tmp_path),
                                   "eigen_benchmark")


def test_velodyne_equals_jax(raw_tree, tmp_path):
    root, drive = raw_tree
    calib_dir = os.path.join(root, kt.DATE)
    velo = os.path.join(root, drive, "velodyne_points", "data",
                        "0000000002.bin")
    assert np.array_equal(velodyne.load_velodyne_points(velo),
                          j_velodyne.load_velodyne_points(velo))
    for name in ("calib_cam_to_cam.txt", "calib_velo_to_cam.txt"):
        got = velodyne.read_raw_calib_file(os.path.join(calib_dir, name))
        want = j_velodyne.read_raw_calib_file(os.path.join(calib_dir, name))
        assert set(got) == set(want)
        for k in got:
            assert np.array_equal(got[k], want[k]), k
    for cam, vel_depth in ((2, False), (3, False), (2, True)):
        got = velodyne.generate_depth_map(calib_dir, velo, cam, vel_depth)
        assert np.array_equal(got, j_velodyne.generate_depth_map(
            calib_dir, velo, cam, vel_depth))
        assert (got > 0).sum() > 100
    sparse = velodyne.generate_depth_map(calib_dir, velo)[::4, ::4]
    assert np.array_equal(velodyne.lin_interp(sparse),
                          j_velodyne.lin_interp(sparse))
    assert np.array_equal(velodyne.depth_to_disparity(sparse, 721.5),
                          j_velodyne.depth_to_disparity(sparse, 721.5))


def test_export_gt_depths_equals_jax(raw_tree, tmp_path):
    root, drive = raw_tree
    lines = [f"{drive} {fr} l" for fr in (0, 2, 5)]
    outs = []
    for mod, sub in ((kitti_raw, "port"), (j_kitti_raw, "jax")):
        split_dir = kt.write_split(str(tmp_path / sub), "eigen", test=lines)
        out = mod.export_gt_depths(root, split_dir, "eigen")
        assert out == os.path.join(split_dir, "eigen", "gt_depths.npz")
        outs.append(np.load(out, allow_pickle=True)["data"])
    assert outs[0].dtype == outs[1].dtype == object
    assert outs[0].shape == outs[1].shape and len(outs[0]) == 3
    for got, want in zip(*outs):
        got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
        assert np.array_equal(got, want) and (got > 0).sum() > 100
    kt.write_split(str(tmp_path / "port"), "odom", test=lines)
    with pytest.raises(ValueError):
        kitti_raw.export_gt_depths(root, str(tmp_path / "port"), "odom")


@pytest.fixture(scope="module")
def object_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("object"))
    names = kt.write_object_tree(root, 7, 125, 414, seed=40)
    return root, names


def test_object_scenes_and_batches_equal_jax(object_tree):
    root, names = object_tree
    assert kitti_object.read_path_files(root, "trainval.txt") == \
        j_kitti_object.read_path_files(root, "trainval.txt")
    for size in ((ORI_W, ORI_H), (1242, 375)):
        ds = kitti_object.KittiObjectScenes(root, "val", size,
                                            val_list="test.txt")
        jds = j_kitti_object.KittiObjectScenes(root, "val", size,
                                               val_list="test.txt")
        assert len(ds) == len(jds) == len(names)
        img, label = ds[3]
        jimg, jlabel = jds[3]
        assert label == jlabel and np.array_equal(img, jimg)
        assert img.shape == (size[1], size[0], 3)
        for kw in (dict(), dict(shuffle=False), dict(seed=5),
                   dict(drop_last=False)):
            got = list(ds.batches(3, **kw))
            want = list(jds.batches(3, **kw))
            assert len(got) == len(want) > 0
            for (s, lab), (js, jlab) in zip(got, want):
                assert np.array_equal(s, js) and np.array_equal(lab, jlab)
    limited = kitti_object.KittiObjectScenes(root, "train", data_limit=2,
                                             train_list="trainval.txt")
    assert len(limited) == 2


def test_center_bottom_crop_and_seperate_sets_equal_jax(object_tree,
                                                        tmp_path):
    rs = np.random.RandomState(1)
    img = rs.rand(20, 30, 3).astype(np.float32)
    for h, w in ((10, 12), (20, 30), (25, 40), (5, 50)):
        assert np.array_equal(kitti_object.center_bottom_crop(img, h, w),
                              j_kitti_object.center_bottom_crop(img, h, w))
    root, _ = object_tree
    outs = []
    for mod in (kitti_object, j_kitti_object):
        mod.seperate_sets(root, "trainval.txt", seed=3)
        sub = os.path.join(root, "vehicle_detection")
        outs.append({n: open(os.path.join(sub, n)).read()
                     for n in sorted(os.listdir(sub))})
    assert outs[0] == outs[1] and len(outs[0]) == 4


@pytest.fixture(scope="module")
def cars(tmp_path_factory):
    """A 300-wide car and mask (no resample needed) and a 240 x 100 one
    with a 120 x 50 mask (both resampled); a paint mask for each."""
    d = tmp_path_factory.mktemp("cars")
    wide = kt.write_car(str(d / "BMW.png"), 300, 120, seed=2)
    narrow = kt.write_car(str(d / "Audi.png"), 240, 100, seed=3)
    _, mask = kt.make_car_object(120, 50, seed=4)
    kt.write_png(str(d / "Audi_CarMask.png"), kt.to_u8(mask[0, ..., 0]))
    rs = np.random.RandomState(5)
    for base, (h, w) in ((d / "BMW", (120, 300)), (d / "Audi", (100, 240))):
        kt.write_png(f"{base}_PaintMask1.png",
                     rs.randint(0, 256, (h, w, 3)).astype(np.uint8))
    return {"wide": wide, "narrow": narrow}


@pytest.mark.parametrize("which", ["wide", "narrow"])
@pytest.mark.parametrize("paint", ["-2", "1", "7"])
def test_process_car_img_equals_jax(cars, which, paint):
    got = object_images.process_car_img(cars[which], paint)
    want = j_object_images.process_car_img(cars[which], paint)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[0].shape[2] == object_images.CAR_IMG_WIDTH


def test_process_car_img_without_pil(cars, monkeypatch):
    """Where PIL is missing, a car already 300 wide is decoded through
    the C route and equals the JAX package's (PIL's) result; another
    width raises ImportError naming PIL."""
    want = j_object_images.process_car_img(cars["wide"], "1")
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = object_images.process_car_img(cars["wide"], "1")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    with pytest.raises(ImportError, match="PIL"):
        object_images.process_car_img(cars["narrow"])


def test_grey_is_pils_luma():
    rs = np.random.RandomState(6)
    rgb = rs.randint(0, 256, (31, 47, 3)).astype(np.uint8)
    assert np.array_equal(object_images._grey(rgb),
                          np.asarray(Image.fromarray(rgb).convert("L")))


def test_splits_equal_jax(tmp_path):
    src = tmp_path / "src"
    kt.write_split(str(src), "eigen", test=[f"{kt.DRIVE} 69 l",
                                            f"{kt.DRIVE} 54 r"])
    kt.write_split(str(src), "eigen_full", train=[f"{kt.DRIVE} 1 l"],
                   val=[f"{kt.DRIVE} 2 r"])
    texts = []
    for mod, sub in ((splits, "port"), (j_splits, "jax")):
        dest = tmp_path / sub
        got = mod.import_splits(str(src), str(dest))
        got += mod.import_splits(str(src), str(dest), ["eigen"])
        got += mod.make_odom_split(str(dest))
        got += mod.fetch_splits(str(dest / "fetched"), ["eigen",
                                                        "eigen_full"],
                                base_url=(src.as_uri()))
        texts.append([(os.path.relpath(p, dest), open(p).read())
                      for p in got])
    assert texts[0] == texts[1] and len(texts[0]) == 11
    assert splits.SPLIT_FILES == j_splits.SPLIT_FILES
    assert splits.UPSTREAM_RAW_BASE == j_splits.UPSTREAM_RAW_BASE
    for bad, err in ((["folder notanumber l"], ValueError),
                     (["a 1 l extra"], ValueError)):
        with pytest.raises(err):
            splits.validate_split_lines(bad, "eigen")
        with pytest.raises(err):
            j_splits.validate_split_lines(bad, "eigen")
    with pytest.raises(ValueError, match="unknown splits"):
        splits.import_splits(str(src), str(tmp_path / "x"), ["nope"])
    with pytest.raises(FileNotFoundError):
        splits.import_splits(str(src), str(tmp_path / "x"), ["odom"])


def _calib_file(path):
    c = j_calibration.Calibration.default()
    rs = np.random.RandomState(7)
    row = lambda a: " ".join(f"{float(v):.17g}" for v in a.ravel())
    with open(path, "w") as f:
        f.write(f"P0: {row(rs.rand(12))}\n")
        f.write(f"P2: {row(c.P)}\n")
        f.write(f"R0_rect: {row(c.R0 + 1e-3 * rs.rand(3, 3))}\n")
        f.write(f"Tr_velo_to_cam: {row(c.V2C)}\n")
        f.write("note: not numbers\n\n")
    return str(path)


def test_calibration_from_file_and_transforms_equal_jax(tmp_path):
    path = _calib_file(tmp_path / "000003.txt")
    got_d = calibration.read_calib_file(path)
    want_d = j_calibration.read_calib_file(path)
    assert set(got_d) == set(want_d) == {"P0", "P2", "R0_rect",
                                         "Tr_velo_to_cam"}
    got = calibration.Calibration.from_file(path)
    want = j_calibration.Calibration.from_file(path)
    for name in ("P", "V2C", "R0", "C2V"):
        assert np.array_equal(getattr(got, name), getattr(want, name))
    for name in ("f_u", "f_v", "c_u", "c_v", "b_x", "b_y"):
        assert getattr(got, name) == getattr(want, name)
    rs = np.random.RandomState(8)
    pts = rs.uniform(-10, 40, (50, 3))
    uvd = np.concatenate([rs.uniform(0, 1200, (50, 2)),
                          rs.uniform(2, 60, (50, 1))], 1)
    for fn, x in (("velo_to_ref", pts), ("ref_to_velo", pts),
                  ("ref_to_rect", pts), ("rect_to_ref", pts),
                  ("velo_to_rect", pts), ("rect_to_velo", pts),
                  ("rect_to_image", pts), ("velo_to_image", pts),
                  ("image_to_rect", uvd), ("image_to_velo", uvd)):
        assert np.array_equal(getattr(got, fn)(x), getattr(want, fn)(x)), fn


def test_pseudo_lidar_equals_jax(tmp_path):
    calib = calibration.Calibration.default()
    j_calib = j_calibration.Calibration.default()
    rs = np.random.RandomState(9)
    disp = rs.uniform(-5, 60, (40, 120)).astype(np.float32)
    depth = rs.uniform(1, 60, (40, 120))
    for fn, x in (("project_disp_to_points", disp),
                  ("project_depth_to_points", depth)):
        got = getattr(pseudo_lidar, fn)(calib, x, max_high=1.5)
        assert np.array_equal(got, getattr(j_pseudo_lidar, fn)(
            j_calib, x, max_high=1.5)) and len(got) > 0, fn
    cloud = kt.velodyne_scan(3000, 11)[:, :3].astype(np.float64)
    assert np.array_equal(
        pseudo_lidar.generate_disparity_from_velo(cloud, 375, 1242, calib),
        j_pseudo_lidar.generate_disparity_from_velo(cloud, 375, 1242,
                                                    j_calib))
    w, h = pseudo_lidar.fit_ground_plane(cloud, calib, seed=3)
    jw, jh = j_pseudo_lidar.fit_ground_plane(cloud, j_calib, seed=3)
    assert np.array_equal(w, jw) and h == jh and w[1] < 0
    coef, icpt = pseudo_lidar._ransac_plane(cloud[:, :2], cloud[:, 2], 7, 1)
    j_coef, j_icpt = j_pseudo_lidar._ransac_plane(cloud[:, :2], cloud[:, 2],
                                                  7, 1)
    assert np.array_equal(coef, j_coef) and icpt == j_icpt
    flat = pseudo_lidar.fit_ground_plane(cloud[:2], calib)
    assert flat[1] == 1.65
    # the batch run: .bin clouds + calib files -> plane files
    files = {}
    for mod, sub in ((pseudo_lidar, "port"), (j_pseudo_lidar, "jax")):
        lidar, cdir = tmp_path / sub / "velodyne", tmp_path / "calib"
        lidar.mkdir(parents=True)
        cdir.mkdir(exist_ok=True)
        for i in range(2):
            mod.save_pseudo_lidar(kt.velodyne_scan(2000, 12 + i)[:, :3],
                                  str(lidar / f"{i:06d}.bin"))
            _calib_file(cdir / f"{i:06d}.txt")
        mod.extract_ransac(str(cdir), str(lidar), str(tmp_path / sub /
                                                      "planes"))
        files[sub] = [(p.name, p.read_bytes()) for p in sorted(
            (tmp_path / sub).rglob("*.*"))]
    assert files["port"] == files["jax"] and len(files["port"]) == 4


def _loader_batches(loader, epochs=2):
    return [[b for b in loader] for _ in range(epochs)]


def _leaves(batch, prefix=""):
    for k, v in batch.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("shuffle", [True, False])
def test_prefetch_loader_equals_jax_over_two_epochs(raw_tree, shuffle):
    """Same order and items for one seed over two epochs (the epoch's
    shuffle and each item's do_flip), landing as tensors on the device
    asked for, with the numpy batch's dtypes."""
    root, drive = raw_tree
    ds = kitti_raw.KittiRawDataset(root, _lines(drive), ("0", "s"),
                                   ORI_H, ORI_W)
    loader = PrefetchLoader(ds, 3, kitti_raw.collate, shuffle=shuffle,
                            seed=4, num_threads=3, device="cpu")
    jloader = JPrefetchLoader(ds, 3, j_kitti_raw.collate, shuffle=shuffle,
                              seed=4, num_threads=3)
    assert len(loader) == len(jloader) == 2
    got, want = _loader_batches(loader), _loader_batches(jloader)
    flips = []
    for epoch_got, epoch_want in zip(got, want):
        assert len(epoch_got) == len(epoch_want) == 2
        for b, jb in zip(epoch_got, epoch_want):
            leaves, jleaves = dict(_leaves(b)), dict(_leaves(jb))
            assert set(leaves) == set(jleaves) == {
                "frames/0", "frames/s", "side_is_l", "do_flip"}
            for k, t in leaves.items():
                assert isinstance(t, torch.Tensor) and \
                    t.device == torch.device("cpu")
                j = np.asarray(jleaves[k])
                assert t.numpy().dtype == j.dtype
                assert np.array_equal(t.numpy(), j), k
            flips.append(b["do_flip"].tolist())
    assert got[0][0]["frames"]["0"].shape == (3, ORI_H, ORI_W, 3)
    if shuffle:
        assert flips[:2] != flips[2:]  # a new epoch draws anew


def test_prefetch_loader_drop_last_and_item_fn(raw_tree):
    root, drive = raw_tree
    ds = kitti_raw.KittiRawDataset(root, _lines(drive), ("0",), ORI_H,
                                   ORI_W)
    calls = []

    def item_fn(d, i, rng):
        calls.append(i)
        return d.get_item(i, rng)

    loader = PrefetchLoader(ds, 3, kitti_raw.collate, drop_last=False,
                            item_fn=item_fn, device="cpu", num_threads=2)
    sizes = [b["do_flip"].shape[0] for b in loader]
    assert len(loader) == 3 and sizes == [3, 3, 2]
    assert sorted(calls) == list(range(len(ds)))


def test_prefetch_loader_early_break_does_not_hang(raw_tree):
    """An abandoned iterator stops its producer (it re-checks the stop
    flag while the queue is full)."""
    root, drive = raw_tree
    ds = kitti_raw.KittiRawDataset(root, [f"{drive} 1 l"] * 12, ("0",),
                                   ORI_H, ORI_W)
    loader = PrefetchLoader(ds, 2, kitti_raw.collate, num_threads=2,
                            prefetch=1, device="cpu")
    before = threading.active_count()
    it = iter(loader)
    next(it)
    it.close()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_prefetch_loader_raises_what_the_producer_raised(tmp_path):
    """A failing item ends the iteration with its error instead of
    leaving the consumer waiting (the JAX loader's consumer would wait
    forever)."""
    ds = kitti_raw.KittiRawDataset(str(tmp_path), ["missing 1 l"] * 4,
                                   ("0",), ORI_H, ORI_W)
    loader = PrefetchLoader(ds, 2, kitti_raw.collate, device="cpu")
    with pytest.raises((FileNotFoundError, OSError)):
        list(loader)


def test_prefetch_loader_device_and_mesh(raw_tree):
    """The loader lands batches on the card unless asked otherwise (and
    so raises here). With mesh= each rank decodes only its rows of each
    global batch, and the ranks' batches concatenate to the one process's,
    bit for bit, in the same order (JAX's loader shards them likewise)."""
    root, drive = raw_tree
    ds = kitti_raw.KittiRawDataset(root, _lines(drive), ("0", "s"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PrefetchLoader(ds, 2, kitti_raw.collate)

    def run(mesh):
        decoded = []
        item = lambda d, i, rng: (decoded.append(i), d.get_item(i, rng))[1]
        return list(PrefetchLoader(ds, 4, kitti_raw.collate, seed=3,
                                   device="cpu", mesh=mesh,
                                   item_fn=item)), decoded

    whole, n_whole = run(None)
    parts = [run(Mesh(r, 2, torch.device("cpu"))) for r in range(2)]
    assert len(whole) == 2 and all(len(p) == 2 for p, _ in parts)
    assert sorted(parts[0][1] + parts[1][1]) == sorted(n_whole)
    cat = lambda get: torch.cat([get(p[0][b]) for p in parts])
    for b, w in enumerate(whole):
        for fid in ("0", "s"):
            assert torch.equal(cat(lambda x: x["frames"][fid]),
                               w["frames"][fid])
        for k in ("side_is_l", "do_flip"):
            assert torch.equal(cat(lambda x: x[k]), w[k])
