"""The port's OpenRooms loader and ``BatchIterator`` against the JAX
package's, on the same files, seed and epoch: bit-equal.

The tree is the one of ``tests/test_cli_smoke.py`` (random HDR image,
PNG maps, ``.dat`` depth and a full-resolution envmap for each of 3
images at 64x64, lighting grid 32x32), plus cascade-0 products as ``.h5``
files (``utils/io.write_h5``) for the cascade-1 loader: all six for
every image, the SG file for two of the three, so the loader's fallback
for a missing one is exercised.  Also mirrors
``test_openrooms_loader_contract`` and
``test_batch_iterator_process_mode_matches_thread``.
``write_dataset`` is shared with the other port test files.
"""

import os.path as osp
import struct

import numpy as np
import pytest

from inverserenderingofindoorscene_tpu.data import openrooms as jopenrooms
from inverserenderingofindoorscene_torch.data import openrooms
from inverserenderingofindoorscene_torch.utils.io import write_h5

IM_HW = (64, 64)
ENV_RC = (32, 32)
NIMG = 3
SG_NUM = 12


def write_dataset(root):
    """The test_cli_smoke.py tree under ``root`` (a pathlib.Path)."""
    import cv2

    scene_rel = "scene0001"
    scene = root / "main_xml" / scene_rel
    scene.mkdir(parents=True)
    (root / "train.txt").write_text(scene_rel + "\n")
    (root / "test.txt").write_text(scene_rel + "\n")

    rng = np.random.RandomState(0)
    h, w = IM_HW
    r, c = ENV_RC
    for i in range(1, NIMG + 1):
        hdr = rng.rand(h, w, 3).astype(np.float32)
        assert cv2.imwrite(str(scene / f"im_{i}.hdr"), hdr[:, :, ::-1])

        def png(name, arr):
            cv2.imwrite(str(scene / name), (arr * 255).astype(np.uint8))

        png(f"imbaseColor_{i}.png", rng.rand(h, w, 3))
        n = rng.uniform(-1, 1, (h, w, 3))
        n[..., 2] = np.abs(n[..., 2]) + 0.3
        n /= np.linalg.norm(n, axis=2, keepdims=True)
        png(f"imnormal_{i}.png", 0.5 * (n + 1))
        png(f"imroughness_{i}.png", rng.rand(h, w, 3))
        m = np.kron(rng.rand(h // 16, w // 16), np.ones((16, 16)))
        mask = np.where(m < 0.6, 255, np.where(m < 0.8, 128, 0)).astype(
            np.uint8)
        cv2.imwrite(str(scene / f"immask_{i}.png"),
                    np.stack([mask] * 3, axis=-1))
        depth = (rng.rand(h, w).astype(np.float32) * 4 + 0.2)
        with open(scene / f"imdepth_{i}.dat", "wb") as f:
            f.write(struct.pack("i", h))
            f.write(struct.pack("i", w))
            f.write(depth.tobytes())
        env = rng.rand(r * 16, c * 32, 3).astype(np.float32)
        assert cv2.imwrite(str(scene / f"imenv_{i}.hdr"), env[:, :, ::-1])
    return str(root)


def write_pre(root, skip_env=(3,)):
    """Cascade-0 products of every image (CHW ``.h5`` at the lighting
    grid, random), and the SG file of the images not in ``skip_env``."""
    rng = np.random.RandomState(7)
    r, c = ENV_RC
    chans = {"imbaseColor_": 3, "imnormal_": 3, "imroughness_": 1,
             "imdepth_": 1, "imdiffuse_": 3, "imspecular_": 3}
    scene = osp.join(root, "main_xml", "scene0001")
    for i in range(1, NIMG + 1):
        im = osp.join(scene, f"im_{i}.hdr")
        for stem, ch in chans.items():
            x = rng.uniform(-1, 1, (r, c, ch)).astype(np.float32)
            if stem in ("imdepth_", "imdiffuse_", "imspecular_"):
                x = np.abs(x) + 0.1
            write_h5(x, openrooms.product_path(im, stem, 0))
        if i not in skip_env:
            write_h5(rng.rand(r, c, 7 * SG_NUM).astype(np.float32),
                     openrooms.product_path(im, "imenv_", 0))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    pytest.importorskip("cv2")
    pytest.importorskip("h5py")
    root = write_dataset(tmp_path_factory.mktemp("openrooms"))
    write_pre(root)
    return root


def assert_items_equal(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        if k == "name":
            assert got[k] == w
            continue
        g = np.asarray(got[k])
        w = np.asarray(w)
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)


def pair(dataset, **kw):
    kw = dict(im_hw=IM_HW, env_rc=ENV_RC, sg_num=SG_NUM, **kw)
    return (openrooms.OpenRoomsDataset(dataset, **kw),
            jopenrooms.OpenRoomsDataset(dataset, **kw))


@pytest.mark.parametrize("cascade,is_light,all_light,phase", [
    (0, False, False, "TRAIN"),
    (0, True, True, "TRAIN"),
    (0, True, True, "TEST"),
    (1, False, False, "TRAIN"),
    (1, True, False, "TRAIN"),
    (1, True, True, "TRAIN"),
])
def test_openrooms_items_bit_equal(dataset, cascade, is_light, all_light,
                                   phase):
    """Items of both loaders at epochs 0 and 1 (the exposure draw
    differs by epoch): BRDF mode, light mode, cascade 0 and cascade 1
    (``*_pre`` maps and ``env_pre``; a missing SG file gives zeros and
    ``env_ind`` 0 in both)."""
    port, jax_ds = pair(dataset, cascade_level=cascade, is_light=is_light,
                        is_all_light=all_light, phase=phase, seed=5)
    assert port.im_list == jax_ds.im_list
    assert len(port) == (2 if cascade and all_light else NIMG)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jax_ds.set_epoch(epoch)
        for i in range(len(port)):
            assert_items_equal(port[i], jax_ds[i])
    if cascade and is_light and not all_light:
        assert float(port[2]["env_ind"][0]) == 0.0
        assert not port[2]["env_pre"].any()


@pytest.mark.parametrize("scale", [1.0, 0.5, 0.731])
def test_envmap_native_and_cv2_routes(dataset, scale):
    """The native decode + pool and the cv2 + numpy route (taken for a
    file the native decoder rejects): bit-equal at scale 1 and at a power
    of two; at another exposure scale within 1 ulp, because the native
    route folds the scale into the pooling weight and the cv2 route
    multiplies the mean (both packages do so)."""
    port, _ = pair(dataset, is_light=True)
    path = osp.join(dataset, "main_xml", "scene0001", "imenv_2.hdr")
    native, ind = port._load_envmap(path, scale)
    plain, ind2 = port._load_envmap_cv2(path, scale)
    assert ind == ind2 == 1.0
    if scale in (1.0, 0.5):
        np.testing.assert_array_equal(native, plain)
    else:
        np.testing.assert_array_max_ulp(native, plain, maxulp=1)


def test_missing_envmap_gives_zeros(dataset, tmp_path):
    port, _ = pair(dataset, is_light=True)
    env, ind = port._load_envmap(str(tmp_path / "imenv_9.hdr"))
    assert ind == 0.0 and env.shape == (*ENV_RC, 128, 3) and not env.any()


def test_openrooms_loader_contract(dataset):
    """test_cli_smoke.py::test_openrooms_loader_contract on the port."""
    ds = openrooms.OpenRoomsDataset(dataset, im_hw=IM_HW, env_rc=ENV_RC,
                                    is_light=True, is_all_light=True)
    assert len(ds) == NIMG
    item = ds[0]
    h, w = IM_HW
    assert item["im"].shape == (h, w, 3)
    assert item["im"].min() >= 0 and item["im"].max() <= 1
    assert item["albedo"].shape == (h, w, 3)
    nn = np.linalg.norm(item["normal"], axis=2)
    np.testing.assert_allclose(nn[nn > 0.1], 1.0, atol=1e-3)
    assert item["depth"].shape == (h, w, 1)
    assert item["env_gt"].shape == (ENV_RC[0], ENV_RC[1], 128, 3)
    assert float(item["env_ind"][0]) == 1.0
    s = item["seg_area"] + item["seg_env"] + item["seg_brdf"]
    assert 0.8 < float(s.mean()) <= 1.01

    it = openrooms.BatchIterator(ds, 2, num_workers=1)
    b = next(iter(it))
    assert b["im"].shape == (2, h, w, 3)
    assert len(b["name"]) == 2


@pytest.mark.parametrize("workers", [1, 2])
def test_batch_iterator_thread_bit_equal(dataset, workers):
    """Thread-mode batches of both packages over two epochs: the same
    order, names and bits."""
    port, jax_ds = pair(dataset, is_light=True, is_all_light=True, seed=3)
    pit = openrooms.BatchIterator(port, 1, num_workers=workers, seed=3)
    jit = jopenrooms.BatchIterator(jax_ds, 1, num_workers=workers, seed=3)
    for _ in range(2):
        got, want = list(pit), list(jit)
        assert len(got) == len(want) == NIMG
        for g, w in zip(got, want):
            assert_items_equal(g, w)


def test_batch_iterator_process_mode_matches_jax(dataset):
    """The port's spawned process pool gives the JAX package's serial
    batches over two epochs (the augmentations are keyed by (seed, epoch,
    item), not by worker), and the second epoch differs from the first;
    test_cli_smoke.py::test_batch_iterator_process_mode_matches_thread
    on the port."""
    port, jax_ds = pair(dataset, seed=3)
    itp = openrooms.BatchIterator(port, 2, num_workers=2, seed=3,
                                  mode="process")
    serial = jopenrooms.BatchIterator(jax_ds, 2, num_workers=1, seed=3)
    try:
        epochs = []
        for _ in range(2):
            proc, ref = list(itp), list(serial)
            assert len(proc) == len(ref) == 1
            for bp, bs in zip(proc, ref):
                assert_items_equal(bp, bs)
            epochs.append(proc)
        assert not np.array_equal(epochs[0][0]["im"], epochs[1][0]["im"])
    finally:
        itp.close()


def test_batch_iterator_raises_a_worker_error(dataset):
    """An item that fails to load raises in the consumer; the iterator
    does not hang."""
    ds = openrooms.OpenRoomsDataset(dataset, im_hw=IM_HW, env_rc=ENV_RC)
    ds.im_list = ds.im_list[:1] + [ds.im_list[0].replace("im_1", "im_9")]
    with pytest.raises(FileNotFoundError):
        list(openrooms.BatchIterator(ds, 1, num_workers=2, shuffle=False))


# ------------------------------------------------ IIW, NYU, the fixtures

H, W = 48, 64


@pytest.fixture(scope="module")
def iiw_root(tmp_path_factory):
    """tests/test_real_loaders.py's IIW tree: 2 images with the five
    kinds of judgement rows (kept, darker 1 and 2, a non-opaque point, an
    unknown label)."""
    import json

    from PIL import Image

    root = tmp_path_factory.mktemp("iiw")
    rng = np.random.RandomState(0)
    names = []
    for i in range(2):
        name = f"img{i}.png"
        Image.fromarray(
            (rng.rand(96, 128, 3) * 255).astype(np.uint8)).save(root / name)
        judgements = {
            "intrinsic_points": [
                {"id": 1, "x": 0.2, "y": 0.2, "opaque": True},
                {"id": 2, "x": 0.8, "y": 0.8, "opaque": True},
                {"id": 3, "x": 0.5, "y": 0.5, "opaque": False},
            ],
            "intrinsic_comparisons": [
                {"point1": 1, "point2": 2, "darker": "E",
                 "darker_score": 1.0},
                {"point1": 1, "point2": 2, "darker": "1",
                 "darker_score": 0.5},
                {"point1": 1, "point2": 2, "darker": "2",
                 "darker_score": 0.7},
                {"point1": 1, "point2": 3, "darker": "1",
                 "darker_score": 1.0},
                {"point1": 1, "point2": 2, "darker": "0",
                 "darker_score": 1.0},
            ],
        }
        with open(root / name.replace(".png", ".json"), "w") as f:
            json.dump(judgements, f)
        names.append(name)
    (root / "list.txt").write_text("\n".join(names) + "\n")
    return str(root)


@pytest.fixture(scope="module")
def nyu_root(tmp_path_factory):
    """tests/test_real_loaders.py's NYU tree: 2 frames of 480x640."""
    cv2 = pytest.importorskip("cv2")
    base = tmp_path_factory.mktemp("nyu")
    rng = np.random.RandomState(1)
    for sub in ("images", "normals", "depths", "segs"):
        (base / sub).mkdir()
    names = []
    for i in range(2):
        name = f"frame{i}.png"
        cv2.imwrite(str(base / "images" / name),
                    (rng.rand(480, 640, 3) * 255).astype(np.uint8))
        n = rng.uniform(-1, 1, (480, 640, 3))
        n[..., 2] = np.abs(n[..., 2]) + 0.3
        n /= np.linalg.norm(n, axis=2, keepdims=True)
        cv2.imwrite(str(base / "normals" / name),
                    ((n * 0.5 + 0.5) * 255).astype(np.uint8))
        cv2.imwrite(str(base / "segs" / name),
                    np.full((480, 640, 3), 255, np.uint8))
        depth = (rng.rand(480, 640) * 8 + 0.5).astype(np.float32)
        cv2.imwrite(str(base / "depths" / name.replace(".png", ".tiff")),
                    depth)
        names.append(name)
    (base / "list.txt").write_text("\n".join(names) + "\n")
    return str(base)


def nyu_args(root):
    return [osp.join(root, sub) for sub in
            ("images", "normals", "depths", "segs", "list.txt")]


@pytest.mark.parametrize("max_num", [10, 2])
def test_iiw_items_bit_equal(iiw_root, max_num):
    """IIWDataset items of both packages at epochs 0 and 1; max_num 2
    takes the random subsample of the pair lists."""
    from inverserenderingofindoorscene_tpu.data.iiw import IIWDataset as J
    from inverserenderingofindoorscene_torch.data.iiw import IIWDataset

    kw = dict(im_hw=(H, W), max_num=max_num, seed=4)
    lst = osp.join(iiw_root, "list.txt")
    port, jax_ds = IIWDataset(iiw_root, lst, **kw), J(iiw_root, lst, **kw)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jax_ds.set_epoch(epoch)
        for i in range(len(port)):
            assert_items_equal(port[i], jax_ds[i])


@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
def test_nyu_items_bit_equal(nyu_root, phase):
    from inverserenderingofindoorscene_tpu.data.nyu import NYUDataset as J
    from inverserenderingofindoorscene_torch.data.nyu import NYUDataset

    kw = dict(im_hw=(H, W), phase=phase, seed=2)
    port, jax_ds = NYUDataset(*nyu_args(nyu_root), **kw), J(
        *nyu_args(nyu_root), **kw)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jax_ds.set_epoch(epoch)
        for i in range(len(port)):
            assert_items_equal(port[i], jax_ds[i])


def test_zip_dataset_bit_equal(iiw_root, nyu_root):
    """ZipDataset of an NYU and an IIW loader in both packages: length
    the longer, the shorter wrapping."""
    from inverserenderingofindoorscene_tpu.data import iiw as jiiw
    from inverserenderingofindoorscene_tpu.data import nyu as jnyu
    from inverserenderingofindoorscene_torch.data import iiw, nyu

    lst = osp.join(iiw_root, "list.txt")
    short = dict(im_hw=(H, W), max_num=10)
    port = iiw.ZipDataset(nyu.NYUDataset(*nyu_args(nyu_root), im_hw=(H, W)),
                          iiw.IIWDataset(iiw_root, lst, **short))
    want = jiiw.ZipDataset(jnyu.NYUDataset(*nyu_args(nyu_root),
                                           im_hw=(H, W)),
                           jiiw.IIWDataset(iiw_root, lst, **short))
    assert len(port) == len(want) == 2
    for i in range(3):
        for g, w in zip(port[i], want[i]):
            assert_items_equal(g, w)


def test_iiw_loader(iiw_root):
    """tests/test_real_loaders.py::test_iiw_loader on the port."""
    from inverserenderingofindoorscene_torch.data.iiw import IIWDataset

    ds = IIWDataset(iiw_root, osp.join(iiw_root, "list.txt"), im_hw=(H, W),
                    max_num=10, seed=0)
    assert len(ds) == 2
    item = ds[0]
    assert item["im"].shape == (H, W, 3)
    assert 0 <= item["im"].min() and item["im"].max() <= 1.0
    assert item["eq_point"].shape == (10, 4)
    assert item["eq_weight"].shape == (10,)
    # 1 eq pair + the leading dummy row; the opaque=False and darker='0'
    # rows dropped
    assert int(item["eq_num"]) == 2
    assert int(item["darker_num"]) == 3  # dummy + '1' + '2'
    assert item["eq_point"].min() >= 0
    assert item["eq_point"][:, [0, 2]].max() < H
    assert item["eq_point"][:, [1, 3]].max() < W
    assert (item["darker_weight"] > 0).sum() == 2


def test_zip_dataset(iiw_root):
    """tests/test_real_loaders.py::test_zip_dataset on the port."""
    from inverserenderingofindoorscene_torch.data.iiw import (
        IIWDataset,
        ZipDataset,
    )

    ds = IIWDataset(iiw_root, osp.join(iiw_root, "list.txt"), im_hw=(H, W),
                    max_num=10)

    class Fake:
        def __len__(self):
            return 5

        def __getitem__(self, i):
            return i

    z = ZipDataset(Fake(), ds)
    assert len(z) == 5
    a, b = z[3]
    assert a == 3
    assert b["im"].shape == (H, W, 3)


def test_nyu_loader(nyu_root):
    """tests/test_real_loaders.py::test_nyu_loader on the port."""
    from inverserenderingofindoorscene_torch.data.nyu import NYUDataset

    ds = NYUDataset(*nyu_args(nyu_root), im_hw=(H, W), seed=0)
    assert len(ds) == 2
    item = ds[0]
    assert item["im"].shape == (H, W, 3)
    assert item["normal"].shape == (H, W, 3)
    np.testing.assert_allclose(np.linalg.norm(item["normal"], axis=2), 1.0,
                               atol=1e-3)
    assert item["depth"].shape == (H, W, 1)
    assert item["seg_depth"].shape == (H, W, 1)
    assert set(np.unique(item["seg_depth"])) <= {0.0, 1.0}
    ds_test = NYUDataset(*nyu_args(nyu_root), im_hw=(H, W), phase="TEST")
    np.testing.assert_array_equal(ds_test[0]["im"], ds_test[0]["im"])


def test_iiw_fixture_format(tmp_path):
    """tests/test_real_loaders.py::test_iiw_fixture_format on the port's
    writer and loader."""
    import json

    from inverserenderingofindoorscene_torch.data.fixture import (
        write_iiw_fixture,
    )
    from inverserenderingofindoorscene_torch.data.iiw import IIWDataset

    pytest.importorskip("cv2")
    root = str(tmp_path / "iiw")
    for _ in range(2):  # the second call finds the marker
        write_iiw_fixture(root, n_train=2, n_test=1, frame_hw=(96, 128),
                          n_pairs=20)
    names = open(osp.join(root, "IIWTrain.txt")).read().split()
    assert len(names) == 2
    ds = IIWDataset(root, osp.join(root, "IIWTrain.txt"), im_hw=(48, 64),
                    max_num=30, seed=0)
    item = ds[0]
    assert item["im"].shape == (48, 64, 3)
    # all 20 pairs are opaque with weight 1: dummy rows + survivors
    assert int(item["eq_num"]) + int(item["darker_num"]) == 22
    with open(osp.join(root, names[0].replace(".png", ".json"))) as f:
        j = json.load(f)
    assert len(j["intrinsic_comparisons"]) == 20
    assert {c["darker"] for c in j["intrinsic_comparisons"]} <= {"1", "2",
                                                                 "E"}


def tree_bytes(root):
    """{relative path: file bytes} of every file under ``root``."""
    import os

    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = osp.join(dirpath, name)
            with open(path, "rb") as f:
                out[osp.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("writer,kw", [
    ("write_openrooms_fixture", dict(n_scenes=1, per_scene=2,
                                     n_test_scenes=1, im_hw=(48, 64),
                                     env_rc=(12, 16), seed=3)),
    ("write_iiw_fixture", dict(n_train=2, n_test=1, frame_hw=(96, 128),
                               n_pairs=20, seed=1)),
    ("write_nyu_fixture", dict(n_train=2, n_test=1, frame_hw=(48, 64),
                               seed=2)),
])
def test_fixture_trees_byte_identical(tmp_path, writer, kw):
    """The port's fixture writers give the JAX writers' trees, file by
    file, byte for byte (the port renders with its own copy of the
    float64 oracle)."""
    from inverserenderingofindoorscene_tpu.data import fixture as jfixture
    from inverserenderingofindoorscene_torch.data import fixture

    pytest.importorskip("cv2")
    getattr(fixture, writer)(str(tmp_path / "port"), **kw)
    getattr(jfixture, writer)(str(tmp_path / "jax"), **kw)
    got, want = tree_bytes(tmp_path / "port"), tree_bytes(tmp_path / "jax")
    assert sorted(got) == sorted(want) and len(got) > 4
    for name, data in want.items():
        assert got[name] == data, name


def test_openrooms_fixture_loads(tmp_path):
    """A fixture tree written by the port feeds the port's loader in both
    modes (the envmap through the native decoder)."""
    from inverserenderingofindoorscene_torch.data.fixture import (
        write_openrooms_fixture,
    )

    root = write_openrooms_fixture(str(tmp_path / "or"), n_scenes=1,
                                   per_scene=2, n_test_scenes=0,
                                   im_hw=(48, 64), env_rc=(12, 16))
    ds = openrooms.OpenRoomsDataset(root, im_hw=(48, 64), env_rc=(12, 16),
                                    is_light=True, is_all_light=True)
    assert len(ds) == 2
    item = ds[1]
    assert item["env_gt"].shape == (12, 16, 128, 3)
    assert float(item["env_ind"][0]) == 1.0
    assert np.isfinite(item["env_gt"]).all() and item["env_gt"].max() > 0
