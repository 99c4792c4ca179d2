"""The port's packed item cache (``data/cache.py``) and ``build_cache``,
on the OpenRooms tree of tests/test_torch_loaders.py (3 images at 64x64,
lighting grid 32x32).

Mirrors ``test_packed_cache_matches_direct_loader``,
``test_build_cache_cli`` and ``test_cache_build_kill_resume`` of
tests/test_cli_smoke.py for the port, and holds the port's cache to the
JAX package's ``CachedOpenRoomsDataset`` on the same tree: the same
shard directory, bit-equal shards, and each package reads the cache the
other built.  The contract (the module's docstring): every LDR field,
``depth``, the segs and ``im`` bit-equal to the direct loader,
``env_gt`` within ~1 ulp, ``half=True`` within ~1e-3 relative.
"""

import os
import os.path as osp
import subprocess
import sys
import time

import numpy as np
import pytest

from inverserenderingofindoorscene_torch.cli import build_cache, common
from inverserenderingofindoorscene_torch.data.cache import (
    CachedOpenRoomsDataset,
)
from inverserenderingofindoorscene_torch.data.openrooms import (
    BatchIterator,
    OpenRoomsDataset,
)
from test_torch_loaders import ENV_RC, IM_HW, NIMG, write_dataset

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    pytest.importorskip("cv2")
    return write_dataset(tmp_path_factory.mktemp("openrooms"))


def make(root, phase="TRAIN", package=None):
    cls = OpenRoomsDataset
    if package == "jax":
        from inverserenderingofindoorscene_tpu.data.openrooms import (
            OpenRoomsDataset as cls,
        )
    return cls(root, im_hw=IM_HW, env_rc=ENV_RC, phase=phase,
               is_light=True, is_all_light=True, seed=5)


def assert_contract(got, want):
    """A cached item or batch against the direct loader's."""
    assert set(got) == set(want)
    for k in want:
        if k == "name":
            assert got[k] == want[k]
        elif k == "env_gt":
            np.testing.assert_allclose(got[k], want[k], rtol=3e-6,
                                       atol=1e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_cache_matches_direct_loader(dataset, tmp_path):
    """Items at epochs 0 and 1, the TEST phase's fixed exposure, a second
    construction that reads the built cache, and ``half=True``."""
    direct = make(dataset)
    cached = CachedOpenRoomsDataset(make(dataset), str(tmp_path / "cache"))
    assert not cached.reused
    for epoch in (0, 1):
        direct.set_epoch(epoch)
        cached.set_epoch(epoch)
        for i in range(len(direct)):
            assert_contract(cached[i], direct[i])
    # the exposure stream moved on with the epoch
    cached.set_epoch(0)
    e0 = cached[0]["im"]
    cached.set_epoch(1)
    assert not np.array_equal(cached[0]["im"], e0)

    t0 = time.time()
    again = CachedOpenRoomsDataset(make(dataset), str(tmp_path / "cache"))
    assert again.reused and again.dir == cached.dir
    assert time.time() - t0 < 2.0

    test_direct = make(dataset, "TEST")
    test_cached = CachedOpenRoomsDataset(make(dataset, "TEST"),
                                         str(tmp_path / "cache"))
    np.testing.assert_array_equal(test_cached[0]["im"],
                                  test_direct[0]["im"])

    half = CachedOpenRoomsDataset(make(dataset), str(tmp_path / "cache"),
                                  half=True)
    assert half.dir != cached.dir
    assert np.load(osp.join(half.dir, "env_gt.npy"),
                   mmap_mode="r").dtype == np.float16
    direct.set_epoch(0)
    half.set_epoch(0)
    a, b = direct[0], half[0]
    np.testing.assert_allclose(b["im"], a["im"], atol=2e-3)
    np.testing.assert_allclose(b["env_gt"], a["env_gt"], rtol=2e-3,
                               atol=1e-6)
    np.testing.assert_array_equal(b["albedo"], a["albedo"])


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_cached_batches_match_direct_batches(dataset, tmp_path, mode):
    """``BatchIterator`` over the cache (its ``get_batch`` branch in
    thread mode, pickled items in process mode) against one over the
    direct loader, two epochs."""
    it_d = BatchIterator(make(dataset), 2, num_workers=2, seed=7,
                         mode="thread")
    it_c = BatchIterator(
        CachedOpenRoomsDataset(make(dataset), str(tmp_path / "cache")), 2,
        num_workers=2, seed=7, mode=mode)
    try:
        for _ in range(2):
            n = 0
            for bd, bc in zip(it_d, it_c):
                assert_contract(bc, bd)
                n += 1
            assert n == NIMG // 2
    finally:
        it_c.close()


def test_get_batch_equals_item_collate(dataset, tmp_path, monkeypatch):
    """``get_batch`` gives the collated items bit for bit, and
    ``BatchIterator`` takes it in thread mode (its recycled buffers are
    not handed out while a consumer holds them)."""
    cached = CachedOpenRoomsDataset(make(dataset), str(tmp_path / "cache"))
    cached.set_epoch(1)
    idxs = [2, 0]
    want = BatchIterator._collate([cached[i] for i in idxs])
    got = cached.get_batch(idxs)
    for k in want:
        if k == "name":
            assert got[k] == want[k]
        else:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    held = {k: v.copy() for k, v in got.items() if k != "name"}
    other = cached.get_batch([1, 2])
    assert not np.shares_memory(other["im"], got["im"])
    for k, v in held.items():  # the held batch is left as it was
        np.testing.assert_array_equal(got[k], v)

    calls = []
    orig = CachedOpenRoomsDataset.get_batch
    monkeypatch.setattr(CachedOpenRoomsDataset, "get_batch",
                        lambda self, i: (calls.append(list(i)),
                                         orig(self, i))[1])
    batches = list(BatchIterator(cached, 1, shuffle=False, num_workers=2))
    assert calls == [[0], [1], [2]]
    assert [b["name"] for b in batches] == [[n] for n in cached.im_list]


def test_cache_interchangeable_with_jax_cache(dataset, tmp_path):
    """The JAX package's cache and the port's, from the same tree: the
    same directory name and field files, bit-equal shards, and each
    package reads the cache the other built."""
    from inverserenderingofindoorscene_tpu.data.cache import (
        CachedOpenRoomsDataset as JCached,
    )

    jdir = str(tmp_path / "jax")
    pdir = str(tmp_path / "port")
    jc = JCached(make(dataset, package="jax"), jdir, verbose=False)
    pc = CachedOpenRoomsDataset(make(dataset), pdir, verbose=False)
    assert osp.basename(jc.dir) == osp.basename(pc.dir)
    files = sorted(os.listdir(jc.dir))
    assert files == sorted(os.listdir(pc.dir))
    for f in files:
        if f.endswith(".npy") or f == "built.u8":
            with open(osp.join(jc.dir, f), "rb") as a, \
                    open(osp.join(pc.dir, f), "rb") as b:
                assert a.read() == b.read(), f
    with open(osp.join(jc.dir, "meta.json")) as a, \
            open(osp.join(pc.dir, "meta.json")) as b:
        assert a.read() == b.read()

    # the port reads the JAX-built cache, and JAX the port-built one
    port_on_jax = CachedOpenRoomsDataset(make(dataset), jdir, verbose=False)
    jax_on_port = JCached(make(dataset, package="jax"), pdir, verbose=False)
    assert port_on_jax.reused
    for epoch in (0, 1):
        for ds in (jc, pc, port_on_jax, jax_on_port):
            ds.set_epoch(epoch)
        for i in range(NIMG):
            want = jc[i]
            for ds in (pc, port_on_jax, jax_on_port):
                got = ds[i]
                assert set(got) == set(want)
                for k in want:
                    if k == "name":
                        assert got[k] == want[k]
                    else:
                        np.testing.assert_array_equal(got[k], want[k],
                                                      err_msg=k)
        np.testing.assert_array_equal(pc.get_batch([0, 2])["env_gt"],
                                      jc.get_batch([0, 2])["env_gt"])


def test_build_cache_cli(dataset, tmp_path, capsys):
    """``build_cache`` builds one shard dir (the fixture's TRAIN and TEST
    lists name the same scene, and the phase is not in the signature),
    builds nothing the second time, and ``make_loader --itemCache`` reads
    it; ``--itemCacheHalf`` builds its own."""
    cache = str(tmp_path / "cache")
    argv = ["--dataRoot", dataset, "--device", "cpu",
            "--imHeight", str(IM_HW[0]), "--imWidth", str(IM_HW[1]),
            "--envRow", str(ENV_RC[0]), "--envCol", str(ENV_RC[1]),
            "--numWorkers", "0", "--batchSize", "1", "--itemCache", cache,
            "--light"]
    build_cache.main(argv)
    dirs = set(os.listdir(cache))
    assert len(dirs) == 1
    out = capsys.readouterr().out
    assert "TRAIN: 3 items" in out and "built" in out
    build_cache.main(argv)
    assert set(os.listdir(cache)) == dirs
    assert capsys.readouterr().out.count("reused existing") == 2

    opt = build_cache.parse_args(argv)
    loader = common.make_loader(opt, "TRAIN", is_light=True)
    assert isinstance(loader.ds, CachedOpenRoomsDataset)
    assert loader.ds.reused and osp.basename(loader.ds.dir) in dirs
    assert loader.mode == "thread"
    opt.itemCacheHalf = True
    loader = common.make_loader(opt, "TRAIN", is_light=True)
    assert loader.ds.half and osp.basename(loader.ds.dir) not in dirs


KILLED_BUILD = """
import sys
import time
from inverserenderingofindoorscene_torch.data import cache as C
from inverserenderingofindoorscene_torch.data.openrooms import OpenRoomsDataset
C.CachedOpenRoomsDataset._BUILD_CHUNK = 3
ds = OpenRoomsDataset(sys.argv[1], im_hw=(64, 64), env_rc=(32, 32),
                      is_light=True, is_all_light=True, seed=5)
orig = ds.load_raw
ds.load_raw = lambda i: (time.sleep(0.25), orig(i))[1]
C.CachedOpenRoomsDataset(ds, sys.argv[2], workers=1)
"""


def test_cache_build_kill_resume(dataset, tmp_path):
    """A SIGKILLed build resumes from its bitmap (rows flushed before
    their bytes): ``meta.json`` appears only at the end, only the
    missing rows are decoded again, and the resumed cache keeps the
    contract."""
    # 12 items: the fixture's files hard-linked into four scenes
    root = str(tmp_path / "tree")
    src = osp.join(dataset, "main_xml", "scene0001")
    names = []
    for sidx in range(4):
        rel = "scene%04d" % sidx
        names.append(rel)
        dst = osp.join(root, "main_xml", rel)
        os.makedirs(dst)
        for f in os.listdir(src):
            os.link(osp.join(src, f), osp.join(dst, f))
    with open(osp.join(root, "train.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    with open(osp.join(root, "test.txt"), "w") as f:
        f.write(names[0] + "\n")

    cache = str(tmp_path / "cache")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.Popen([sys.executable, "-c", KILLED_BUILD, root, cache],
                         cwd=ROOT, env=env)
    bpath = None
    try:
        deadline = time.time() + 120
        while time.time() < deadline and p.poll() is None:
            if bpath is None and osp.isdir(cache):
                for d in os.listdir(cache):
                    q = osp.join(cache, d, "built.u8")
                    if osp.isfile(q):
                        bpath = q
            if bpath and osp.getsize(bpath) > 0:
                bits = np.fromfile(bpath, np.uint8)
                if 3 <= bits.sum() < len(bits):
                    break
            time.sleep(0.05)
    finally:
        p.kill()  # this child alone
        p.wait()
    assert bpath is not None, "the build never started"
    bits = np.fromfile(bpath, np.uint8)
    assert 0 < bits.sum() < 12, int(bits.sum())
    shard = osp.dirname(bpath)
    assert not osp.isfile(osp.join(shard, "meta.json"))

    calls = []
    ds = OpenRoomsDataset(root, im_hw=IM_HW, env_rc=ENV_RC, is_light=True,
                          is_all_light=True, seed=5)
    orig = ds.load_raw
    ds.load_raw = lambda i: (calls.append(i), orig(i))[1]
    cached = CachedOpenRoomsDataset(ds, cache)
    assert cached.dir == shard and not cached.reused
    assert osp.isfile(osp.join(shard, "meta.json"))
    # row 0 is read again for the shapes; the durable rows are skipped
    assert set(calls) - {0} == set(np.flatnonzero(bits == 0)) - {0}, calls

    direct = OpenRoomsDataset(root, im_hw=IM_HW, env_rc=ENV_RC,
                              is_light=True, is_all_light=True, seed=5)
    for i in range(len(direct)):
        assert_contract(cached[i], direct[i])
