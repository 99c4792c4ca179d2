"""The port's HDF5 codec (``utils/h5.py``) against h5py, the oracle.

The cascade hand-off's files are one LZF ``data`` dataset each.  The
port writes them without h5py, so here:

* its bytes equal h5py's for every shape the hand-off writes: the full
  size (240x320 maps, 120x160 diffuse / specular, the 84x120x160 SG
  tensor whose 256 chunks need a two-level chunk B-tree), the export
  test's 64x64 maps with their 32x32 lighting grid, and odd shapes whose
  partial edge chunks libhdf5's chunk cache writes out late; on constant,
  smooth, seeded uniform data, and a mix of chunks stored raw (LZF does
  not shrink them) and compressed;
* files that h5py and the JAX package's ``write_h5`` wrote read back
  bit-equal, and a round trip is exact in float32 and float64;
* a file of another form raises, naming what the reader lacks;
* on data quantised to a few values, where h5py's LZF reads stale hash
  entries (the module says why), each side reads the other's file to the
  same array.
"""

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from h5py._hl.filters import guess_chunk as h5py_guess_chunk  # noqa: E402

from inverserenderingofindoorscene_tpu.utils import io as jio  # noqa: E402
from inverserenderingofindoorscene_torch.utils import h5, io  # noqa: E402

# The hand-off's files at full size ([C, H, W] as stored): albedo /
# normal, rough / depth, the SG tensor, diffuse / specular; then the
# export test's 64x64 image with its 32x32 lighting grid.
FULL = [(3, 240, 320), (1, 240, 320), (84, 120, 160), (3, 120, 160),
        (84, 60, 80)]
SMALL = [(3, 64, 64), (1, 64, 64), (84, 32, 32), (3, 32, 32)]
# partial edge chunks in every dimension; 1-d, 2-d and 4-d
ODD = [(127, 102, 54), (56, 163, 134), (300, 700), (17,), (2, 3, 4, 5)]
KINDS = ("constant", "smooth", "uniform", "mixed")


def make(shape, kind, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    if kind == "constant":
        return np.full(shape, 0.25, dtype)
    if kind == "smooth":
        return np.linspace(-1.0, 3.0, n).reshape(shape).astype(dtype)
    a = rng.random(shape).astype(dtype)
    if kind == "uniform":
        return a
    # mixed: each chunk zeros, a constant, a ramp or uniform noise, so
    # that some chunks are stored raw and some compressed
    chunks = h5.guess_chunk(shape, np.dtype(dtype).itemsize)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for i, index in enumerate(np.ndindex(*grid)):
        sl = tuple(slice(j * c, (j + 1) * c) for j, c in zip(index, chunks))
        pick = i % 4
        if pick == 0:
            a[sl] = 0.0
        elif pick == 1:
            a[sl] = 1.5
        elif pick == 2:
            a[sl] = np.linspace(0, 1, a[sl].size).reshape(a[sl].shape)
    return a


def h5py_bytes(tmp_path, arr):
    path = tmp_path / "h5py.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=arr, compression="lzf")
    return path.read_bytes()


def chunk_masks(path):
    """{filter mask: count} over the chunks of ``path`` (h5py)."""
    with h5py.File(path, "r") as f:
        d = f["data"].id
        masks = [d.get_chunk_info(i).filter_mask
                 for i in range(d.get_num_chunks())]
    return {m: masks.count(m) for m in set(masks)}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", FULL + SMALL, ids=str)
def test_handoff_bytes_equal_h5py(tmp_path, shape, kind):
    arr = make(shape, kind)
    mine = h5.encode(arr)
    assert mine == h5py_bytes(tmp_path, arr)
    if kind == "mixed" and np.prod(shape) > 100_000:
        path = tmp_path / "port.h5"
        path.write_bytes(mine)
        masks = chunk_masks(path)
        assert masks.get(0) and masks.get(1), masks  # LZF and raw chunks


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", ODD, ids=str)
def test_edge_chunks_and_ranks_bytes_equal_h5py(tmp_path, shape, kind):
    arr = make(shape, kind, seed=1)
    assert h5.encode(arr) == h5py_bytes(tmp_path, arr)


def test_sg_tensor_index_has_two_levels(tmp_path):
    """The full-size SG tensor's 256 chunks: leaves of 57 (libhdf5's
    right split) under one root, as h5py writes them."""
    arr = make((84, 120, 160), "uniform", seed=2)
    path = tmp_path / "sg.h5"
    h5.write(path, arr)
    f = h5._File(path.read_bytes(), path)
    root = h5.CHUNK_ROOT
    level, n = f.at("<BH", root + 5)
    assert (level, n) == (1, 5)
    assert len(f.chunks(root, 3)) == 256
    assert path.read_bytes() == h5py_bytes(tmp_path, arr)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_float64_and_round_trip(tmp_path, dtype):
    for shape in ((3, 120, 160), (84, 60, 80), (5,)):
        arr = make(shape, "uniform", seed=3, dtype=dtype)
        arr.flat[::7] = 0.0
        path = tmp_path / "x.h5"
        h5.write(path, arr)
        back = h5.read(path)
        assert back.dtype == arr.dtype and np.array_equal(back, arr)
        assert path.read_bytes() == h5py_bytes(tmp_path, arr)


@pytest.mark.parametrize("layout", ["lzf", "contiguous", "chunked"])
@pytest.mark.parametrize("shape", [(84, 120, 160), (3, 240, 320),
                                   (127, 102, 54)], ids=str)
def test_reads_h5py_files(tmp_path, shape, layout):
    arr = make(shape, "mixed", seed=4)
    path = tmp_path / "h5py.h5"
    kw = {"lzf": {"compression": "lzf"}, "contiguous": {},
          "chunked": {"chunks": True}}[layout]
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=arr, **kw)
    back = h5.read(path)
    assert back.dtype == arr.dtype and np.array_equal(back, arr)


@pytest.mark.parametrize("hwc", [(240, 320, 3), (120, 160, 84),
                                 (64, 64, 1)], ids=str)
def test_reads_jax_files(tmp_path, hwc):
    """The JAX package's ``write_h5`` (h5py) read by the port's
    ``read_h5``, both orders, bit-equal."""
    arr = np.random.default_rng(5).random(hwc).astype(np.float32)
    path = str(tmp_path / "jax.h5")
    jio.write_h5(arr, path)
    for flag in (True, False):
        np.testing.assert_array_equal(io.read_h5(path, flag),
                                      jio.read_h5(path, flag))
    np.testing.assert_array_equal(io.read_h5(path), arr)
    io.write_h5(arr, str(tmp_path / "port.h5"))
    assert (tmp_path / "port.h5").read_bytes() == \
        (tmp_path / "jax.h5").read_bytes()


@pytest.mark.parametrize("shape", [(3, 240, 320), (84, 60, 80)], ids=str)
def test_quantised_data_reads_both_ways(tmp_path, shape):
    """Values on a 1/16 grid: h5py's bytes may differ from the port's
    (stale LZF hash entries); each reads the other's file exactly."""
    arr = (np.round(make(shape, "uniform", seed=6) * 16) / 16).astype(
        np.float32)
    port = tmp_path / "port.h5"
    h5.write(port, arr)
    with h5py.File(port, "r") as f:
        np.testing.assert_array_equal(f["data"][()], arr)
    h5py_bytes(tmp_path, arr)
    np.testing.assert_array_equal(h5.read(tmp_path / "h5py.h5"), arr)


@pytest.mark.parametrize("typesize", [4, 8])
def test_guess_chunk_is_h5pys(typesize):
    rng = np.random.default_rng(7)
    shapes = FULL + SMALL + ODD + [
        tuple(int(x) for x in rng.integers(1, 3000, size=rng.integers(1, 5)))
        for _ in range(200)]
    for shape in shapes:
        assert h5.guess_chunk(shape, typesize) == h5py_guess_chunk(
            shape, None, typesize), shape


def test_lzf_round_trip_and_limit():
    rng = np.random.default_rng(8)
    for data in (bytes(1000), bytes(rng.integers(0, 4, 9000, np.uint8)),
                 rng.bytes(300) * 40):
        packed = h5.lzf_compress(data, len(data))
        assert packed is not None and len(packed) < len(data)
        assert h5.lzf_decompress(packed, len(data)) == data
    noise = rng.bytes(4096)
    assert h5.lzf_compress(noise, len(noise)) is None  # does not fit
    with pytest.raises(h5.H5FormatError, match="does not decode"):
        h5.lzf_decompress(b"\x05abc", 6)


def refusal(tmp_path, make_file):
    path = tmp_path / "other.h5"
    make_file(path)
    with pytest.raises(h5.H5FormatError) as err:
        h5.read(path)
    return str(err.value)


def test_refuses_other_filters(tmp_path):
    def gzip(path):
        with h5py.File(path, "w") as f:
            f.create_dataset("data", data=np.ones((40, 40), np.float32),
                             compression="gzip")
    assert "filter 1 (deflate (gzip)" in refusal(tmp_path, gzip)

    def shuffle(path):
        with h5py.File(path, "w") as f:
            f.create_dataset("data", data=np.ones((40, 40), np.float32),
                             compression="lzf", shuffle=True)
    assert "filter 2 (shuffle" in refusal(tmp_path, shuffle)


def test_refuses_other_superblocks(tmp_path):
    def latest(path):
        with h5py.File(path, "w", libver="latest") as f:
            f.create_dataset("data", data=np.ones(3, np.float32),
                             compression="lzf")
    assert "superblock version 3 (this reader takes version 0)" in \
        refusal(tmp_path, latest)


def test_refuses_several_datasets_and_other_types(tmp_path):
    def two(path):
        with h5py.File(path, "w") as f:
            f.create_dataset("data", data=np.ones(3, np.float32))
            f.create_dataset("more", data=np.ones(3, np.float32))
    assert "objects ['data', 'more']" in refusal(tmp_path, two)

    def ints(path):
        with h5py.File(path, "w") as f:
            f.create_dataset("data", data=np.ones(3, np.int32))
    assert "32-bit integer datatype" in refusal(tmp_path, ints)

    def big_endian(path):
        with h5py.File(path, "w") as f:
            f.create_dataset("data", data=np.ones(3, ">f4"))
    assert "big-endian float32" in refusal(tmp_path, big_endian)
    with pytest.raises(h5.H5FormatError, match="dtype int32"):
        h5.encode(np.ones(3, np.int32))
