"""The port's native RGBE decoder (``native/rgbe_decode.c``, a byte copy of
the JAX package's) against cv2 and against the JAX package's library.

Mirrors ``tests/test_native_hdr.py`` on the port's copy: the full decode
is bit-equal to ``cv2.imread``, the pooled decode matches the numpy pool,
malformed files raise, the ABI guard refuses a mismatched library and a
long header decodes.  Beside them, the two packages' pooled decodes are
bit-equal.  The library builds with the system C compiler into
``build/torch_native/``.
"""

import numpy as np
import pytest

from inverserenderingofindoorscene_torch.native import hdr


@pytest.fixture(autouse=True)
def _native():
    if not hdr.native_available():
        pytest.skip("no C compiler for the native library")


def _write_hdr(tmp_path, img_rgb, name="t.hdr"):
    cv2 = pytest.importorskip("cv2")
    p = str(tmp_path / name)
    assert cv2.imwrite(p, img_rgb[:, :, ::-1])  # cv2 takes BGR
    return p


@pytest.mark.parametrize("kind", ["random", "smooth", "constant", "runs"])
def test_full_decode_matches_cv2(tmp_path, kind):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(0)
    h, w = 48, 96
    if kind == "random":  # all-literal RLE streams
        img = rng.rand(h, w, 3).astype(np.float32) * 5
    elif kind == "smooth":  # mixed runs and literals
        img = np.tile(
            np.linspace(0, 4, w, dtype=np.float32)[None, :, None], (h, 1, 3)
        )
    elif kind == "constant":  # long runs
        img = np.full((h, w, 3), 0.25, np.float32)
    else:  # piecewise runs with zeros (the E == 0 path)
        img = np.repeat(
            rng.rand(h, w // 8, 3).astype(np.float32) * 3, 8, axis=1
        )
        img[:, :16] = 0.0
    p = _write_hdr(tmp_path, img)
    np.testing.assert_array_equal(hdr.decode_rgbe(p), cv2.imread(p, -1))


def test_pooled_decode_matches_numpy_pool(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(1)
    r, c, eh0, ew0, eh, ew = 6, 10, 16, 32, 8, 16
    img = rng.rand(r * eh0, c * ew0, 3).astype(np.float32) * 4
    p = _write_hdr(tmp_path, img)

    env = cv2.imread(p, -1)
    e = env.reshape(r, eh0, c, ew0, 3).transpose(0, 2, 1, 3, 4)
    e = e.reshape(r, c, eh, 2, ew, 2, 3).mean(axis=(3, 5))
    ref = np.ascontiguousarray(e.reshape(r, c, eh * ew, 3)).astype(
        np.float32
    )

    got = hdr.decode_rgbe_pooled(p, r, c, eh0, ew0, eh, ew)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)

    got2 = hdr.decode_rgbe_pooled(p, r, c, eh0, ew0, eh, ew, scale=0.37)
    np.testing.assert_allclose(got2, ref * np.float32(0.37), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("scale", [1.0, 0.37])
def test_pooled_decode_bit_equal_to_jax_package(tmp_path, scale):
    """The port's library and the JAX package's, built from the same
    source, decode the same file to the same bits."""
    from inverserenderingofindoorscene_tpu.native import hdr as jhdr

    if not jhdr.native_available():
        pytest.skip("the JAX package's native library did not build")
    rng = np.random.RandomState(2)
    r, c = 5, 7
    img = rng.rand(r * 16, c * 32, 3).astype(np.float32) * 6
    p = _write_hdr(tmp_path, img)
    got = hdr.decode_rgbe_pooled(p, r, c, 16, 32, 8, 16, scale)
    want = jhdr.decode_rgbe_pooled(p, r, c, 16, 32, 8, 16, scale)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(hdr.decode_rgbe(p), jhdr.decode_rgbe(p))


def test_malformed_raises(tmp_path):
    p = str(tmp_path / "bad.hdr")
    with open(p, "wb") as f:
        f.write(b"#?RADIANCE\n\n-Y 16 +X 32\n\x02\x02\x00")
    with pytest.raises(ValueError):
        hdr.decode_rgbe_pooled(p, 1, 1, 16, 32, 8, 16)
    with open(p, "wb") as f:
        f.write(b"not an hdr at all")
    with pytest.raises(ValueError):
        hdr.decode_rgbe(p)


def test_abi_guard_refuses_mismatched_binary(monkeypatch):
    """A library whose embedded ABI version differs from ``hdr._ABI`` is
    refused (``native_available()`` False), never called through
    mismatched argtypes."""
    monkeypatch.setattr(hdr, "_lib", None)
    monkeypatch.setattr(hdr, "_tried", False)
    monkeypatch.setattr(hdr, "_ABI", hdr._ABI + 1)
    assert not hdr.native_available()
    with pytest.raises(RuntimeError):
        hdr.decode_rgbe("unused.hdr")
    # and with the real version it loads again
    monkeypatch.setattr(hdr, "_ABI", hdr._ABI - 1)
    monkeypatch.setattr(hdr, "_lib", None)
    monkeypatch.setattr(hdr, "_tried", False)
    assert hdr.native_available()


def test_long_header_decodes(tmp_path):
    """Headers longer than 2 KiB parse (the size comes from the C
    parser)."""
    cv2 = pytest.importorskip("cv2")
    img = np.full((8, 16, 3), 0.5, np.float32)
    p = _write_hdr(tmp_path, img)
    with open(p, "rb") as f:
        buf = f.read()
    nl = buf.index(b"\n") + 1
    pad = b"".join(b"# comment line %d\n" % i for i in range(200))
    assert len(pad) > 2048
    p2 = str(tmp_path / "long.hdr")
    with open(p2, "wb") as f:
        f.write(buf[:nl] + pad + buf[nl:])
    np.testing.assert_array_equal(hdr.decode_rgbe(p2), cv2.imread(p2, -1))


def test_library_named_by_source_hash():
    """The library lives under build/torch_native/, named by a hash of the
    source and flags, so a changed source builds a new one."""
    path = hdr.library_path()
    assert path.parent.name == "torch_native"
    assert path.parent.parent.name == "build"
    assert path.name.startswith("rgbe_decode-") and path.suffix == ".so"
    assert path.is_file()
