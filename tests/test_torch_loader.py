"""The port's native C++ JPEG loader (CPU), mirroring ``tests/test_native_loader.py``.

- PIL parity: mean |native - PIL| < 1.5 and the 99th percentile <= 6 (of
  255) on resized JPEGs; exactly PIL's bytes where no resize happens (the
  same libjpeg decode under PIL);
- a missing file raises ``FileNotFoundError`` and a corrupt one
  ``ValueError``, as the PIL path does;
- the build for a host without libjpeg's development files (the kept
  ABI-62 headers against the libjpeg of Pillow's wheel) decodes as PIL
  does, exactly without a resize;
- ``FeatureExtractor`` and ``Trainer`` decode a batch of ``.jpg`` paths
  through the loader and anything else through PIL, and a loader that
  cannot build leaves PIL in place with the compilers' messages kept.

The tests that call the library skip, as the JAX package's do, when it
cannot build on the host (no ``g++`` or no libjpeg); the decision is made
in a fixture, not at import.
"""

import time
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from daliid_tpu.augment.preprocess import decode_resize as jax_decode_resize
from daliid_tpu_torch.augment import preprocess
from daliid_tpu_torch.data import native_loader
from daliid_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_jpegs")
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate([(64, 48), (128, 64), (37, 23), (256, 128)]):
        # smooth content (JPEG-friendly) so decode differences stay small
        y = np.linspace(0, 255, h)[:, None, None]
        x = np.linspace(0, 255, w)[None, :, None]
        c = np.linspace(0, 255, 3)[None, None, :]
        img = ((y + x + c) / 3 + rng.normal(0, 4, (h, w, 3))).clip(0, 255).astype(np.uint8)
        p = d / f"img{i}.jpg"
        Image.fromarray(img).save(p, quality=95)
        paths.append(str(p))
    return paths


@pytest.fixture(scope="module")
def lib():
    if not native_loader.native_loader_available():
        pytest.skip(f"native loader could not build: {native_loader.build_error()}")


def test_matches_pil_closely(lib, jpegs):
    h, w = 64, 32
    native = native_loader.decode_resize_batch(jpegs, h, w)
    pil = np.stack([preprocess.decode_resize(p, h, w) for p in jpegs])
    assert native.shape == pil.shape == (len(jpegs), h, w, 3) and native.dtype == np.uint8
    diff = np.abs(native.astype(np.int32) - pil.astype(np.int32))
    assert diff.mean() < 1.5, f"mean abs diff {diff.mean():.2f}"
    assert np.percentile(diff, 99) <= 6


def test_no_resize_is_exact(lib, jpegs):
    native = native_loader.decode_resize_batch([jpegs[3]], 256, 128)[0]
    np.testing.assert_array_equal(native, preprocess.decode_resize(jpegs[3], 256, 128))
    np.testing.assert_array_equal(native, jax_decode_resize(jpegs[3], 256, 128))


def test_missing_file_raises(lib, jpegs):
    with pytest.raises(FileNotFoundError, match="nonexistent"):
        native_loader.decode_resize_batch([jpegs[0], "/nonexistent.jpg"], 32, 16)


def test_corrupt_file_raises(lib, tmp_path):
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg at all")
    with pytest.raises(ValueError, match="bad.jpg"):
        native_loader.decode_resize_batch([str(bad)], 32, 16)


def test_many_images_threaded(lib, jpegs):
    t0 = time.time()
    out = native_loader.decode_resize_batch(jpegs * 32, 64, 32, num_threads=8)
    assert out.shape == (128, 64, 32, 3)
    np.testing.assert_array_equal(out[4:8], out[:4])
    assert time.time() - t0 < 10.0


def test_library_builds_in_the_ignored_build_directory(lib):
    name = native_loader.linked()
    path = next(native_loader.library_path(n, key)
                for n, _, key in native_loader.link_variants() if n == name)
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert _build.BUILD_DIR == REPO / "build" / "daliid_tpu_torch"
    assert "build/" in (REPO / ".gitignore").read_text().split()
    assert not list(native_loader.SRC.parent.rglob("*.so"))  # nothing in the package


def _fresh_loader(monkeypatch, tmp_path):
    """The loader as in a new process, building into ``tmp_path``."""
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_linked", None)
    monkeypatch.setattr(native_loader, "_error", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")


def test_pillow_libjpeg_build_matches_pil(monkeypatch, tmp_path, jpegs):
    """The build for a host without libjpeg's development files: the kept
    ABI-62 headers against the libjpeg in Pillow's wheel decode exactly as
    PIL does without a resize, and within the parity bounds with one."""
    pillow = [v for v in native_loader.link_variants() if v[0] == "pillow"]
    if not pillow:
        pytest.skip("this Pillow ships no libjpeg of its own")
    _fresh_loader(monkeypatch, tmp_path)
    monkeypatch.setattr(native_loader, "link_variants", lambda: pillow)
    if not native_loader.native_loader_available():
        pytest.skip(f"g++ could not build here: {native_loader.build_error()}")
    assert native_loader.linked() == "pillow"
    exact = native_loader.decode_resize_batch([jpegs[3]], 256, 128)[0]
    np.testing.assert_array_equal(exact, preprocess.decode_resize(jpegs[3], 256, 128))
    resized = native_loader.decode_resize_batch(jpegs, 64, 32)
    pil = np.stack([preprocess.decode_resize(p, 64, 32) for p in jpegs])
    diff = np.abs(resized.astype(np.int32) - pil.astype(np.int32))
    assert diff.mean() < 1.5 and np.percentile(diff, 99) <= 6


def _recording_loader(monkeypatch):
    calls = []

    def fake(paths, height, width, num_threads=16):
        calls.append(list(paths))
        return np.full((len(paths), height, width, 3), 7, np.uint8)

    monkeypatch.setattr(native_loader, "native_loader_available", lambda: True)
    monkeypatch.setattr(native_loader, "decode_resize_batch", fake)
    return calls


def test_extractor_and_trainer_pick_the_loader_for_jpegs(monkeypatch, tmp_path, jpegs):
    """Every path a JPEG: the loader; a PNG among them: PIL for the batch."""
    from daliid_tpu_torch.eval.features import FeatureExtractor
    from daliid_tpu_torch.train.trainer import Trainer

    calls = _recording_loader(monkeypatch)
    extractor = FeatureExtractor.__new__(FeatureExtractor)
    extractor.img_size, extractor.decode_workers = (32, 16), 2
    trainer = Trainer.__new__(Trainer)
    trainer.img_size, trainer.decode_workers = (32, 16), 2
    png = str(tmp_path / "x.png")
    Image.fromarray(np.zeros((8, 4, 3), np.uint8)).save(png)
    upper = str(tmp_path / "X.JPEG")
    Image.open(jpegs[0]).save(upper)
    for decode in (extractor._decode_paths, trainer._decode_batch):
        calls.clear()
        assert (decode(jpegs[:2] + [upper]) == 7).all()
        assert calls == [jpegs[:2] + [upper]]
        mixed = decode(jpegs[:1] + [png])
        assert calls == [jpegs[:2] + [upper]] and mixed.shape == (2, 32, 16, 3)
        np.testing.assert_array_equal(mixed[1], 0)  # PIL decoded the black PNG


def test_a_loader_that_cannot_build_leaves_pil_with_the_compilers_message(
        monkeypatch, tmp_path, jpegs):
    broken = tmp_path / "loader.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "SRC", broken)
    _fresh_loader(monkeypatch, tmp_path)
    assert not native_loader.native_loader_available() and native_loader.linked() is None
    err = native_loader.build_error()
    assert err and err.startswith("system libjpeg: ") and ("g++" in err or "No such" in err), err
    with pytest.raises(RuntimeError, match="unavailable"):
        native_loader.decode_resize_batch(jpegs[:1], 32, 16)
    got = preprocess.decode_images(jpegs[:2], 32, 16, 2)
    want = np.stack([preprocess.decode_resize(p, 32, 16) for p in jpegs[:2]])
    np.testing.assert_array_equal(got, want)
    assert not list((tmp_path / "build").glob("*.so"))
