"""What the port isolates on the host: an image that PIL refuses as a
decompression bomb, a truncated HTTP reply, and the build of the host NMS
library (``native.py``) by concurrent processes, which never touches the
JAX package's ``native/librodc_native.so``."""

import http.client
import multiprocessing
import os

import numpy as np
import pytest
import torch
from PIL import Image

from rapidobjectdetectionusingcascadedcnns_torch import labels, native
from rapidobjectdetectionusingcascadedcnns_torch.apps import inference_apps as tapps
from rapidobjectdetectionusingcascadedcnns_torch.data.image_io import ImageInfo
from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as tcascade
from rapidobjectdetectionusingcascadedcnns_torch.utils import file_handler

import torch_parity as tp
from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LIBRARY = os.path.join(REPO, "native", "librodc_native.so")


@pytest.mark.parametrize("merge", [True, False])
def test_decompression_bomb_gives_an_empty_result(tmp_path, monkeypatch, merge):
    """With ``Image.MAX_IMAGE_PIXELS`` at 1,000, a 100x100 PNG is a
    decompression bomb (over twice the limit): the app gives it an empty
    result beside a readable image's, and ``is_loadable`` is False."""
    tp.configure(cascade_n_nets=2, img_width=24, window_scale_factor=1.25)
    model = tcascade.build_cascade_model(seed=0, device="cpu")
    path = str(tmp_path / "bomb.png")
    Image.fromarray(np.full((100, 100, 3), 128, np.uint8)).save(path)
    monkeypatch.setattr(Image, "MAX_IMAGE_PIXELS", 1000)
    bomb = ImageInfo(path, labels.get_by_key("foreground"), "test")
    with pytest.raises(Image.DecompressionBombError):
        Image.open(path).load()
    assert not bomb.is_loadable()
    app = tapps.InferenceCascadeApp(model=model, device="cpu")
    readable = np.full((40, 48, 3), 90, np.uint8)
    results = app.run_inference_on_images([bomb, readable], merge=merge)
    assert len(results) == 2
    assert len(results[0].boxes) == 0 and results[0].n_windows == 0
    assert results[1].n_windows > 0


def test_truncated_http_reply_gives_none(monkeypatch):
    """``fetch_url`` returns None when the reply is cut short
    (``IncompleteRead``) or garbled (``BadStatusLine``), both
    ``HTTPException`` and not ``OSError``."""
    import urllib.request

    for exc in (http.client.IncompleteRead(b"partial", 100), http.client.BadStatusLine("x")):
        def urlopen(*args, exc=exc, **kwargs):
            raise exc

        monkeypatch.setattr(urllib.request, "urlopen", urlopen)
        assert file_handler.fetch_url("http://localhost:1/none") is None


def _build_and_call(build_dir):
    """In a fresh process: build (or find) the library in ``build_dir``,
    load it and group two overlapping rectangles."""
    import ctypes

    path = native.build(build_dir)
    lib = ctypes.CDLL(path)
    rects = np.array([[0, 0, 10, 10], [1, 1, 10, 10]], np.float64)
    out_xywh = np.zeros((2, 4), np.int64)
    out_w = np.zeros(2, np.int64)
    lib.rodc_group_rectangles.restype = ctypes.c_int32
    kept = lib.rodc_group_rectangles(
        rects.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), ctypes.c_int32(2),
        ctypes.c_int32(1), ctypes.c_double(0.2),
        out_xywh.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_w.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return path, int(kept), out_w[:kept].tolist()


def test_concurrent_builds_all_load(tmp_path):
    """Four processes build the library into one empty directory at once:
    each loads a whole library and runs it; one file remains, and no
    temporary."""
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(4) as pool:
        results = pool.map(_build_and_call, [str(tmp_path)] * 4)
    assert len({path for path, _, _ in results}) == 1
    assert all(kept == 1 and weights == [2] for _, kept, weights in results)
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".so")) == [
        os.path.basename(results[0][0])]
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_port_never_writes_the_jax_library():
    """The port builds into its own ``_build`` directory: loading it leaves
    ``native/librodc_native.so`` as it was (absent or untouched)."""
    before = os.stat(JAX_LIBRARY).st_mtime_ns if os.path.exists(JAX_LIBRARY) else None
    path = native.library_path()
    assert os.path.dirname(path) == native.BUILD_DIR != os.path.dirname(JAX_LIBRARY)
    assert native.available()
    assert native.group_rectangles(np.array([[0, 0, 10, 10]], float), 0)[1].tolist() == [1]
    after = os.stat(JAX_LIBRARY).st_mtime_ns if os.path.exists(JAX_LIBRARY) else None
    assert after == before
