"""Port vs JAX: the Viola-Jones baseline (host numpy in both packages).

The port keeps its own copy of ``ops/viola_jones.py``; the same pretrained
XML and the same images must give the same results. Tolerance: none —
parsed arrays, detected rectangles and their neighbour counts, the
``InferenceOCVApp`` results and the background sampler's face boxes are
all equal.
"""

import os

import numpy as np
import pytest

from rapidobjectdetectionusingcascadedcnns_tpu import config as jcf
from rapidobjectdetectionusingcascadedcnns_tpu.apps import inference_apps as japps
from rapidobjectdetectionusingcascadedcnns_tpu.ops import sampling as jsampling
from rapidobjectdetectionusingcascadedcnns_tpu.ops import viola_jones as jvj
from rapidobjectdetectionusingcascadedcnns_torch import config as tcf
from rapidobjectdetectionusingcascadedcnns_torch.apps import inference_apps as tapps
from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
from rapidobjectdetectionusingcascadedcnns_torch.ops import sampling as tsampling
from rapidobjectdetectionusingcascadedcnns_torch.ops import viola_jones as tvj

from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

XML = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "opencv_data", "haarcascade_frontalface_default.xml")


def _scenes():
    """Two small synthetic scenes with faces, and one of noise."""
    a = synthetic.make_scene(120, 160, n_faces=1, seed=3, min_face=60, max_face=80).image
    b = synthetic.make_scene(140, 180, n_faces=2, seed=11, min_face=50, max_face=70).image
    noise = np.random.default_rng(0).integers(0, 256, size=(120, 160, 3)).astype(np.uint8)
    return {"scene": a, "two-faces": b, "noise": noise}


@pytest.fixture(scope="module")
def cascades():
    return jvj.parse_cascade_xml(XML), tvj.parse_cascade_xml(XML)


def test_parsed_xml_equal_to_jax(cascades):
    jc, tc = cascades
    assert tvj.default_cascade_path() == jvj.default_cascade_path()
    assert (tc.window_h, tc.window_w, tc.n_stages) == (jc.window_h, jc.window_w, jc.n_stages)
    for name in ("stage_thresholds", "stage_bounds", "stump_feature", "stump_threshold",
                 "stump_leaves", "feat_rects", "feat_weights"):
        got, ref = getattr(tc, name), getattr(jc, name)
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=name)


@pytest.mark.parametrize("name", ["scene", "two-faces", "noise"])
def test_detect_multi_scale_equal_to_jax(cascades, name):
    jc, tc = cascades
    image = _scenes()[name]
    gray = tvj.rgb_to_gray_u8(image)
    np.testing.assert_array_equal(gray, jvj.rgb_to_gray_u8(image))
    got, got_w = tvj.detect_multi_scale(tc, gray, 1.1, 1, return_weights=True)
    ref, ref_w = jvj.detect_multi_scale(jc, gray, 1.1, 1, return_weights=True)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got_w, ref_w)
    if name == "noise":
        assert len(tvj.detect_multi_scale(tc, gray, 1.1, 3)) == 0
    else:
        assert len(got) >= 1


def test_inference_ocv_app_matches_jax():
    """``InferenceOCVApp`` (no longer a stub that raises) gives the JAX
    app's boxes and confidences, image by image, in both merge modes."""
    for c in (jcf, tcf):
        c.set("window_scale_factor", 1.1)
        c.set("nms_opencv_min_neighbors", 1)
    images = list(_scenes().values())
    tapp = tapps.InferenceOCVApp(cascade_xml_path=XML)
    japp = japps.InferenceOCVApp(cascade_xml_path=XML)
    assert tapp.device.type == "cpu"
    for merge in (True, False):
        got = tapp.run_inference_on_images(images, merge=merge)
        ref = japp.run_inference_on_images(images, merge=merge)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.boxes, r.boxes)
            np.testing.assert_array_equal(g.confidences, r.confidences)
    assert len(got[0].boxes) >= 1 and len(got[2].boxes) == 0


def test_haar_face_detector_matches_jax():
    """``make_haar_face_detector`` picks the same detector (cv2's where the
    build has objdetect, else the in-repo evaluator) and gives the same
    xyxy boxes; without an XML both return None."""
    for c in (jcf, tcf):
        c.set("nms_opencv_min_neighbors", 1)
    tdet = tsampling.make_haar_face_detector(XML)
    jdet = jsampling.make_haar_face_detector(XML)
    assert tdet is not None and jdet is not None
    for image in _scenes().values():
        np.testing.assert_array_equal(tdet(image), jdet(image))
    missing = "/nonexistent/haar.xml"
    # the repo's vendored XML is found whatever path is given, so the
    # annotations-only fallback needs the lookup to come up empty
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tvj, "default_cascade_path", lambda explicit=None: None)
        mp.setattr(jvj, "default_cascade_path", lambda explicit=None: None)
        assert tsampling.make_haar_face_detector(missing) is None
        assert jsampling.make_haar_face_detector(missing) is None
