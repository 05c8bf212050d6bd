"""Shared helpers of the port-vs-JAX cascade tests (tests/test_torch_cascade*.py)."""

import numpy as np

from rapidobjectdetectionusingcascadedcnns_tpu import config as cf
from rapidobjectdetectionusingcascadedcnns_tpu.models import cascade as jcascade
from rapidobjectdetectionusingcascadedcnns_torch.models import bridge

# tests/test_golden.py's configuration: small nets, f32, NMS keeping singletons
GOLDEN_CFG = {
    "conv_filter_sizes": [8],
    "fc1_size": 32,
    "compute_dtype": "float32",
    "nms": cf.NMS_OPENCV,
    "nms_opencv_min_neighbors": 0,
    "foreground_confidence_threshold": 0.5,
    # the JAX package's CPU default; named so a TPU run compares like with like
    "use_pallas_resample": "xla",
}
PROB_TOL = 2e-3  # the e2e oracle's borderline band |p - threshold| (NOTES.md)
MAX_FLIP_FRACTION = 0.02  # borderline flips allowed, as a share of survivors


def configure(**extra):
    for key, value in {**GOLDEN_CFG, **extra}.items():
        cf.set(key, value)


def jax_and_port_models(seed=0):
    """The JAX ``build_cascade_model(seed)`` and its converted port copy."""
    jmodel = jcascade.build_cascade_model(seed=seed)
    tmodel = bridge.cascade_model_from_jax_arrays(
        jmodel.stage_params, jmodel.stage_configs, jmodel.stage_means, jmodel.stage_stds
    )
    return jmodel, tmodel


def assert_results_close(got, ref):
    """Same window count; survivor ids equal up to borderline flips (at most
    2% of survivors); confidences of common survivors within the borderline
    band; NMS boxes within 2 px."""
    assert got.n_windows == ref.n_windows
    ids_g = dict(zip(got.raw_window_ids.tolist(), got.raw_confidences.tolist()))
    ids_r = dict(zip(ref.raw_window_ids.tolist(), ref.raw_confidences.tolist()))
    flips = set(ids_g) ^ set(ids_r)
    assert len(flips) <= MAX_FLIP_FRACTION * max(len(ids_r), 1), sorted(flips)
    common = sorted(set(ids_g) & set(ids_r))
    if common:
        err = max(abs(ids_g[i] - ids_r[i]) for i in common)
        assert err < PROB_TOL, err
    assert len(got.boxes) == len(ref.boxes)
    if len(ref.boxes):
        np.testing.assert_allclose(
            np.asarray(sorted(map(tuple, got.boxes.tolist()))),
            np.asarray(sorted(map(tuple, ref.boxes.tolist()))),
            atol=2.0,
        )
