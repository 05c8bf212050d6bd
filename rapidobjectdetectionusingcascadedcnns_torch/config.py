"""Global configuration of the port (its own copy of the JAX package's
``config.py``: the same keys, defaults and constants, and the same
``get``/``set``/``reset``/``snapshot``/``restore``/``overrides`` surface).

The two packages keep separate configurations: setting a key here does not
change the JAX package's, and a test that runs both sets both.

Key-compatible with the reference's flag system (``cf.get/set/reset``,
reference config.py:603-625). Importing this module has no side effects
(directories are created lazily); a local overlay is merged from
``rodc_local.py`` on the path, and ``RODC_HOME`` roots the output tree.
Kernels never read this module: orchestration reads values once and passes
them as explicit arguments.
"""

from __future__ import annotations

import contextlib
import copy
import os
import secrets
import time
from typing import Any, Dict, Iterator

import numpy as np

# ---------------------------------------------------------------------------
# Named constants (same vocabulary as the reference, config.py:95-122,361-364,
# 425-428).
# ---------------------------------------------------------------------------

NMS_DISABLED = "NMS_DISABLED"
NMS_OPENCV = "NMS_OPENCV"  # groupRectangles-compatible clustering

FINAL_CONFIDENCE_CALCULATION_LAST_STEP = "FINAL_CONFIDENCE_CALCULATION_LAST_STEP"
FINAL_CONFIDENCE_CALCULATION_AVG = "FINAL_CONFIDENCE_CALCULATION_AVG"
FINAL_CONFIDENCE_CALCULATION_MULT = "FINAL_CONFIDENCE_CALCULATION_MULT"
MIN_SCORE_FOR_FINAL_CONFIDENCE_CALCULATION_MULT = 0.5001

OPTIMIZER_SGD = 0
OPTIMIZER_ADAM = 1
OPTIMIZER_MOMENTUM = 2

RESAMPLING_ADABOOST_LIKE = "RESAMPLING_ADABOOST_LIKE"
RESAMPLING_CONFIDENCE = "RESAMPLING_CONFIDENCE"
RESAMPLING_DEACTIVATED = "RESAMPLING_DEACTIVATED"

DAO_ROTATION_MODE_DISABLED = "DAO_ROTATION_MODE_DISABLED"
DAO_ROTATION_MODE_CONTINUOUS = "DAO_ROTATION_MODE_CONTINUOUS"
DAO_ROTATION_MODE_90 = "DAO_ROTATION_MODE_90"


def _new_session_key() -> str:
    """Timestamped unique session key (reference config.py:26-31)."""
    return "{}_{}".format(time.strftime("%Y-%m-%d_%H-%M-%S"), secrets.token_hex(3))


def _default_home() -> str:
    return os.environ.get("RODC_HOME", os.path.join(os.getcwd(), "rodc_output"))


def _build_defaults() -> Dict[str, Any]:
    """Default configuration; keys mirror reference config.py:58-480."""
    cf: Dict[str, Any] = {}

    cf["debug"] = False
    cf["session_key"] = _new_session_key()

    # ----- inference (reference config.py:64-122) -----
    cf["foreground_confidence_threshold"] = 0.5  # scalar or per-stage list
    cf["inference_merge"] = True
    cf["min_window_length"] = 0.075
    cf["window_scale_factor"] = 1.1
    cf["nms"] = NMS_OPENCV
    cf["nms_opencv_min_neighbors"] = 1
    # OpenCV groupRectangles eps (SimilarRects relative tolerance). 0.2 is
    # cv2's hardcoded default (what the reference uses implicitly). Exposed
    # because eps controls union-find CHAINING: bridge windows between two
    # nearby faces can merge both faces' clusters into one off-target
    # average (measured: benchmark scene 52 loses a face with IoU-0.848
    # surviving windows this way).
    cf["nms_opencv_eps"] = 0.2
    cf["default_evaluation_model_cascade"] = "cnn_cascade_for_face_detection"
    cf["default_evaluation_model_single"] = "single_cnn_for_face_detection"
    cf["vertically_enlarge_bboxes"] = False
    cf["multi_threaded_step_preparation"] = False
    cf["final_confidence_calculation"] = FINAL_CONFIDENCE_CALCULATION_LAST_STEP

    # fixed-capacity survivor buffers per cascade stage (the data-dependent
    # Python filtering of the reference becomes masked compaction on the
    # device). `None` => automatic heuristic from stage index.
    cf["cascade_capacity_schedule"] = None
    # When a stage fills its survivor capacity (truncation would drop real
    # windows), transparently re-run that image through a program variant
    # with doubled capacities — bounded retries — so detections always match
    # the reference's unbounded survivor sets
    # (app/inference_cascade_app.py:217-240 semantics).
    cf["cascade_saturation_redispatch"] = True
    cf["cascade_saturation_max_retries"] = 4
    cf["inference_chunk_size"] = 16384  # windows per stage-CNN chunk
    cf["inference_batch_frames"] = 16  # same-size frames fused per device call
    cf["inference_high_precision"] = False  # f32-exact window resampling
    cf["inference_pipeline_depth"] = 2  # frame chunks in flight per device
    cf["window_extraction_mode"] = "auto"  # auto | gather | crop
    # window resampling kernels (models/cascade.resolve_resample_impl):
    # "auto"/"pallas2" => K2 for the crop-mode stage 0, K1 for
    # re-extraction; "pallas" => K1 for both; "pallas2dyn" adds K4. The JAX
    # package's "xla" formulation has no counterpart in the port.
    cf["use_pallas_resample"] = "auto"  # auto | pallas | pallas2 | pallas2dyn
    # stage-0 scheduled (support-bounded) extraction, kernel K2
    # (ops/windows_sched.py); "off" drops to K1
    cf["stage0_scheduled_extraction"] = "auto"  # auto | on | off
    # dynamic row-bounded re-extraction of stage-1/2 survivor windows,
    # kernel K4 (ops/windows_dyn.py, needs pallas2); "auto" resolves to off
    cf["dyn_reextract"] = "auto"  # auto | on | off
    # survivor-buffer compaction between cascade stages: "rank" is a full
    # strength argsort (truncation keeps the strongest windows — required
    # semantics when saturation re-dispatch is off); "scan" is an O(n)
    # cumsum+searchsorted selection in window-enumeration order (the
    # reference's survivor order, inference_cascade_app.py:217-240) — a full
    # device sort of a 130k-window FDDB pyramid is pure waste when
    # re-dispatch already guarantees untruncated survivor sets. "auto"
    # follows cascade_saturation_redispatch.
    cf["cascade_compaction"] = "auto"  # auto | rank | scan
    cf["nms_on_device"] = False  # run groupRectangles inside the program
    cf["inference_resize_buckets"] = None  # [(h, w), ...], "auto", or None
    # FDDB corpora mix hundreds of image sizes; buckets bound the number of
    # compiled cascade programs for the dense-pyramid evaluation. "auto"
    # derives them from the corpus (k most common sizes — exact geometry for
    # the dominant sizes; data/fddb.derive_resize_buckets): round 4 measured
    # a static off-corpus list costing 0.06 detection rate.
    cf["fddb_resize_buckets"] = "auto"
    cf["compute_dtype"] = "bfloat16"  # matmul/conv dtype

    # ----- training (reference config.py:124-237) -----
    cf["batch_size"] = 1200
    cf["max_batch_size"] = cf["batch_size"]
    cf["epochs_total"] = 50
    cf["n_repeat_same_session"] = 1
    cf["snapshot_full_path"] = ""
    cf["restore_after"] = None
    cf["timeout_minutes"] = 0
    cf["log_auto_save"] = True
    cf["auto_save_on_abort"] = True
    cf["n_max_constant_evals"] = 3
    cf["learning_rate_init"] = 0.01
    cf["learning_rate_decay"] = 0.9
    cf["optimizer"] = OPTIMIZER_MOMENTUM
    cf["momentum"] = 0.9
    cf["dropout_rate"] = 0.5  # keep-probability semantics (1.0 => no dropout)
    cf["L2_regularization_strength"] = 0
    cf["L1_regularization_strength"] = 0
    cf["f_beta_default"] = None
    cf["f_beta_cascade_loss"] = True
    cf["f_beta_cascade_loss_very_last"] = False
    cf["min_beta"] = 1
    cf["max_beta"] = 24
    cf["cascade_max_same_beta"] = 3
    cf["weighted_cross_entropy"] = True
    cf["weighted_cross_entropy_normalize"] = False
    cf["tuning_main_criteria"] = "f1_score"
    cf["remove_broken_images_before_training"] = False
    cf["seed"] = 42  # global RNG seed policy
    # data-parallel training mesh: None/1 => single device; "all" => every
    # visible device; n => first n (not ported yet)
    cf["train_mesh_devices"] = None

    # ----- architecture (reference config.py:239-295) -----
    cf["fc1_size"] = 512
    cf["conv_filter_sizes"] = [32]
    # optional per-stage conv trunk widths for the cascade (list of
    # conv_filter_sizes lists, one per net); None => uniform
    # conv_filter_sizes (reference behavior, reference config.py:249)
    cf["conv_filter_sizes_per_stage"] = None
    cf["conv_stride"] = 1
    cf["conv_filter_size"] = 3
    cf["pooling_size"] = 3
    cf["pooling_stride"] = 1
    cf["cascade_n_nets"] = 3
    cf["cascade_increasing_input_dimensions"] = True
    cf["reuse_bottlenecks"] = True
    cf["append_inception"] = False
    cf["inception_weights_path"] = None  # optional local backbone weights

    # ----- data(sets) (reference config.py:299-398) -----
    cf["dataset_split"] = [0.8, 0.1, 0.1]
    cf["standardization"] = True
    cf["dataset_keys_annotated"] = ["aflw"]
    cf["cache_dataset"] = True
    cf["img_width"] = 48
    cf["img_height"] = 48
    cf["img_dtype"] = np.uint8
    cf["label_dtype"] = np.int32
    cf["class_min_images"] = 20000
    cf["class_max_images"] = None
    cf["max_samples"] = None
    cf["background_max_img_per_entity"] = 25
    cf["cascade_scale_patches_individually"] = True
    cf["cascade_scale_patches_individually_iff_not_cached"] = False
    cf["cascade_resampling_method"] = RESAMPLING_ADABOOST_LIKE
    cf["sampling_multiplier"] = 30
    cf["sampling_background_max_iou_with_foreground"] = 0.05
    cf["filter_dataset_after_caching"] = False
    cf["cache_resized_training_samples_individually"] = False
    cf["shuffle_datasets_inplace"] = False
    cf["shuffle_seed"] = 93452  # deterministic dataset shuffle (reference
    # data/db/dataset_loader.py:328-388)
    cf["dataset_keys"] = ["synthetic"]

    # ----- online augmentation (reference config.py:400-460) -----
    cf["data_augmentation_online"] = True
    cf["dao_horizontal_flip"] = True
    cf["dao_vertical_flip"] = False
    cf["dao_allow_vertical_flipping_of_foreground"] = False
    cf["dao_rotation_mode"] = DAO_ROTATION_MODE_CONTINUOUS
    cf["dao_max_rotation_angle"] = 0.0
    cf["dao_max_foreground_rotation_angle"] = 0.0
    cf["dao_crop_probability"] = 0.5
    cf["dao_crop_min_percent"] = 0.9
    cf["dao_color_distortion"] = True
    cf["dao_color_distortion_fast_mode"] = False

    # ----- other (reference config.py:462-480) -----
    cf["log_window_extraction_details"] = False
    cf["log_cascade_confidence_details"] = False
    cf["foreground_equals_face"] = True

    # ----- parallelism (new; reference has none, SURVEY.md §2.6) -----
    cf["mesh_data_axis"] = "data"  # batch/window sharding axis name
    cf["mesh_num_devices"] = None  # None => all visible devices

    # ----- paths (reference config.py:496-538), rooted at RODC_HOME -----
    home = _default_home()
    cf["project_extension_root"] = home
    cf["project_extension_root_fast"] = home
    _derive_paths(cf)

    return cf


def _derive_paths(cf: Dict[str, Any]) -> None:
    root = os.path.join(cf["project_extension_root"], "output")
    cf["output_root_dir"] = root
    cf["log_dir"] = os.path.join(root, "logs")
    cf["snapshot_dir"] = os.path.join(root, "snapshots")
    cf["summary_dir"] = os.path.join(root, "summaries")
    cf["collages_dir"] = os.path.join(root, "collages")
    cf["cache_path_root"] = os.path.join(cf["project_extension_root_fast"], "cache")
    cf["dataset_native_path_root"] = os.path.join(cf["project_extension_root"], "input")
    cf["dataset_presampled_path_root"] = os.path.join(root, "input_augmented")
    cf["dataset_path_root"] = cf["dataset_presampled_path_root"]
    cf["assets_root"] = os.path.join(root, "assets")
    cf["ignore_lists_dir"] = os.path.join(cf["assets_root"], "ignore-lists")
    cf["whitelists_dir"] = os.path.join(cf["assets_root"], "whitelists")
    cf["bbox_visualization_dir"] = os.path.join(root, "bbox_visualization")
    cf["output_graph_dir"] = os.path.join(root, "models")
    cf["fddb_root_dir"] = os.path.join(cf["dataset_native_path_root"], "fddb")
    cf["fddb_folds_dir"] = os.path.join(cf["fddb_root_dir"], "FDDB-folds")
    cf["fddb_img_base_dir"] = os.path.join(
        cf["fddb_root_dir"], "images/original/foreground"
    )
    cf["fddb_detection_output_dir"] = os.path.join(root, "fddb_detection_output")
    cf["fddb_latest_detection_output_dir"] = os.path.join(
        cf["fddb_detection_output_dir"], "latest"
    )
    cf["fddb_per_evaluation_script_path"] = os.path.join(
        cf["fddb_root_dir"], "evaluation_code/runEvaluate.pl"
    )
    cf["fddb_gnuplot_compare_dir"] = os.path.join(cf["fddb_root_dir"], "rocs")


def _derive_values(cf: Dict[str, Any]) -> None:
    """Values derived from others (reference config.py:567-582)."""
    cf["learning_rate_min"] = 0.1 * cf["learning_rate_init"]
    cf["timeout_seconds"] = cf["timeout_minutes"] * 60
    cf["img_width_max"] = cf["img_width"]
    cf["img_height_max"] = cf["img_height"]
    cf["max_batch_size_original"] = cf["max_batch_size"]


def _apply_local_overlay(cf: Dict[str, Any]) -> None:
    """Merge an optional ``rodc_local.py`` overlay (reference config.py:487-494)."""
    try:
        import rodc_local  # type: ignore

        overlay = getattr(rodc_local, "_cf", None) or getattr(rodc_local, "cf", {})
        for key, value in overlay.items():
            cf[key] = value
        # re-derive the path tree from (possibly overridden) roots, then let
        # explicitly overlaid keys win again — the reference's config_local
        # can override ANY key, including derived paths (config.py:487-538)
        _derive_paths(cf)
        for key, value in overlay.items():
            cf[key] = value
    except ImportError:
        pass


def _apply_debug_overrides(cf: Dict[str, Any]) -> None:
    """Debug-mode value overrides for fast iterations (reference
    config.py:555-560)."""
    if cf.get("debug"):
        cf["class_min_images"] = 100
        cf["class_max_images"] = 100
        cf["epochs_total"] = 3


_cf: Dict[str, Any] = _build_defaults()
_apply_local_overlay(_cf)
_apply_debug_overrides(_cf)
_derive_values(_cf)
_cf_default = copy.deepcopy(_cf)


# ---------------------------------------------------------------------------
# Public interface (reference config.py:603-625)
# ---------------------------------------------------------------------------


def get(param_name: str) -> Any:
    return _cf[param_name]


def has(param_name: str) -> bool:
    return param_name in _cf


def set(param_name: str, param_value: Any) -> None:  # noqa: A001 - parity API
    _cf[param_name] = param_value
    # derived-value hooks (reference config.py:610-620)
    if param_name == "debug":
        _apply_debug_overrides(_cf)
    elif param_name == "learning_rate_init":
        _cf["learning_rate_min"] = 0.1 * param_value
    elif param_name == "timeout_minutes":
        _cf["timeout_seconds"] = param_value * 60
    elif param_name in ("project_extension_root", "project_extension_root_fast"):
        _derive_paths(_cf)


def reset() -> None:
    """Reset configuration to defaults (keeps a fresh session key)."""
    global _cf
    _cf = copy.deepcopy(_cf_default)
    _cf["session_key"] = _new_session_key()


def snapshot() -> Dict[str, Any]:
    """A deep copy of the full config (persisted inside dataset caches,
    mirroring reference data/cache.py:273-274)."""
    return copy.deepcopy(_cf)


def restore(snap: Dict[str, Any]) -> None:
    global _cf
    _cf = copy.deepcopy(snap)


@contextlib.contextmanager
def overrides(**kwargs: Any) -> Iterator[None]:
    """Scoped config overrides: ``with cf.overrides(img_width=24): ...``."""
    saved = {k: copy.deepcopy(_cf[k]) for k in kwargs if k in _cf}
    missing = [k for k in kwargs if k not in _cf]
    try:
        for k, v in kwargs.items():
            set(k, v)
        yield
    finally:
        for k in missing:
            _cf.pop(k, None)
        for k, v in saved.items():
            set(k, v)


def ensure_dir(key_or_path: str) -> str:
    """Lazily create (and return) a configured directory."""
    path = _cf[key_or_path] if key_or_path in _cf else key_or_path
    os.makedirs(path, exist_ok=True)
    return path
