"""Command-line entry points of the port, one subcommand per ``run_*.py``
script of the JAX package, each doing what its script does:

    python -m rapidobjectdetectionusingcascadedcnns_torch.run COMMAND [--device cpu]

  inference-cascade         the cascade ``default_evaluation_model_cascade``
                            from ``output_graph_dir`` on 80 positive and 20
                            negative images sampled from
                            ``dataset_native_path_root``
                            (run_inference_cascade.py)
  inference-single          the same with the single net
                            ``default_evaluation_model_single``
                            (run_inference_single.py)
  inference-visual-cascade  inference-cascade with bbox overlays saved under
                            ``bbox_visualization_dir``
                            (run_inference_visual_cascade.py)
  inference-visual-single   the same with the single net
                            (run_inference_visual_single.py)
  inference-visual-opencv   the same with the Viola-Jones baseline, on the
                            host (run_inference_visual_opencv.py)
  eval-fddb                 the FDDB 10-fold benchmark (run_eval_fddb.py)
  eval-runtime              cascade vs single net, on the card and on the CPU
                            (run_eval_runtime.py); with ``--device cpu`` on
                            the CPU alone
  train-cascade             the boosted cascade trained on ``dataset_keys``
                            under ``dataset_path_root`` (or the synthetic
                            corpus for ``["synthetic"]``) and exported to
                            ``output_graph_dir`` (run_train_cascade.py)
  train-single              one net, online augmentation off
                            (run_train_single.py)
  tune-cascade              a random hyper-parameter search over cascade
                            training (run_tune_cascade.py)
  tune-single               a successive sweep over single-net training
                            (run_tune_single.py)
  loading-file-list         file discovery over ``dataset_keys``
                            (run_loading_file_list.py)
  loading-dataset           the dataset at ``img_width`` assembled from disk,
                            warming the dataset cache (run_loading_dataset.py)
  remove-broken-images      every unreadable image moved to the ignore lists
                            (run_remove_all_broken_images.py)
  sampling                  offline sampling of the native corpus into the
                            presampled tree (run_sampling.py)
  export-serving            MODEL_DIR SESSION_KEY OUT_DIR [--height 480]
                            [--width 640] [--batch N|dynamic] [--yuv]
                            [--rungs 3] [--platform cuda,cpu]: a checkpointed
                            cascade exported as a serving bundle
                            (run_export_serving.py); ``--platform`` lists the
                            device types the bundle may be loaded on
                            (default: the export device's)

Every command runs on the CUDA card unless given ``--device cpu``; without a
card it raises, the host-only commands (file lists, the dataset, sampling,
the Viola-Jones baseline) included. Settings come from the port's
configuration, which a ``rodc_local.py`` on the path overlays and
``RODC_HOME`` roots.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from . import config as cf
from .utils import log
from .utils.device import resolve_device

# the app commands and the script each stands for
COMMANDS = {
    "inference-cascade": "run_inference_cascade.py",
    "inference-single": "run_inference_single.py",
    "inference-visual-cascade": "run_inference_visual_cascade.py",
    "inference-visual-single": "run_inference_visual_single.py",
    "inference-visual-opencv": "run_inference_visual_opencv.py",
    "eval-fddb": "run_eval_fddb.py",
    "eval-runtime": "run_eval_runtime.py",
    "train-cascade": "run_train_cascade.py",
    "train-single": "run_train_single.py",
    "tune-cascade": "run_tune_cascade.py",
    "tune-single": "run_tune_single.py",
    "loading-file-list": "run_loading_file_list.py",
    "loading-dataset": "run_loading_dataset.py",
    "remove-broken-images": "run_remove_all_broken_images.py",
    "sampling": "run_sampling.py",
}
EXPORT_COMMAND = "export-serving"  # takes a checkpoint and an output directory

# the keys the tune scripts sweep (run_tune_cascade.py, run_tune_single.py)
TUNE_CASCADE_PARAM_KEYS = [
    "learning_rate_init",
    "batch_size",
    "max_beta",
    "min_beta",
    "cascade_n_nets",
    "fc1_size",
    "conv_filter_sizes",
]
TUNE_SINGLE_PARAM_KEYS = [
    "learning_rate_init",
    "batch_size",
    "dropout_rate",
    "fc1_size",
    "conv_filter_sizes",
]


def _native_images():
    """80 positive and 20 negative images of the native corpus, as the
    inference scripts sample them."""
    from .data.file_list import FileListLoader

    cf.set("dataset_path_root", cf.get("dataset_native_path_root"))
    cf.set("cache_dataset", False)
    return FileListLoader().sample_image_infos(80, 20)


def _inference(app) -> None:
    results = app.run_inference_on_images(_native_images(), merge=cf.get("inference_merge"))
    log.log("detections: {} over {} images".format(
        sum(len(r.boxes) for r in results), len(results)))


def _visualize(app) -> None:
    from .apps.visualizer import InferenceVisualizerApp

    InferenceVisualizerApp(app, _native_images())


def _report_training(final_results) -> None:
    """The train apps' ``final_results`` and the host seconds of their phase
    timers (dataset build per size, cache, stages), one JSON line each."""
    from .utils import profiling

    log.log("final_results: {}".format(json.dumps(final_results, default=float)))
    log.log("phase seconds: {}".format(json.dumps(profiling.summary())))


def _inference_app(command: str, device):
    from .apps import inference_apps

    if command.endswith("opencv"):
        return inference_apps.InferenceOCVApp()
    if command.endswith("cascade"):
        return inference_apps.InferenceCascadeApp(device=device)
    return inference_apps.InferenceApp(device=device)


def _export_serving(args, device) -> None:
    from . import serve
    from .models import bridge

    log.set_echo(True)
    model = bridge.load_cascade(args.model_dir, args.session_key, device=device)
    batch = args.batch if args.batch in (None, "dynamic") else int(args.batch)
    platforms = args.platform.split(",") if args.platform else None
    bundle = serve.export_detector(
        model, args.height, args.width, batch=batch, yuv=args.yuv, n_rungs=args.rungs,
        platforms=platforms,
    )
    serve.save_bundle(bundle, args.out_dir)
    log.log("exported serving bundle to {} ({} rungs, capacities {}, batch {}, platforms "
            "{})".format(args.out_dir, len(bundle.meta["capacity_rungs"]),
                         bundle.meta["capacity_rungs"][0], bundle.meta["batch"],
                         bundle.meta["platforms"]))


def main(argv: Optional[Sequence[str]] = None) -> None:
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card; 'cpu')")
    parser = argparse.ArgumentParser(
        prog="python -m rapidobjectdetectionusingcascadedcnns_torch.run",
        description="Run one of the port's applications.",
    )
    commands = parser.add_subparsers(dest="command", required=True, metavar="COMMAND")
    for name, script in COMMANDS.items():
        commands.add_parser(name, parents=[common], help="as " + script)
    export = commands.add_parser(EXPORT_COMMAND, parents=[common],
                                 help="as run_export_serving.py: export a checkpointed "
                                      "cascade as a serving bundle")
    export.add_argument("model_dir")
    export.add_argument("session_key")
    export.add_argument("out_dir")
    export.add_argument("--height", type=int, default=480)
    export.add_argument("--width", type=int, default=640)
    export.add_argument("--batch", default=None,
                        help="frames per program call (int), or 'dynamic'")
    export.add_argument("--yuv", action="store_true", help="export the YUV420 program")
    export.add_argument("--rungs", type=int, default=3, help="capacity rungs to ship")
    export.add_argument("--platform", default=None,
                        help="device types the bundle may run on, comma-separated "
                             "(e.g. cuda,cpu); default: the export device's")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    if args.command == EXPORT_COMMAND:
        _export_serving(args, device)
    elif args.command in ("inference-cascade", "inference-single"):
        _inference(_inference_app(args.command, device))
    elif args.command.startswith("inference-visual-"):
        _visualize(_inference_app(args.command, device))
    elif args.command == "eval-fddb":
        from .apps.evaluate_fddb import EvaluateFDDBApp

        EvaluateFDDBApp(device=device)
    elif args.command == "eval-runtime":
        from .apps.evaluate_runtime import EvaluateRuntimeApp

        if device.type == "cpu":
            EvaluateRuntimeApp(None, None, 80, 20, device=device)
        else:
            EvaluateRuntimeApp(None, None, 80, 20, compare_platforms=[str(device), "cpu"])
    elif args.command in ("train-cascade", "train-single"):
        from .apps.train_apps import TrainApp, TrainCascadeApp

        if args.command == "train-single":
            cf.set("data_augmentation_online", False)
            app = TrainApp(device=device)
        else:
            app = TrainCascadeApp(device=device)
        _report_training(app.final_results)
    elif args.command in ("tune-cascade", "tune-single"):
        from .apps.tune_apps import TuneCascadeApp, TuneSingleApp

        if args.command == "tune-cascade":
            app = TuneCascadeApp(TUNE_CASCADE_PARAM_KEYS, random=True, device=device)
        else:
            app = TuneSingleApp(TUNE_SINGLE_PARAM_KEYS, device=device)
        log.log("tuning: {} sessions, {} failed, global best {} = {}".format(
            app.n_sessions, app.n_failed, cf.get("tuning_main_criteria"), app.best_score))
    elif args.command == "loading-dataset":
        from .data.loader import DiskDatasetProvider

        ds = DiskDatasetProvider().dataset(cf.get("img_width"))
        log.log("dataset {}: {} samples".format(ds.name, ds.n_samples))
    elif args.command == "remove-broken-images":
        from .data.file_list import FileListLoader

        broken = FileListLoader().remove_broken_images()
        log.log("{} broken images moved to ignore lists".format(len(broken)))
    elif args.command == "sampling":
        from .apps.offline_sampling import run_sampling

        run_sampling()
    else:
        from .data.file_list import FileListLoader

        infos = FileListLoader().image_infos
        log.log("discovered {} files".format(len(infos)))

if __name__ == "__main__":
    main()
