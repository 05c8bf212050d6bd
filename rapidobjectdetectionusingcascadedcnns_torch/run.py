"""Command-line entry points of the port, one subcommand per ``run_*.py``
script of the JAX package, each doing what its script does:

    python -m rapidobjectdetectionusingcascadedcnns_torch.run COMMAND [--device cpu]

  inference-cascade  the cascade ``default_evaluation_model_cascade`` from
                     ``output_graph_dir`` on 80 positive and 20 negative
                     images sampled from ``dataset_native_path_root``
                     (run_inference_cascade.py)
  inference-single   the same with the single net
                     ``default_evaluation_model_single``
                     (run_inference_single.py)
  eval-fddb          the FDDB 10-fold benchmark (run_eval_fddb.py)
  eval-runtime       cascade vs single net, on the card and on the CPU
                     (run_eval_runtime.py); with ``--device cpu`` on the
                     CPU alone
  loading-file-list  file discovery over ``dataset_keys``
                     (run_loading_file_list.py)
  export-serving     MODEL_DIR SESSION_KEY OUT_DIR [--height 480] [--width
                     640] [--batch N|dynamic] [--yuv] [--rungs 3]
                     [--platform cuda,cpu]: a checkpointed cascade exported
                     as a serving bundle (run_export_serving.py);
                     ``--platform`` lists the device types the bundle may
                     be loaded on (default: the export device's)

Every command runs on the CUDA card unless given ``--device cpu``; without a
card it raises. Settings come from the port's configuration, which a
``rodc_local.py`` on the path overlays and ``RODC_HOME`` roots.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from . import config as cf
from .utils import log
from .utils.device import resolve_device

COMMANDS = (
    "inference-cascade", "inference-single", "eval-fddb", "eval-runtime", "loading-file-list",
)
EXPORT_COMMAND = "export-serving"  # takes a checkpoint and an output directory


def _inference(app) -> None:
    from .data.file_list import FileListLoader

    infos = FileListLoader().sample_image_infos(80, 20)
    results = app.run_inference_on_images(infos, merge=cf.get("inference_merge"))
    log.log("detections: {} over {} images".format(
        sum(len(r.boxes) for r in results), len(results)))


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
    for name in COMMANDS:
        commands.add_parser(name, parents=[common])
    export = commands.add_parser(EXPORT_COMMAND, parents=[common],
                                 help="export a checkpointed cascade as a serving bundle")
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
        from .apps.inference_apps import InferenceApp, InferenceCascadeApp

        cf.set("dataset_path_root", cf.get("dataset_native_path_root"))
        cf.set("cache_dataset", False)
        app_cls = InferenceCascadeApp if args.command == "inference-cascade" else InferenceApp
        _inference(app_cls(device=device))
    elif args.command == "eval-fddb":
        from .apps.evaluate_fddb import EvaluateFDDBApp

        EvaluateFDDBApp(device=device)
    elif args.command == "eval-runtime":
        from .apps.evaluate_runtime import EvaluateRuntimeApp

        if device.type == "cpu":
            EvaluateRuntimeApp(None, None, 80, 20, device=device)
        else:
            EvaluateRuntimeApp(None, None, 80, 20, compare_platforms=[str(device), "cpu"])
    else:
        from .data.file_list import FileListLoader

        infos = FileListLoader().image_infos
        log.log("discovered {} files".format(len(infos)))


if __name__ == "__main__":
    main()
