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


def _inference(app) -> None:
    from .data.file_list import FileListLoader

    infos = FileListLoader().sample_image_infos(80, 20)
    results = app.run_inference_on_images(infos, merge=cf.get("inference_merge"))
    log.log("detections: {} over {} images".format(
        sum(len(r.boxes) for r in results), len(results)))


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m rapidobjectdetectionusingcascadedcnns_torch.run",
        description="Run one of the port's applications.",
    )
    parser.add_argument("command", choices=COMMANDS)
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card; 'cpu')")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    if args.command in ("inference-cascade", "inference-single"):
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
