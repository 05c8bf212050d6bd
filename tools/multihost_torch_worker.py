"""One process of the port's multi-process rehearsals (the counterpart of
tools/multihost_worker.py).

Two processes on the CPU (gloo), from the repository root:

    python tools/multihost_torch_worker.py 0 2 <port> step --device cpu &
    python tools/multihost_torch_worker.py 1 2 <port> step --device cpu

On a host with N CUDA cards (NCCL), one process per card:

    python tools/multihost_torch_worker.py <rank> <N> <port> step --device cuda:<rank>

``step`` (default) runs one data-parallel training and evaluation step
(``parallel.multihost.rehearsal``); ``workflow <work_dir>`` runs the
multi-epoch trainer, the export on rank 0 and the restore on every rank
(``multihost.workflow_rehearsal``). ``--params STAGE.npz`` starts the step
from the weights of that stage checkpoint (the npz+json format of both
packages, read by ``models/bridge.load_stage``) instead of the port's
init. The group is joined at ``tcp://localhost:<port>``. Prints
one ``RESULT {json}`` line.
"""

import argparse
import json
import os
import sys


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("rank", type=int)
    parser.add_argument("world_size", type=int)
    parser.add_argument("port")
    parser.add_argument("mode", nargs="?", default="step", choices=("step", "workflow"))
    parser.add_argument("work_dir", nargs="?")
    parser.add_argument("--device", default=None)
    parser.add_argument("--params", default=None)
    args = parser.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    from rapidobjectdetectionusingcascadedcnns_torch.parallel import multihost

    if args.device is not None and args.device.startswith("cpu"):
        torch.set_num_threads(1)
    multihost.initialize(
        "tcp://localhost:{}".format(args.port), args.world_size, args.rank, device=args.device
    )
    try:
        if args.mode == "workflow":
            result = multihost.workflow_rehearsal(args.work_dir, epochs=2, seed=0)
        else:
            params = None
            if args.params:
                from rapidobjectdetectionusingcascadedcnns_torch.models import bridge

                params = bridge.load_stage(args.params, "cpu")[0]
            result = multihost.rehearsal(global_batch=32, seed=0, initial_params=params)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    result["torch_modules_only"] = not any(
        m.split(".")[0] in ("jax", "rapidobjectdetectionusingcascadedcnns_tpu")
        for m in sys.modules
    )
    print("RESULT " + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
