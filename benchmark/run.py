"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. Prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks`` (each number of the
check beside its limit, None where it is not compared; also the last
lines of standard error). Exits non-zero,
printing no result, where there is no card or too few, where the port is
missing, or where JAX or the JAX package got loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("PYTORCH_KERNEL_CACHE_PATH", "kernels")):
    os.environ[_var] = os.path.join(_ROOT, ".bench_cache", _sub)
os.environ["USE_FLAX"] = "0"
# one process with one CPU thread: the detector's host work contends with
# an intra-op pool of a thread a core, on cores the machine shares
os.environ["OMP_NUM_THREADS"] = "1"


def main(argv=None) -> int:
    from benchmark.harness import cell  # noqa: E402  (after the caches are set)

    started = cell.process_start()
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    spec = cell.Spec(args.workload)
    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("needs {} CUDA card(s); torch.cuda.is_available() {}, device_count() {}".format(
            chips, torch.cuda.is_available(),
            torch.cuda.device_count() if torch.cuda.is_available() else 0), file=sys.stderr)
        return 3
    out = cell.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                   started=started)
    loaded = cell.forbidden_modules()
    if loaded:
        print("JAX or the JAX package was loaded: {}".format(", ".join(loaded)),
              file=sys.stderr)
        return 4
    lines = out.pop("_lines")
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, _ROOT)
    sys.exit(main())
