"""Multi-process runs of the port (``parallel/multihost.py``): the
single-process rehearsal against the JAX package's ``multihost.rehearsal``
(from the JAX rehearsal's initial weights, through the bridge, and with its
augmentation draws), two ranks over gloo on the CPU against the
single-process port rehearsal, the process-group helpers at world size 1,
and the multi-process training workflow (``slow``, as the JAX one).

The workers (``tools/multihost_torch_worker.py``) import no JAX: they read
the initial weights from a stage checkpoint this file writes, and run one
thread each."""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu.models import cnn as jcnn
from rapidobjectdetectionusingcascadedcnns_tpu.ops import augment as jaug
from rapidobjectdetectionusingcascadedcnns_tpu.parallel import multihost as jmultihost
from rapidobjectdetectionusingcascadedcnns_tpu.train import checkpoint as jckpt
from rapidobjectdetectionusingcascadedcnns_tpu.train import optimizer as jopt
from rapidobjectdetectionusingcascadedcnns_tpu.train import train_step as jstep
from rapidobjectdetectionusingcascadedcnns_torch.data import prefetch as tprefetch
from rapidobjectdetectionusingcascadedcnns_torch.models import bridge
from rapidobjectdetectionusingcascadedcnns_torch.parallel import multihost

import torch_parity as tp
from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "multihost_torch_worker.py")
LOSS_RTOL = 2e-6  # the JAX two-process rehearsal's own tolerance


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(args, world=2):
    env = dict(os.environ, PYTHONPATH=REPO)
    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(key, None)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, WORKER, str(rank), str(world), port] + args,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in range(world)]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, (out, err[-2000:])
        lines = [line for line in out.splitlines() if line.startswith("RESULT ")]
        assert lines, (out, err[-2000:])
        results.append(json.loads(lines[-1][len("RESULT "):]))
    return results


@pytest.fixture(scope="module")
def jax_rehearsal(tmp_path_factory):
    """The JAX rehearsal's result, its initial weights (as port tensors and
    as a stage checkpoint for the workers) and its augmentation draws."""
    ref = jmultihost.rehearsal(global_batch=32, seed=0)
    stage_cfg = jcnn.StageConfig.from_config(12, bottleneck_in_size=16)
    state = jstep.init_train_state(jax.random.PRNGKey(0), stage_cfg,
                                   jopt.optimizer_from_config(iterations_total=100))
    params = jax.tree_util.tree_map(np.asarray, state.params)
    path = str(tmp_path_factory.mktemp("rehearsal") / "initial_stage")
    jckpt.save_stage(path, params, stage_cfg, np.zeros((12, 12, 3), np.float32),
                     np.ones((12, 12, 3), np.float32))
    # the step's key PRNGKey(1) splits into the augmentation key and the
    # dropout key; the augmentation key into the color and affine keys
    k_color, k_affine = jax.random.split(jax.random.split(jax.random.PRNGKey(1))[0])
    acfg = jaug.AugmentConfig.from_config()
    draws = (tp.jax_color_draws(k_color, acfg.color_fast_mode),
             tp.jax_affine_draws(k_affine, 32, acfg))
    return ref, bridge.params_from_numpy(params, "cpu"), path + ".npz", draws


def test_rehearsal_matches_jax(jax_rehearsal):
    """From the JAX rehearsal's weights and draws, the port's
    single-process rehearsal gives its loss and evaluation count."""
    ref, params, _, draws = jax_rehearsal
    got = multihost.rehearsal(global_batch=32, seed=0, initial_params=params,
                              augment_draws=draws, device="cpu")
    assert (got["process_count"], got["eval_total"], got["host_corpus_len"]) == (1, 32, 100)
    assert ref["eval_total"] == 32
    assert got["loss"] == pytest.approx(ref["loss"], rel=LOSS_RTOL)


def test_two_process_rehearsal_matches_one_process(jax_rehearsal):
    """Two ranks over gloo (one thread each) compute the same global loss
    and update as each other and as the single-process port rehearsal from
    the same weights; each rank's corpus shard is half of it; neither
    imports JAX."""
    _, params, path, _ = jax_rehearsal
    single = multihost.rehearsal(global_batch=32, seed=0, initial_params=params, device="cpu")
    a, b = _run_workers(["step", "--device", "cpu", "--params", path])
    assert {a["process_index"], b["process_index"]} == {0, 1}
    for r in (a, b):
        assert (r["process_count"], r["global_devices"], r["local_devices"]) == (2, 2, 1)
        assert r["eval_total"] == 32 and r["host_corpus_len"] == 50
        assert r["torch_modules_only"]
    assert a["loss"] == b["loss"] and a["update_sq"] == b["update_sq"]
    assert a["loss"] == pytest.approx(single["loss"], rel=LOSS_RTOL)
    # the step's update: the gradients averaged over the ranks, not summed
    assert a["update_sq"] == pytest.approx(single["update_sq"], rel=1e-4)


def test_process_group_of_one(tmp_path, monkeypatch):
    """``initialize`` stays single-process without the environment, joins a
    gloo group of one from arguments, and is idempotent; in the group the
    rehearsal, the corpus split and the batch assembly are the
    single-process ones."""
    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert multihost.initialize(device="cpu") is False
    alone = multihost.rehearsal(device="cpu")
    import torch.distributed as dist

    init = "file://" + str(tmp_path / "rendezvous")
    try:
        assert multihost.initialize(init, 1, 0, device="cpu") is True
        assert multihost.initialize(device="cpu") is True
        assert (multihost.process_index(), multihost.process_count()) == (0, 1)
        assert dist.get_backend() == "gloo"
        assert multihost.global_mesh() == (torch.device("cpu"),)
        x = multihost.host_local_batch_to_global(np.arange(6).reshape(3, 2))
        assert torch.equal(x, torch.arange(6).reshape(3, 2))
        assert tprefetch.shard_for_host(list(range(10))) == list(range(10))
        grouped = multihost.rehearsal(device="cpu")
    finally:
        dist.destroy_process_group()
    assert grouped == alone


@pytest.mark.slow
def test_two_process_training_workflow(tmp_path):
    """The workflow over two ranks: multi-epoch training on the global
    mesh, the export on rank 0, the restore on both ranks; every
    evaluation equal across the ranks and to the exporting trainer's."""
    a, b = _run_workers(["workflow", str(tmp_path / "workflow"), "--device", "cpu"])
    assert {a["process_index"], b["process_index"]} == {0, 1}
    for r in (a, b):
        assert r["process_count"] == 2 and r["epochs"] == 2 and r["iterations_total"] >= 2
        assert r["post_restore_counts"] == r["pre_eval_counts"]
        assert os.path.exists(r["checkpoint"])
    assert a["pre_eval_counts"] == b["pre_eval_counts"]
    assert a["final_loss"] == b["final_loss"] and a["checkpoint"] == b["checkpoint"]
