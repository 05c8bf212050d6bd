"""Meshes of the port on the CPU (``parallel/mesh.py``): the mesh helpers,
``data/prefetch.shard_for_host``, frame-sharded detection
(``CascadeDetector(mesh=)``) over a 4-shard CPU mesh against the port on
one device and the JAX package's ``CascadeDetector(mesh=)`` on a JAX
``get_mesh(4)``, and a frame-sharded serving bundle. Weights come from the
JAX tree through the bridge."""

import jax
import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu import config as jcf
from rapidobjectdetectionusingcascadedcnns_tpu.data import prefetch as jprefetch
from rapidobjectdetectionusingcascadedcnns_tpu.models import cascade as jcascade
from rapidobjectdetectionusingcascadedcnns_tpu.parallel import mesh as jmesh
from rapidobjectdetectionusingcascadedcnns_torch import config as tcf
from rapidobjectdetectionusingcascadedcnns_torch import serve as tserve
from rapidobjectdetectionusingcascadedcnns_torch.data import prefetch as tprefetch
from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as tcascade
from rapidobjectdetectionusingcascadedcnns_torch.ops import color as tcolor
from rapidobjectdetectionusingcascadedcnns_torch.parallel import mesh as tmesh

import torch_parity as tp
from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)

CPU4 = ("cpu",) * 4
BASE_CFG = dict(window_scale_factor=1.3)


def _frames(n=5):
    """5 frames: a chunk that does not divide the 4-shard mesh."""
    return [synthetic.make_scene(48, 64, 1, seed=s, min_face=16, max_face=30).image
            for s in range(n)]


@pytest.fixture(scope="module")
def models():
    """The JAX cascade, its port copy and the JAX frame-sharded detection
    of the frames on a 4-device JAX mesh."""
    if jax.device_count() < 4:
        pytest.skip("needs 4 virtual JAX devices")
    # from the defaults: a module fixture runs before conftest's per-test
    # restore, which brings back whatever the process's first test module
    # had set when it took its snapshot
    jcf.reset()
    tcf.reset()
    tp.configure(**BASE_CFG)
    jmodel, tmodel = tp.jax_and_port_models(seed=0)
    ref = jcascade.CascadeDetector(jmodel, mesh=jmesh.get_mesh(4)).detect_batch(_frames())
    jcf.reset()
    tcf.reset()
    return tmodel, ref


# a shard's stage CNNs see other row counts than the single-device run's,
# so a matrix product may round a confidence 1 ulp apart; 2 float32 ulps,
# as the JAX window-sharded module allows (window_shard.py:29-33)
CONF_ULPS = 2 * float(np.spacing(np.float32(1.0)))


def _assert_equal(got, ref):
    """Survivors, window ids and boxes equal; confidences within 2 ulps."""
    for a, b in zip(got, ref, strict=True):
        assert a.n_survivors_per_stage == b.n_survivors_per_stage
        np.testing.assert_array_equal(a.raw_window_ids, b.raw_window_ids)
        np.testing.assert_allclose(a.raw_confidences, b.raw_confidences, rtol=0, atol=CONF_ULPS)
        np.testing.assert_array_equal(a.boxes, b.boxes)


def test_mesh_helpers():
    """Mesh construction and refusals, padding, splitting, gathering,
    replication once per distinct device, the config resolution and the
    per-process corpus split."""
    mesh = tmesh.get_mesh(3, devices=["cpu", torch.device("cpu"), "cpu", "cpu"])
    assert mesh == (torch.device("cpu"),) * 3 and mesh.size == 3
    assert mesh.axis_names == (tmesh.DATA_AXIS,) == ("data",)
    assert mesh.distinct == (torch.device("cpu"),)
    assert tmesh.as_mesh(CPU4) == tmesh.Mesh(CPU4) and tmesh.local_device_count(mesh) == 3
    for bad, error in ((object(), TypeError), (3, TypeError), (("meta",), ValueError),
                       ((), ValueError)):
        with pytest.raises(error):
            tmesh.as_mesh(bad)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tmesh.get_mesh()  # the default is the CUDA cards, never the CPU
        with pytest.raises(RuntimeError):
            tmesh.as_mesh(("cpu", "cuda:0"))
    x = np.arange(10).reshape(5, 2)
    padded, n = tmesh.pad_to_multiple(x, 4)
    ref, ref_n = jmesh.pad_to_multiple(x, 4)
    np.testing.assert_array_equal(padded, ref)
    assert n == ref_n == 5
    t_padded, _ = tmesh.pad_to_multiple(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(t_padded.numpy(), ref)
    chunks = tmesh.shard_batch(tmesh.Mesh(CPU4), torch.from_numpy(padded))
    assert [c.shape[0] for c in chunks] == [2] * 4
    assert torch.equal(tmesh.gather(tmesh.Mesh(CPU4), chunks), torch.from_numpy(padded))
    with pytest.raises(ValueError):
        tmesh.shard_batch(tmesh.Mesh(CPU4), x)
    w = torch.ones(3, requires_grad=True)
    copies = tmesh.replicate(tmesh.Mesh(CPU4), {"fc": [w]})
    assert all(c["fc"][0] is copies[0]["fc"][0] for c in copies)
    for want, size in ((None, None), (1, None), (4, 4)):
        tcf.set("train_mesh_devices", want)
        got = tmesh.mesh_from_config("cpu")
        assert (got and got.size) == size
    tcf.set("train_mesh_devices", "all")
    with pytest.raises(ValueError):
        tmesh.mesh_from_config("cpu")
    corpus = list(range(100))
    assert tprefetch.shard_for_host(corpus) == corpus  # no process group: rank 0 of 1
    for rank in range(3):
        assert tprefetch.shard_for_host(corpus, rank, 3) == jprefetch.shard_for_host(
            corpus, rank, 3)


def test_frame_sharded_matches_one_device_and_jax(models):
    """Five frames over four shards (padded with the last frame): the
    single-device results, and the JAX mesh detector's survivors, window ids
    and boxes."""
    tmodel, ref = models
    tp.configure(**BASE_CFG)
    det = tcascade.CascadeDetector(tmodel, mesh=CPU4)
    assert det.mesh == tmesh.Mesh(CPU4) and det.device == torch.device("cpu")
    got = det.detect_batch(_frames())
    _assert_equal(got, tcascade.CascadeDetector(tmodel).detect_batch(_frames()))
    for a, b in zip(got, ref, strict=True):
        np.testing.assert_array_equal(a.raw_window_ids, b.raw_window_ids)
        np.testing.assert_array_equal(a.boxes, b.boxes)
        tp.assert_results_close(a, b)


@pytest.mark.parametrize("case", [
    dict(window_extraction_mode="crop", window_scale_factor=2.0,
         foreground_confidence_threshold=0.3, cascade_capacity_schedule=[128, 128]),
    dict(nms_on_device=True, cascade_saturation_redispatch=False,
         foreground_confidence_threshold=0.0, cascade_capacity_schedule=[128, 128]),
], ids=["crop-mode yuv with re-dispatch", "device nms truncated"])
def test_frame_sharded_paths(models, case):
    """Three YUV420 frames over four shards, in crop mode (128x256 frames:
    K2's plain version per shard, each shard on the full plan's schedule) with saturation
    re-dispatch walking the capacities, and the device NMS tail with
    re-dispatch off: equal to the single-device detector, re-dispatches
    included."""
    tmodel, _ = models
    tp.configure(**{**BASE_CFG, **case})
    size = (128, 256) if case.get("window_extraction_mode") == "crop" else (48, 64)
    frames = [tcolor.rgb_to_yuv420(synthetic.make_scene(*size, 1, seed=s, min_face=16,
                                                        max_face=40).image) for s in range(3)]
    if size == (128, 256):
        plan = tcascade.CascadeDetector(tmodel)._plan_and_table(*size)[0]
        assert tcascade._stage0_schedule(plan, 12, "pallas2", False) is not None
    single = tcascade.CascadeDetector(tmodel)
    sharded = tcascade.CascadeDetector(tmodel, mesh=CPU4)
    ref = single.detect_batch_yuv420(frames)
    _assert_equal(sharded.detect_batch_yuv420(frames), ref)
    assert sharded.redispatches == single.redispatches
    if case.get("cascade_saturation_redispatch", True):
        assert single.redispatches > 0


def test_frame_sharded_bundle(models, tmp_path):
    """A bundle exported for a 2-shard mesh (batch 4: programs of 2 frames)
    serves 5 frames over the mesh as the live mesh detector does; it loads
    only with a mesh of its size, and a dynamic or indivisible batch is
    refused at export."""
    tmodel, _ = models
    tp.configure(**BASE_CFG)
    mesh = tmesh.get_mesh(devices=("cpu", "cpu"))
    bundle = tserve.export_detector(tmodel, 48, 64, batch=4, capacities=[512, 512], n_rungs=1,
                                    mesh=mesh)
    assert (bundle.meta["batch"], bundle.meta["max_batch"], bundle.meta["nr_devices"],
            bundle.meta["mesh_axis"]) == (4, 2, 2, "data")
    tserve.save_bundle(bundle, str(tmp_path))
    served = tserve.load_bundle(str(tmp_path), mesh=mesh).detect_batch(_frames())
    live = tcascade.CascadeDetector(tmodel, capacity_schedule=[512, 512], mesh=mesh)
    _assert_equal(served, live.detect_batch(_frames()))
    with pytest.raises(ValueError, match="2-device mesh"):
        tserve.load_bundle(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="the mesh has 4"):
        tserve.load_bundle(str(tmp_path), mesh=CPU4)
    with pytest.raises(ValueError, match="static batch"):
        tserve.export_detector(tmodel, 48, 64, batch="dynamic", mesh=mesh)
    with pytest.raises(ValueError, match="not divisible"):
        tserve.export_detector(tmodel, 48, 64, batch=3, mesh=mesh)
