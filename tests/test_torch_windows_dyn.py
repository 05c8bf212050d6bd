"""Port vs JAX: the row-bounded re-extraction of survivor boxes (kernel K4's
plain version and the bookkeeping around it).

K4 itself (csrc/rowbound.cu) runs only on a CUDA card (tests/test_torch_cuda.py).
On the CPU ``extract_rowbound`` runs K4's and K1's plain versions, held
here against the jitted JAX ``extract_rowbound`` in interpret mode on the
cases of tests/test_windows_dyn.py: windows within |diff| <= 1 on at most
1e-3 of the values (separately compiled programs), ``n_big`` and
``overflow`` exactly equal. The raw row-bounded output, before the merge,
is held against the Pallas kernel's own output on every sorted slot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu.ops import pyramid as jpyramid
from rapidobjectdetectionusingcascadedcnns_tpu.ops import windows_dyn as jdyn
from rapidobjectdetectionusingcascadedcnns_torch.ops import windows_dyn as tdyn
from rapidobjectdetectionusingcascadedcnns_torch.ops import windows_dyn_cuda

from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)


def _survivor_boxes(n, seed):
    rng = np.random.RandomState(seed)
    plan = jpyramid.build_plan(480, 640, 12, 12, 0.075, 1.1)
    table = jpyramid.window_table(plan)
    sel = rng.choice(plan.n_windows, size=n, replace=False)
    return table["coords_norm"][sel].astype(np.float32)


def _tall_boxes():
    rng = np.random.RandomState(4)
    n = 64
    y0 = rng.uniform(0, 100, n)
    hgt = rng.uniform(200, 400, n)
    x0 = rng.uniform(0, 300, n)
    return np.stack([x0, y0, np.minimum(x0 + hgt, 640), np.minimum(y0 + hgt, 480)], 1)


def _overflow_boxes():
    rng = np.random.RandomState(5)
    y0 = rng.uniform(0, 50, 64)
    return np.stack([y0 * 0 + 10, y0, y0 * 0 + 400, np.minimum(y0 + 300, 480)], 1)


def _replica_boxes():
    rng = np.random.RandomState(6)
    n, n_tall = 65, 10  # tile 16 -> 15 replicas of a big last sorted window
    y0 = rng.uniform(0, 100, n)
    hgt = np.concatenate([rng.uniform(30, 60, n - n_tall), rng.uniform(300, 400, n_tall)])
    x0 = rng.uniform(0, 200, n)
    return np.stack([x0, y0, np.minimum(x0 + hgt, 640), np.minimum(y0 + hgt, 480)], 1)


# (boxes, out size, big_cap): tests/test_windows_dyn.py's cases
CASES = {
    "stage1": lambda: (_survivor_boxes(512, 1), 24, jdyn.default_big_cap(512, 24, 24, 480)),
    "stage2": lambda: (_survivor_boxes(256, 3), 48, jdyn.default_big_cap(256, 48, 48, 480)),
    "tall": lambda: (_tall_boxes(), 24, jdyn.default_big_cap(64, 24, 24, 480)),
    "overflow": lambda: (_overflow_boxes(), 24, 16),
    "replicas": lambda: (_replica_boxes(), 24, 32),
}


@pytest.fixture(scope="module")
def scene640():
    return np.random.RandomState(0).randint(0, 256, (480, 640, 3)).astype(np.float32)


def _jax_rowbound(image, boxes, size, big_cap, monkeypatch):
    """Jitted JAX ``extract_rowbound`` in interpret mode; its first
    ``pallas_call`` (the row-bounded kernel, before K1's big class) is
    spied on so its raw output comes back too."""
    from jax.experimental import pallas as pl

    raw = []
    real = pl.pallas_call

    def spy(*args, **kwargs):
        call = real(*args, **kwargs)
        first = not raw
        raw.append(None)

        def run(*operands):
            out = call(*operands)
            if first:
                jax.debug.callback(lambda x: raw.__setitem__(0, np.asarray(x, np.float32)), out)
            return out

        return run

    monkeypatch.setattr(pl, "pallas_call", spy)
    fn = jax.jit(
        lambda img, bx: jdyn.extract_rowbound(img, bx, size, size, big_cap=big_cap, interpret=True)
    )
    wins, n_big, ovf = fn(jnp.asarray(image), jnp.asarray(boxes, jnp.float32))
    wins = np.asarray(wins)
    monkeypatch.undo()
    return wins, int(n_big), int(ovf), raw[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_extract_rowbound_matches_jitted_jax(scene640, case, monkeypatch):
    boxes, size, big_cap = CASES[case]()
    ref, ref_big, ref_ovf, ref_raw = _jax_rowbound(scene640, boxes, size, big_cap, monkeypatch)
    images = torch.from_numpy(scene640)[None]
    tboxes = torch.from_numpy(boxes.astype(np.float32))[None]
    before = windows_dyn_cuda.LAUNCHES
    got, n_big, ovf = tdyn.extract_rowbound(images, tboxes, size, size, big_cap=big_cap)
    assert windows_dyn_cuda.LAUNCHES == before  # CPU tensors: the plain version
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (1,) + ref.shape
    assert (int(n_big[0]), int(ovf[0])) == (ref_big, ref_ovf)
    if ref_ovf == 0:  # with an overflow the surplus windows hold other pixels
        diff = np.abs(got[0].float().numpy() - ref)
        assert diff.max() <= 1.0
        assert (diff > 0).mean() <= 1e-3, (diff > 0).sum()
    # the raw row-bounded output on every sorted slot, merged-away ones too
    raw = tdyn.small_class(images, tboxes, size, size)["raw"][0].float().numpy()
    c = raw.shape[-1]
    ref_raw = ref_raw.reshape(c, size, raw.shape[0], size).transpose(2, 1, 3, 0)
    diff = np.abs(raw - ref_raw)
    assert diff.max() <= 1.0
    assert (diff > 0).mean() <= 1e-3, (diff > 0).sum()


def test_frames_batch_like_single_calls(scene640):
    """Two frames with their own boxes in one call equal two one-frame calls."""
    boxes = np.stack([_survivor_boxes(128, 7), _survivor_boxes(128, 8)]).astype(np.float32)
    images = torch.from_numpy(np.stack([scene640, scene640[::-1].copy()]))
    cap = tdyn.default_big_cap(128, 24, 24, 480)
    got, n_big, ovf = tdyn.extract_rowbound(images, torch.from_numpy(boxes), 24, 24, big_cap=cap)
    for b in range(2):
        one, nb, ov = tdyn.extract_rowbound(
            images[b : b + 1], torch.from_numpy(boxes[b : b + 1]), 24, 24, big_cap=cap
        )
        torch.testing.assert_close(got[b], one[0], rtol=0, atol=0)
        assert (int(n_big[b]), int(ovf[b])) == (int(nb[0]), int(ov[0]))


def test_gate_and_big_cap_equal_jax():
    for img_h in (100, 255, 256, 480, 1080):
        for img_w in (120, 640):
            for size in (24, 48):
                for n in (8, 63, 64, 256, 4224, 16512):
                    assert tdyn.dyn_supported(img_h, img_w, size, size, n) == (
                        jdyn.dyn_supported(img_h, img_w, size, size, n)
                    )
                    assert tdyn.default_big_cap(n, size, size, img_h) == (
                        jdyn.default_big_cap(n, size, size, img_h)
                    )


def test_kernel_entry_refuses_cpu_tensors():
    planes = torch.zeros((1, 3, 8, 8), dtype=torch.bfloat16)
    pos = torch.zeros((1, 16, 24))
    cells = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        windows_dyn_cuda.resample_rowbound_cuda(planes, pos, pos, cells, 16, 128, 128)
